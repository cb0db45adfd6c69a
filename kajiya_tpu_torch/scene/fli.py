"""Autodesk FLI / FLC texture decoding, as PIL 12.1.0's `FliImagePlugin`
reads it (`Image.open(f).convert("RGBA")`, byte for byte): the first
frame.

The 128-byte header (magic 0xAF11 or 0xAF12, flags 0 or 3, the reserved
bytes zero, at least one frame), a `0xF100` prefix chunk skipped, and the
first frame's first colour chunk (`COLOR_256`, or `COLOR_64` whose values
PIL shifts up by 2 and keeps the low 8 bits of) over a grey palette. PIL
then decodes the frame at byte 128, whatever the prefix, through its C
`fli` decoder (`FliDecode.c`, in `csrc/raster_decoder.cpp`: BRUN, LC, SS2,
COPY, BLACK; colour and postage-stamp chunks skipped; any other type
raises), handed the frame's size in bytes at a time as `ImageFile.load`
reads them.
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _accept(p: bytes) -> bool:
    return len(p) >= 16 and _i16(p, 4) in (0xAF11, 0xAF12) and \
        _i16(p, 14) in (0, 3)


def _palette(fp: Stream, pal: list, shift: int) -> None:
    i = 0
    for _ in range(_i16(fp.read(2))):
        s = fp.read(2)
        i = i + s[0]
        n = s[1] or 256
        s = fp.read(n * 3)
        for k in range(0, len(s), 3):
            pal[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1


def _open(fp: Stream):
    """FliImageFile._open and seek(0): (size, palette bytes, frame size)."""
    s = fp.read(128)
    if not (_accept(s) and s[20:22] == b"\0\0" and s[42:80] == b"\0" * 38
            and s[88:] == b"\0" * 40):
        raise SyntaxError("not an FLI/FLC file")
    n_frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    pal = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _i16(s, 4) == 0xF100:
        fp.seek(128 + _i32(s))
        s = fp.read(16)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                fp.seek(fp.tell() + chunk_size - 6)
            s = fp.read(6)
            chunk_type = _i16(s, 4)
            if chunk_type in (4, 11):
                _palette(fp, pal, 2 if chunk_type == 11 else 0)
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    palette = bytes(v & 255 for rgb in pal for v in rgb)
    if n_frames <= 0:
        raise EOFError("attempt to seek outside sequence")
    fp.seek(128)
    s = fp.read(4)
    if not s:
        raise EOFError("missing frame size")
    return size, palette, _i32(s)


def decode_fli(data: bytes) -> np.ndarray:
    """FLI / FLC bytes -> (H, W, 4) uint8 RGBA (the first frame), as PIL's
    `convert("RGBA")`."""
    data = bytes(data)
    with opening("FLI"):
        (w, h), palette, framesize = _open(Stream(data))
    if w <= 0 or h <= 0:
        raise Refused("FLI: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    img = np.zeros((h, w), np.uint8)
    lib, err = raster.library(), ctypes.c_int(0)
    pos, buf = 128, b""
    while True:                 # ImageFile.load: reads of `framesize`
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise DecodeError("FLI: image file is truncated")
        buf += s
        n = lib.kt_fli(buf, len(buf), w, h, img.ctypes.data,
                       ctypes.byref(err))
        if n < 0:
            break
        buf = buf[n:]
    if err.value:
        raise DecodeError(f"FLI: decoder error {err.value}")
    return raster.to_rgba("P", img, raster.palette("RGB", palette))


def encode_flc(idx: np.ndarray, palette: np.ndarray) -> bytes:
    """(H, W) uint8 indices and a (256, 3) uint8 palette -> an FLC of one
    frame (a `COLOR_256` chunk, then BRUN lines) PIL reads as palette[idx]."""
    h, w = idx.shape
    idx = np.ascontiguousarray(idx, np.uint8)
    out = np.empty(h * (1 + w + (w + 127) // 128) + 16, np.uint8)
    n = raster.library().kt_fli_brun_encode(idx.ctypes.data, w, h,
                                            out.ctypes.data)
    brun = out[:n].tobytes()
    brun += b"\0" * (len(brun) % 2)
    colour = struct.pack("<HBB", 1, 0, 0) + np.ascontiguousarray(
        palette, np.uint8).tobytes()
    chunks = [struct.pack("<IH", 6 + len(colour), 4) + colour,
              struct.pack("<IH", 6 + len(brun), 15) + brun]
    body = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), 0xAF12, 1, w,
                     h, 8, 0, 70)
    return bytes(head) + frame
