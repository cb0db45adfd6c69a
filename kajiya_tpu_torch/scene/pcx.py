"""PCX and DCX texture decoding, as PIL 12.1.0's `PcxImagePlugin` and
`DcxImagePlugin` read them (`Image.open(f).convert("RGBA")`, byte for
byte).

PCX modes: 1-bit; 1-bit with 2 or 4 planes as a palette image (PIL's
`P;2L` / `P;4L`, the header's 16-colour EGA palette); version-5 8-bit,
grey unless the 769 bytes at the file's end are a palette marker (12) and
a palette that is not the grey ramp; version-5 24-bit as three planes
(`RGB;L`). Any other mode is PIL's OSError (white). PIL does not trust the
header's row stride: it recomputes it and evens it where the header's
differs, and moves the planes of each row together before unpacking. The
RLE rows run in `csrc/raster_decoder.cpp` (`PcxDecode.c`): a run that
passes its row's end is an overrun (white), as is data that ends first.

PIL reads the palette through `seek(-769, SEEK_END)`: on a file of fewer
than 769 bytes a real file raises (white) while an in-memory source
(a data URI) starts at its first byte, so `decode_pcx` takes `from_file`.

A DCX file is a directory of up to 1024 PCX offsets; PIL opens its first
page.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import check_pixels, opening
from .raster import DecodeError, Stream


def _accept(s: bytes) -> bool:
    return len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)


def _i16(b: bytes, o: int) -> int:
    return struct.unpack_from("<H", b, o)[0]


def decode_pcx(data: bytes, from_file: bool = False) -> np.ndarray:
    """PCX bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    return _decode(bytes(data), 0, from_file, "PCX")


def decode_dcx(data: bytes, from_file: bool = False) -> np.ndarray:
    """DCX bytes -> its first page's RGBA, as PIL gives it."""
    data = bytes(data)
    with opening("DCX"):
        fp = Stream(data)
        s = fp.read(4)
        if len(s) < 4 or struct.unpack("<I", s)[0] != 0x3ADE68B1:
            raise SyntaxError("not a DCX file")
        offsets = []
        for _ in range(1024):
            offset = struct.unpack("<I", fp.read(4))[0]
            if not offset:
                break
            offsets.append(offset)
        if not offsets:
            raise EOFError("attempt to seek outside sequence")
    return _decode(data, offsets[0], from_file, "DCX")


def _open(data: bytes, start: int, from_file: bool, fmt: str):
    """PcxImageFile._open from byte `start`: (mode, rawmode, w, h, planes,
    row bytes, data offset, palette or None)."""
    with opening(fmt):
        fp = Stream(data, start)
        s = fp.read(68)
        if not _accept(s):
            raise SyntaxError("not a PCX file")
        bbox = (_i16(s, 4), _i16(s, 6), _i16(s, 8) + 1, _i16(s, 10) + 1)
        if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
            raise SyntaxError("bad PCX image size")
        offset = fp.tell() + 60
        version, bits, planes = s[1], s[3], s[65]
        provided_stride = _i16(s, 66)
        pal = None
        if bits == 1 and planes == 1:
            mode = rawmode = "1"
        elif bits == 1 and planes in (2, 4):
            mode, rawmode = "P", f"P;{planes}L"
            pal = raster.palette("RGB", s[16:64])
        elif version == 5 and bits == 8 and planes == 1:
            mode = rawmode = "L"
            if from_file and len(data) < 769:
                raise DecodeError("PCX: seek before the file's start")
            tail = data[max(0, len(data) - 769):][:769]
            if len(tail) == 769 and tail[0] == 12:
                ramp = np.repeat(np.arange(256, dtype=np.uint8), 3)
                if not np.array_equal(np.frombuffer(tail, np.uint8, 768, 1),
                                      ramp):
                    mode = rawmode = "P"
                    pal = raster.palette("RGB", tail[1:])
        elif version == 5 and bits == 8 and planes == 3:
            mode, rawmode = "RGB", "RGB;L"
        else:
            raise DecodeError("unknown PCX mode")
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        stride = (w * bits + 7) // 8
        if provided_stride != stride:
            stride += stride % 2
    return mode, rawmode, w, h, planes, planes * stride, offset, pal


def _decode(data: bytes, start: int, from_file: bool, fmt: str):
    mode, rawmode, w, h, planes, nbytes, offset, pal = _open(
        data, start, from_file, fmt)
    check_pixels(w, h)
    if h * nbytes > 63 * (len(data) - offset):
        # no RLE byte gives more than 63: PIL's reads end first
        raise DecodeError(f"{fmt}: image file is truncated")
    rows = np.zeros((h, nbytes), np.uint8)
    bits = {"1": 1, "P;2L": 2, "P;4L": 4, "RGB;L": 24}.get(rawmode, 8)
    st = raster.library().kt_pcx_rle(data, len(data), offset, w, bits,
                                     nbytes, h, rows.ctypes.data)
    raster.check_status(st, fmt)
    if rawmode in ("P;2L", "P;4L"):
        # PIL's unpackP2L / P4L: bit planes (w + 7) // 8 bytes apart (the
        # native loop moved them so)
        s = (w + 7) // 8
        px = np.zeros((h, w), np.uint8)
        for k in range(planes):
            px |= raster.unpack(rows[:, k * s:(k + 1) * s], "1", "1", w) \
                // 255 << k
    elif rawmode == "RGB;L":
        px = np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1)
    else:
        px = raster.unpack(rows, rawmode, mode, w)
    return raster.to_rgba(mode, px, pal)


def encode_pcx_rgb(img: np.ndarray):
    """(H, W, 3) uint8 -> (a version-5 24-bit PCX of three RLE planes, the
    RGBA it decodes to). Each plane is a row of the width, which the header
    states (the format asks for an even stride; PIL reads an odd one that
    the header states as it is, and mixes the planes of a small odd width
    that it has to even)."""
    h, w = img.shape[:2]
    stride = w
    rows = np.ascontiguousarray(np.moveaxis(img, -1, 1).reshape(h, 3 * w))
    lib = raster.library()
    out = np.empty(2 * rows.size, np.uint8)
    n = 0
    for y in range(h):
        n += lib.kt_pcx_rle_encode(rows[y].ctypes.data, rows.shape[1],
                                   out[n:].ctypes.data)
    header = bytearray(128)
    struct.pack_into("<BBBBHHHHHH", header, 0, 10, 5, 1, 8, 0, 0, w - 1,
                     h - 1, 72, 72)
    header[65] = 3
    struct.pack_into("<HH", header, 66, stride, 1)
    rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return bytes(header) + out[:n].tobytes(), rgba
