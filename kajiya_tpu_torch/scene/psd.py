"""PSD texture decoding, as PIL 12.1.0's `PsdImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte): the merged image.

`_open` reads the header, the colour mode data (a palette when the image
is indexed and the data is 768 bytes, planar R, G, B), walks the image
resources, skips the layer and mask section by its length (PIL parses the
layers only when asked for them, which `convert` never does) and reads the
composite's tiles (`_maketile`): one raw plane per channel, or PackBits
with a table of per-row byte counts. PIL's `MODES` table takes bitmap,
grey, duotone and multichannel (as L), indexed, RGB (with exactly four
channels RGBA), CMYK (read inverted) and LAB at 8 bits (1-bit bitmap); a
pair outside it is PIL's KeyError, a refusal, so the next plugin that
accepts the bytes is tried; too few channels is PIL's OSError (white).
PIL's PackBits (`PackDecode.c`, in `csrc/raster_decoder.cpp`) ignores the
byte counts and decodes each channel from its offset to the end of the
file, cutting a run or literal at its row's end. LAB's planes are copied
into PIL's LAB storage as they are (a and b offset by 128, the pad byte 0,
so the RGBA's alpha is 0) and converted as LittleCMS does (`lab.py`).
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", b, o)[0]


def _maketile(fp: Stream, mode: str, w: int, h: int, channels: int):
    """PIL's `_maketile`: (compression, [(offset, band)]) of the
    composite."""
    compression = _i16(fp.read(2))
    offset = fp.tell()
    tiles = []
    if compression == 0:
        for channel in range(channels):
            tiles.append((offset, mode[channel]))
            offset += w * h
    elif compression == 1:
        counts = fp.read(channels * h * 2)
        offset = fp.tell()
        i = 0
        for channel in range(channels):
            tiles.append((offset, mode[channel]))
            for _ in range(h):
                offset += _i16(counts, i)
                i += 2
    fp.seek(offset)
    return compression, tiles


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("PSD"):
        fp = Stream(data)
        s = fp.read(26)
        if not s.startswith(b"8BPS") or _i16(s, 4) != 1:
            raise SyntaxError("not a PSD file")
        bits, psd_channels, psd_mode = _i16(s, 22), _i16(s, 12), _i16(s, 24)
        mode, channels = MODES[(psd_mode, bits)]
        if channels > psd_channels:
            raise DecodeError("not enough channels")
        if mode == "RGB" and psd_channels == 4:
            mode, channels = "RGBA", 4
        w, h = _i32(s, 18), _i32(s, 14)
        pal = None
        size = _i32(fp.read(4))
        if size:
            colours = fp.read(size)
            if mode == "P" and size == 768:
                pal = colours
        size = _i32(fp.read(4))
        if size:                          # image resources
            end = fp.tell() + size
            while fp.tell() < end:
                fp.read(4)
                _i16(fp.read(2))
                name = fp.read(fp.read(1)[0])
                if not len(name) & 1:
                    fp.read(1)
                res = fp.read(_i32(fp.read(4)))
                if len(res) & 1:
                    fp.read(1)
        size = _i32(fp.read(4))
        if size:                          # layer and mask information
            end = fp.tell() + size
            _i32(fp.read(4))
            fp.seek(end)
        compression, tiles = _maketile(fp, mode, w, h, channels)
    if w <= 0 or h <= 0:
        raise Refused("PSD: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    if compression not in (0, 1):
        raise DecodeError("cannot load this image")
    nbytes = (w + 7) // 8 if mode == "1" else w
    if h * nbytes > 128 * len(data):
        # no PackBits byte gives more than 128, no raw byte more than 1
        raise DecodeError("PSD: image file is truncated")
    px = raster.new(mode, w, h)
    for offset, band in sorted(tiles, key=lambda t: t[0]):
        if compression == 0:
            if offset < 0 or len(data) - offset < (h - 1) * nbytes + nbytes:
                raise DecodeError("image file is truncated")
            rows = np.frombuffer(data, np.uint8, h * nbytes, offset).reshape(
                h, nbytes)
        else:
            rows = np.zeros((h, nbytes), np.uint8)
            st = raster.library().kt_packbits_rows(
                data, len(data), offset, nbytes, h, rows.ctypes.data)
            raster.check_status(st, "PSD PackBits")
        if mode == "1":
            px = raster.unpack(rows, "1", "1", w)
        elif mode in ("L", "P"):
            px = rows[:, :w].copy()
        else:
            px[..., mode.index(band)] = rows[:, :w]
    if mode == "CMYK":
        px = 255 - px                     # PIL's "C;I" ... "K;I"
    palette = None
    if mode == "P":
        palette = raster.palette("RGB", b"") if pal is None else \
            raster.planar_palette(pal)
    return raster.to_rgba(mode, px, palette)


def encode_psd(img: np.ndarray):
    """(H, W, 3 or 4) uint8 -> (an 8-bit RGB PSD of as many channels, its
    composite PackBits-compressed row by row, the RGBA it decodes to; four
    channels read back as RGBA)."""
    from .tiff import library as tiff_library

    h, w, c = img.shape
    planes = np.ascontiguousarray(np.moveaxis(img, -1, 0))
    lib = tiff_library()
    out = np.empty(c * h * (2 * w + 2), np.uint8)
    counts, n = [], 0
    for k in range(c):
        for y in range(h):
            m = lib.kt_tiff_packbits_encode(planes[k, y].tobytes(), w,
                                            out[n:].ctypes.data)
            counts.append(m)
            n += m
    header = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, 8, 3)
    body = struct.pack(">III", 0, 0, 0) + struct.pack(">H", 1)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :c] = img
    return (header + body + np.array(counts, ">u2").tobytes()
            + out[:n].tobytes()), rgba
