"""Sun raster texture decoding, as PIL 12.1.0's `SunImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

The 32-byte big-endian header: size, depth (1 inverted bits as `1`, 4 and
8 as `L`, 24 and 32 as `RGB` in BGR order, or RGB order for file type 3),
file type and colour map (at most 1024 bytes of type 1, R, G and B
planes; any other depth, map or type is a refusal). With a map an `L`
image becomes `P`; on a `1` or `RGB` image PIL's load puts the map on a
mode that takes none (white). Types 0, 1, 3, 4 and 5 are raw rows padded
to 16 bits; type 2 is PIL's `sun_rle` decoder (`SunRleDecode.c`, in
`csrc/raster_decoder.cpp`), whose rows are not padded and whose runs go
on into the next rows.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

_MODES = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L")}


def decode_sun(data: bytes) -> np.ndarray:
    """Sun raster bytes -> (H, W, 4) uint8 RGBA, as PIL's
    `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("SUN"):
        s = fp.read(32)
        if len(s) < 4 or struct.unpack_from(">I", s)[0] != 0x59A66A95:
            raise SyntaxError("not an SUN raster file")
        w, h, depth, _length, ftype, ptype, plen = struct.unpack_from(
            ">7I", s, 4)
        if depth in _MODES:
            mode, rawmode = _MODES[depth]
        elif depth in (24, 32):
            mode = "RGB"
            rawmode = ("RGB" if ftype == 3 else "BGR") + \
                ("X" if depth == 32 else "")
        else:
            raise SyntaxError("Unsupported Mode/Bit Depth")
        offset, pal = 32, None
        if plen:
            if plen > 1024:
                raise SyntaxError("Unsupported Color Palette Length")
            if ptype != 1:
                raise SyntaxError("Unsupported Palette Type")
            offset += plen
            pal = fp.read(plen)
            if mode == "L":
                mode, rawmode = "P", rawmode.replace("L", "P")
        if ftype not in (0, 1, 2, 3, 4, 5):
            raise SyntaxError("Unsupported Sun Raster file type")
    if w <= 0 or h <= 0:
        raise Refused("SUN: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    if pal is not None and mode != "P":
        raise DecodeError("SUN: a colour map on a mode without a palette")
    if ftype == 2:
        nbytes = (w * raster.raw_bits(mode, rawmode) + 7) // 8
        if nbytes * h > 256 * len(data):
            # no RLE op gives more than 256 bytes
            raise DecodeError("SUN RLE: image file is truncated")
        rows = np.empty((h, nbytes), np.uint8)
        st = raster.library().kt_sun_rle(data, len(data), offset, nbytes, h,
                                         rows.ctypes.data)
        raster.check_status(st, "SUN RLE")
        px = raster.unpack(rows, rawmode, mode, w)
    else:
        stride = (w * depth + 15) // 16 * 2
        px = raster.raw_decode(data, offset, mode, rawmode, w, h, stride)
    if mode == "P":
        return raster.to_rgba("P", px, raster.planar_palette(pal))
    return raster.to_rgba(mode, px)


def encode_sun_rle(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> a 24-bit RLE Sun raster (file type 2, BGR) PIL
    reads as these texels."""
    h, w, _ = img.shape
    rows = np.ascontiguousarray(img[..., ::-1]).reshape(-1)
    out = np.empty(rows.size * 2 + 16, np.uint8)
    n = raster.library().kt_sun_rle_encode(rows.ctypes.data, rows.size,
                                           out.ctypes.data)
    head = struct.pack(">8I", 0x59A66A95, w, h, 24, n, 2, 0, 0)
    return head + out[:n].tobytes()
