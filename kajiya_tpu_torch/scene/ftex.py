"""FTEX texture decoding, as PIL 12.1.0's `FtexImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

The header gives the size, the mip and format counts and, for the one
format PIL reads, its format and the offset of its first mip, whose
length-prefixed data PIL reads whole (a negative length reads to the end).
Format 0 is DXT1 through PIL's `bcn` decoder (`dds.decode_bcn`, the same
blocks as a DDS file's), format 1 raw RGB. A format count other than 1 is
PIL's failed `assert`, an unknown format its ValueError, a negative offset
its failed seek: each turns the JAX bake's texture white.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .dds import decode_bcn
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream


def decode_ftex(data: bytes) -> np.ndarray:
    """FTEX bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("FTEX"):
        fp = Stream(data)
        if fp.read(4) != b"FTEX":
            raise SyntaxError("not an FTEX file")
        struct.unpack("<i", fp.read(4))                     # version
        w, h = struct.unpack("<2i", fp.read(8))
        _mips, format_count = struct.unpack("<2i", fp.read(8))
        if format_count != 1:
            raise DecodeError("FTEX: assert format_count == 1 fails")
        fmt, where = struct.unpack("<2i", fp.read(8))
        if where < 0:
            raise DecodeError(f"FTEX: negative seek value {where}")
        fp.seek(where)
        (size,) = struct.unpack("<i", fp.read(4))
        payload = fp.read(size)
        if fmt not in (0, 1):
            raise DecodeError(f"Invalid texture compression format: {fmt}")
    if w <= 0 or h <= 0:
        raise Refused("FTEX: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    if fmt == 0:
        if len(payload) < (w + 3) // 4 * ((h + 3) // 4) * 8:
            raise DecodeError("FTEX: image file is truncated")
        return decode_bcn(payload, 1, w, h)
    px = raster.raw_decode(payload, 0, "RGB", "RGB", w, h)
    return raster.to_rgba("RGB", px)

