"""PIXAR texture decoding, as PIL 12.1.0's `PixarImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

A 512-byte header (its size at bytes 418 and 416, little-endian; a short
header is a refusal) whose channel and depth description at 424 must be
(14, 2), 8-bit RGB (any other is PIL's "no mode", a refusal), then raw
RGB rows from byte 1024.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import Stream


def decode_pixar(data: bytes) -> np.ndarray:
    """PIXAR bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("PIXAR"):
        s = fp.read(4)
        if not s.startswith(b"\200\350\000\000"):
            raise SyntaxError("not a PIXAR file")
        s += fp.read(508)
        w, h = struct.unpack_from("<H", s, 418)[0], \
            struct.unpack_from("<H", s, 416)[0]
        mode = struct.unpack_from("<HH", s, 424)
    if mode != (14, 2) or w <= 0 or h <= 0:
        raise Refused("PIXAR: no mode or size (ImageFile refuses it)")
    check_pixels(w, h)
    return raster.to_rgba("RGB", raster.raw_decode(data, 1024, "RGB", "RGB",
                                                   w, h))
