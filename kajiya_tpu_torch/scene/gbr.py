"""GBR (GIMP brush) texture decoding, as PIL 12.1.0's `GbrImagePlugin`
reads it (`Image.open(f).convert("RGBA")`, byte for byte).

`_open` reads the big-endian header (its size, version 1 or 2, width,
height and a colour depth of 1 or 4; version 2 also the `GIMP` magic and
the spacing), each check a refusal, then the comment to the header's end
(a version 2 header shorter than 28 bytes reads the rest of the file, as
`read` of a negative count does). The pixels follow raw: depth 1 is `L`,
depth 4 `RGBA`; fewer bytes than the image needs is PIL's "not enough
image data" (white).
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import check_pixels, opening
from .raster import DecodeError, Stream


def _i32(fp: Stream) -> int:
    return struct.unpack(">I", fp.read(4))[0]


def decode_gbr(data: bytes) -> np.ndarray:
    """GBR bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("GBR"):
        header_size = _i32(fp)
        if header_size < 20:
            raise SyntaxError("not a GIMP brush")
        version = _i32(fp)
        if version not in (1, 2):
            raise SyntaxError(f"Unsupported GIMP brush version: {version}")
        w, h, depth = _i32(fp), _i32(fp), _i32(fp)
        if w == 0 or h == 0:
            raise SyntaxError("not a GIMP brush")
        if depth not in (1, 4):
            raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
        if version == 1:
            comment_length = header_size - 20
        else:
            comment_length = header_size - 28
            if fp.read(4) != b"GIMP":
                raise SyntaxError("not a GIMP brush, bad magic number")
            _i32(fp)                      # spacing
    check_pixels(w, h)
    fp.read(comment_length)
    mode = "L" if depth == 1 else "RGBA"
    n = w * h * depth
    pixels = fp.read(n)
    if len(pixels) < n:
        raise DecodeError("GBR: not enough image data")
    return raster.to_rgba(mode, raster.raw_decode(pixels, 0, mode, mode, w,
                                                  h))
