"""XV thumbnail texture decoding, as PIL 12.1.0's `XVThumbImagePlugin`
reads it (`Image.open(f).convert("RGBA")`, byte for byte).

After the `P7 332` magic the rest of its line is skipped, then every line
that starts with `#`; the next line's first two fields are the width and
height (fewer fields, or fields `int` cannot read, are PIL's ValueError:
white; the end of the file first is a refusal). Raw palette indices
follow, on PIL's fixed RGB 3-3-2 palette.
"""
from __future__ import annotations

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError

# PIL's PALETTE: red and green in 8 steps, blue in 4
_R, _G, _B = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                         indexing="ij")
PALETTE = np.stack([_R * 255 // 7, _G * 255 // 7, _B * 255 // 3],
                   -1).reshape(-1, 3).astype(np.uint8)


def _readline(data: bytes, pos: int):
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes) -> np.ndarray:
    """XV thumbnail bytes -> (H, W, 4) uint8 RGBA, as PIL's
    `convert("RGBA")`."""
    data = bytes(data)
    with opening("XVTHUMB"):
        if not data.startswith(b"P7 332"):
            raise SyntaxError("not an XV thumbnail file")
        _, pos = _readline(data, 6)
        while True:
            s, pos = _readline(data, pos)
            if not s:
                raise SyntaxError("Unexpected EOF reading XV thumbnail file")
            if s[0] != 35:
                break
    fields = s.strip().split(maxsplit=2)[:2]
    try:
        w, h = fields
        w, h = int(w), int(h)
    except ValueError as e:
        raise DecodeError(f"XV thumbnail header: {e}") from e
    if w <= 0 or h <= 0:
        raise Refused("XVTHUMB: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    px = raster.raw_decode(data, pos, "P", "P", w, h)
    pal = raster.palette("RGB", PALETTE.tobytes())
    return raster.to_rgba("P", px, pal)
