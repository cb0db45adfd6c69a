"""XBM texture decoding, as PIL 12.1.0's `XbmImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

PIL matches its header expression against the first 512 bytes (the
`#define` width and height, an optional hot spot, then anything up to the
last `_bits[]` there; no match is a refusal), and its `xbm` decoder
(`XbmDecode.c`) reads the bytes that follow: it skips to each `x` and
takes the next two characters as hex digits (any other character counts
0), row after row of (width + 7) / 8 bytes, least significant bit first
(PIL's "1;R"). Data that ends before the last row is PIL's "image file is
truncated" (white).
"""
from __future__ import annotations

import re

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError

# PIL's xbm_head
_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
# XbmDecode.c's HEX: a hex digit's value, anything else 0
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789"):
    _HEX[_c] = _i
for _i, _c in enumerate(b"abcdef"):
    _HEX[_c] = _HEX[_c - 32] = 10 + _i


def decode_xbm(data: bytes) -> np.ndarray:
    """XBM bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("XBM"):
        m = _HEAD.match(data[:512])
        if not m:
            raise SyntaxError("not a XBM file")
        w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise Refused("XBM: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    need = (w + 7) // 8 * h
    body = np.frombuffer(data, np.uint8, offset=m.end())
    xs = np.flatnonzero(body == ord("x"))
    # each byte consumes its `x` and two characters; the next search starts
    # after them
    starts, last = [], -1
    for x in xs:
        if x > last:
            starts.append(x)
            last = x + 2
            if len(starts) == need:
                break
    starts = np.array(starts, np.int64)
    if len(starts) < need or starts[-1] + 2 >= len(body):
        raise DecodeError("XBM: image file is truncated")
    v = (_HEX[body[starts + 1]] << 4) + _HEX[body[starts + 2]]
    rows = v.astype(np.uint8).reshape(h, (w + 7) // 8)
    return raster.to_rgba("1", raster.unpack(rows, "1;R", "1", w))
