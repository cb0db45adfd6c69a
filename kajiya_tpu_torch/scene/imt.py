"""IM Tools texture decoding, as PIL 12.1.0's `ImtImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

A text header of `key value` lines (a line feed within the first 100
bytes, or a refusal), read as PIL's `_open` reads it: 100 bytes, then one
more 100 at most when a line needs them; `width` and `height` set the
size (a value `int` cannot read is PIL's ValueError: white), `pixel n8`
the mode `L`; a comment line starts `*`; a form feed starts the raw `L`
rows. A line that is empty, longer than 100 bytes or no `key value` pair
ends the header without image data (PIL: "cannot load this image").
"""
from __future__ import annotations

import re

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def decode_imt(data: bytes) -> np.ndarray:
    """IMT bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("IMT"):
        buffer = fp.read(100)
        if b"\n" not in buffer:
            raise SyntaxError("not an IM file")
    mode, size, offset = "", (0, 0), None
    xsize = ysize = 0
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
        except ValueError as e:
            raise DecodeError(f"IMT header: {e}") from e
        if k == b"pixel" and v == b"n8":
            mode = "L"
    w, h = size
    if not mode or w <= 0 or h <= 0:
        raise Refused("IMT: no mode or size (ImageFile refuses it)")
    if offset is None:
        raise DecodeError("IMT: cannot load this image")
    check_pixels(w, h)
    return raster.to_rgba("L", raster.raw_decode(data, offset, "L", "L", w,
                                                 h))
