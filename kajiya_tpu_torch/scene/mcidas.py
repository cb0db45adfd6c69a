"""McIdas area texture decoding, as PIL 12.1.0's `McIdasImagePlugin` reads
it (`Image.open(f).convert("RGBA")`, byte for byte).

A 256-byte directory of 64 big-endian words (w[1] .. w[64]): w[11] bytes
a pixel (1 `L`, 2 `I;16B`, 4 `I` from `I;32B`; anything else a refusal),
the size (w[10], w[9]), the data at w[34] + w[15], rows w[15] + w[10] w[11]
w[14] bytes apart, read by PIL's `raw` decoder. Read from a file, PIL
memory-maps an `L` or `I;16B` area whose rows fit in it, so a stride of 0
or less gives packed rows there (the `raw` decoder of bytes in memory
refuses a negative one).
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

_MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


def decode_mcidas(data: bytes, from_file: bool = False) -> np.ndarray:
    """McIdas area bytes -> (H, W, 4) uint8 RGBA, as PIL's
    `convert("RGBA")` (`from_file`: as PIL reads a file on disk)."""
    data = bytes(data)
    with opening("MCIDAS"):
        s = Stream(data).read(256)
        if not s.startswith(b"\0\0\0\0\0\0\0\4") or len(s) != 256:
            raise SyntaxError("not an McIdas area file")
        w = [0, *struct.unpack("!64i", s)]
        if w[11] not in _MODES:
            raise SyntaxError("unsupported McIdas format")
    mode, rawmode = _MODES[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise Refused("MCIDAS: size not positive (ImageFile refuses it)")
    check_pixels(width, height)
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    if from_file and mode != "I" and offset + height * stride <= len(data):
        return raster.to_rgba(mode, _mapped(data, offset, stride, mode,
                                            width, height))
    return raster.to_rgba(mode, raster.raw_decode(
        data, offset, mode, rawmode, width, height, stride))


def _mapped(data: bytes, offset: int, stride: int, mode: str, w: int,
            h: int) -> np.ndarray:
    """`Image.core.map_buffer`: the rows read in place from the file's
    bytes (a stride <= 0 taken as packed)."""
    if offset < 0:
        raise DecodeError("MCIDAS: tile offset cannot be negative")
    nbytes = w * (1 if mode == "L" else 2)
    if stride <= 0:
        stride = nbytes
    if offset + h * stride > len(data):
        raise DecodeError("MCIDAS: buffer is not large enough")
    if offset + (h - 1) * stride + nbytes > len(data):
        raise NotImplementedError(
            "MCIDAS: PIL maps overlapping rows past the end of the file")
    buf = np.frombuffer(data, np.uint8)
    idx = offset + np.arange(h)[:, None] * stride + np.arange(nbytes)
    return raster.unpack(buf[idx], mode, mode, w)


def encode_mcidas(grey: np.ndarray) -> bytes:
    """(H, W) uint8 -> a 1-byte McIdas area PIL reads as these texels."""
    h, w = grey.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10] = h, w, 1     # w[9], w[10], w[11]
    words[13] = 1                               # w[14]: one band
    words[33] = 256                             # w[34]: the data offset
    return struct.pack("!64i", *words) + np.ascontiguousarray(
        grey, np.uint8).tobytes()
