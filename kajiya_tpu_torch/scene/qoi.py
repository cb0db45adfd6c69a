"""QOI texture decoding, as PIL 12.1.0's `QoiImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

PIL's decoder is Python (`QoiDecoder`); its loop runs here in C++
(`csrc/raster_decoder.cpp`), op for op: the previous pixel starts at
(0, 0, 0, 255); every op but a run stores its pixel in the 64-entry index
at its hash, and an index op on an unset entry gives (0, 0, 0, 0); a run
adds pixels without touching the index. Ops that end with the data are
PIL's IndexError or unpacking error (white). A header whose channel count
is 3 gives RGB, any other RGBA; the colour space byte is skipped.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("QOI"):
        fp = Stream(data)
        if fp.read(4) != b"qoif":
            raise SyntaxError("not a QOI file")
        w = struct.unpack(">I", fp.read(4))[0]
        h = struct.unpack(">I", fp.read(4))[0]
        bands = 3 if fp.read(1)[0] == 3 else 4
        offset = fp.tell() + 1
    if w <= 0 or h <= 0:
        raise Refused("QOI: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    if w * h > 62 * (len(data) - offset):
        # no op gives more than 62 pixels: PIL's reads end first
        raise DecodeError("QOI: image file is truncated")
    out = np.empty((w * h + 62) * bands, np.uint8)
    st = raster.library().kt_qoi(data, len(data), offset, w * h, bands,
                                 out.ctypes.data)
    raster.check_status(st, "QOI")
    px = out[:w * h * bands].reshape(h, w, bands)
    return raster.to_rgba("RGB" if bands == 3 else "RGBA", px)


def encode_qoi(img: np.ndarray):
    """(H, W, 3 or 4) uint8 -> (a QOI file, the RGBA it decodes to)."""
    h, w, c = img.shape
    px = np.ascontiguousarray(img)
    out = np.empty(5 * w * h + 1, np.uint8)
    n = raster.library().kt_qoi_encode(px.ctypes.data, w * h, c,
                                       out.ctypes.data)
    header = b"qoif" + struct.pack(">IIBB", w, h, c, 0)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :c] = img
    return header + out[:n].tobytes() + b"\0" * 7 + b"\1", rgba
