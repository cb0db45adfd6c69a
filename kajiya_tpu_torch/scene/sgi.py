"""SGI texture decoding, as PIL 12.1.0's `SgiImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

The 512-byte header gives the bytes per channel (1 or 2), the dimension,
the size and the channel count; PIL's `MODES` table takes L, RGB and RGBA
at 8 or 16 bits (16 bits keep their high byte). A bad magic or a mode
outside the table is PIL's ValueError, which no other plugin gets to try:
white. Rows are stored bottom-up. Uncompressed 8-bit images are one raw
plane per channel; uncompressed 16-bit ones go through PIL's
`SGI16Decoder`; RLE images through `SgiRleDecode.c`
(`csrc/raster_decoder.cpp`: the offset and length tables, chunks of up to
127 samples, a row buffer that keeps the previous row's samples where a
row leaves them unwritten, and a row without its terminator that ends the
decode with no error). Any other compression has no decoder: white.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
         (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
         (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def decode_sgi(data: bytes) -> np.ndarray:
    """SGI bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("SGI"):
        s = Stream(data).read(512)
        if len(s) < 2 or struct.unpack_from(">H", s)[0] != 474:
            raise DecodeError("Not an SGI image file")
        compression, bpc = s[2], s[3]
        dimension, xsize, ysize, zsize = struct.unpack_from(">4H", s, 4)
        rawmode = MODES.get((bpc, dimension, zsize))
        if rawmode is None:
            raise DecodeError("Unsupported SGI image mode")
    mode = rawmode.split(";")[0]
    if xsize <= 0 or ysize <= 0:
        raise Refused("SGI: size not positive (ImageFile refuses it)")
    check_pixels(xsize, ysize)
    bands = len(mode)
    if compression == 0 and bpc == 1:
        planes = [raster.raw_decode(data, 512 + k * xsize * ysize, "L", "L",
                                    xsize, ysize, 0, -1)
                  for k in range(bands)]
    elif compression == 0:
        # SGI16Decoder: each channel's page read whole, its high bytes kept
        page = 2 * xsize * ysize
        planes = []
        for k in range(bands):
            chunk = data[512 + k * page:512 + (k + 1) * page]
            if len(chunk) < page:
                raise DecodeError("not enough image data")
            planes.append(np.frombuffer(chunk, np.uint8)[0::2].reshape(
                ysize, xsize)[::-1])
    elif compression == 1:
        rows = np.zeros((ysize, xsize * bands * bpc), np.uint8)
        st = raster.library().kt_sgi_rle(data, len(data), bpc, xsize, ysize,
                                         bands, rows.ctypes.data)
        raster.check_status(st, "SGI RLE")
        px = rows.reshape(ysize, xsize, bands, bpc)[..., 0]
        planes = [px[..., k] for k in range(bands)]
    else:
        raise DecodeError("cannot load this image")
    px = planes[0] if bands == 1 else np.stack(planes, -1)
    return raster.to_rgba(mode, np.ascontiguousarray(px))


def encode_sgi_rle(img: np.ndarray):
    """(H, W, C) uint8 -> (an 8-bit RLE SGI of C = 1, 3 or 4 channels, the
    RGBA it decodes to): rows bottom-up, each channel's rows after the
    previous channel's, the tables of offsets and lengths first."""
    h, w = img.shape[:2]
    z = 1 if img.ndim == 2 else img.shape[2]
    px = np.ascontiguousarray(img.reshape(h, w, z)[::-1])
    lib = raster.library()
    out = np.empty(z * h * (2 * w + 2), np.uint8)
    starts, lengths = [], []
    table = 512 + 8 * z * h
    n = 0
    for c in range(z):
        for y in range(h):
            m = lib.kt_sgi_rle_encode(px[y, :, c:].ctypes.data, w, z,
                                      out[n:].ctypes.data)
            starts.append(table + n)
            lengths.append(m)
            n += m
    header = bytearray(512)
    struct.pack_into(">HBBHHHH", header, 0, 474, 1, 1, 2 if z == 1 else 3,
                     w, h, z)
    struct.pack_into(">II", header, 12, 0, 255)       # pixmin, pixmax
    tables = np.array(starts + lengths, ">u4").tobytes()
    if z == 1:
        rgba = np.repeat(img.reshape(h, w, 1), 4, -1)
        rgba[..., 3] = 255
    else:
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., :z] = img
    return bytes(header) + tables + out[:n].tobytes(), rgba
