"""SPIDER texture decoding, as PIL 12.1.0's `SpiderImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

A header of 27 floats, big-endian if `isSpiderHeader` accepts them so,
else little-endian (`identify._spider`): a 2D image (iform 1; any other
is a refusal) of size (h[12], h[2]) at byte h[22] (the header's length),
or, for a stack (h[24] > 0, h[27] = 0), its first image after a second
header. A single image of a stack (h[24] = 0, h[27] > 0) raises in PIL
(white), as does a stack word that `int` cannot take (an infinity or a
NaN). The pixels are float32 in the header's byte order, an "F" image
that `convert` clips and truncates to grey.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import (Refused, check_pixels, opening,
                       spider_header_length)
from .raster import DecodeError, Stream


def _int(v: float) -> int:
    """`int` of a stack word, which PIL's `isSpiderHeader` does not check:
    an infinity (OverflowError) or a NaN (ValueError) ends PIL's `open`."""
    try:
        return int(v)
    except (OverflowError, ValueError) as e:
        raise DecodeError(f"SPIDER: stack word {v!r}") from e


def decode_spider(data: bytes) -> np.ndarray:
    """SPIDER bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("SPIDER"):
        f = Stream(data).read(108)
        try:
            big = True
            t = struct.unpack(">27f", f)
            hdrlen = spider_header_length(t)
            if hdrlen == 0:
                big = False
                t = struct.unpack("<27f", f)
                hdrlen = spider_header_length(t)
            if hdrlen == 0:
                raise SyntaxError("not a valid Spider file")
        except struct.error as e:
            raise SyntaxError("not a valid Spider file") from e
        h = (99,) + t
        if int(h[5]) != 1:
            raise SyntaxError("not a Spider 2D image")
        size = int(h[12]), int(h[2])
        istack, imgnumber = _int(h[24]), _int(h[27])
        if istack == 0 and imgnumber == 0:
            offset = hdrlen
        elif istack > 0 and imgnumber == 0:
            _int(h[26])     # the stack's image count, which PIL reads
            offset = hdrlen * 2
        elif istack == 0 and imgnumber > 0:
            raise DecodeError("SPIDER: an image of a stack opened alone "
                              "(PIL has no stack offset)")
        else:
            raise SyntaxError("inconsistent stack header values")
    w, hgt = size
    if w <= 0 or hgt <= 0:
        raise Refused("SPIDER: size not positive (ImageFile refuses it)")
    check_pixels(w, hgt)
    if offset < 0:
        raise DecodeError("SPIDER: negative seek value")
    px = raster.raw_decode(data, offset, "F", "F;32BF" if big else "F;32F",
                           w, hgt)
    return raster.to_rgba("F", px)


def encode_spider(img: np.ndarray, big_endian: bool = True) -> bytes:
    """(H, W) float32 -> a SPIDER 2D image PIL reads as these values."""
    h, w = img.shape
    hdr = np.zeros(256, np.float32)     # 1024 bytes: one 1024-byte record
    hdr[0] = 1                          # h[1] nslice
    hdr[1] = h                          # h[2] nrow
    hdr[4] = 1                          # h[5] iform: a 2D image
    hdr[11] = w                         # h[12] nsam
    hdr[12] = 1                         # h[13] labrec
    hdr[21] = 1024                      # h[22] labbyt
    hdr[22] = 1024                      # h[23] lenbyt
    order = ">f4" if big_endian else "<f4"
    return hdr.astype(order).tobytes() + np.ascontiguousarray(
        img, np.float32).astype(order).tobytes()
