"""ICO and CUR texture decoding, as PIL 12.1.0's `IcoImagePlugin` and
`CurImagePlugin` read them (`Image.open(f).convert("RGBA")`, byte for
byte).

CUR takes its first directory entry, replaced only by a later one that is
both wider and taller, reads that entry's bitmap (`bmp.open_bitmap`, the
header at the entry's offset, a 32-bit BI_RGB bitmap at offset 22 as
BGRA) and halves its height. A file with no entry is a refusal, so a TGA
that starts `00 00 02 00` (as PIL's TGA writer writes it) passes on to the
TGA plugin, as in `Image.open`.

ICO sorts its entries by colour depth, then by area, largest first (both
sorts stable), and opens the first: a PNG entry through `png.py`, a DIB
entry through `bmp.py` with its height halved and its alpha from the
entry's 32-bit pixels or, below 32 bits, from the AND mask. PIL loads the
image inside the plugin's `_open`, so what makes that load raise one of
the refusal errors makes the ICO plugin refuse.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import bmp, raster
from .identify import check_pixels, opening
from .png import PNG_SIGNATURE, decode_png
from .raster import DecodeError, Stream


def _i16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _i32(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("CUR"):
        fp = Stream(data)
        s = fp.read(6)
        if not s.startswith(b"\0\0\2\0"):
            raise SyntaxError("not a CUR file")
        m = b""
        for _ in range(_i16(s, 4)):
            s = fp.read(16)
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        if not m:
            raise TypeError("No cursors were found")
        bm = bmp.open_bitmap(fp, header=_i32(m, 12))
        height = bm.height // 2
        if not bm.mode or bm.width <= 0 or height <= 0:
            raise SyntaxError("not identified by this plugin")
    check_pixels(bm.width, height)
    return raster.to_rgba(*bmp.load_bitmap(data, bm, height))


def _entries(fp: Stream):
    """IcoFile.__init__: the directory, sorted as PIL sorts it."""
    s = fp.read(6)
    if not s.startswith(b"\0\0\1\0"):
        raise SyntaxError("not an ICO file")
    entries = []
    for _ in range(_i16(s, 4)):
        s = fp.read(16)
        width, height = s[0] or 256, s[1] or 256
        nb_color = s[2]
        bpp = _i16(s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) \
            or 256
        entries.append(dict(width=width, height=height, bpp=bpp,
                            size=_i32(s, 8), offset=_i32(s, 12),
                            square=width * height, depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    return entries


def _frame(data: bytes, e: dict):
    """IcoFile.frame of one entry: (mode, pixels, palette) or RGBA."""
    off = e["offset"]
    if data[off:off + 8] == PNG_SIGNATURE:
        return "RGBA", decode_png(data[off:], transparency=False), None
    bm = bmp.checked(bmp.open_bitmap(Stream(data, off)))
    check_pixels(bm.width, bm.height)
    w, h = bm.width, int(bm.height / 2)
    if h <= 0:
        # PIL cut the DIB to no rows: its decoder's `setimage` raises
        raise DecodeError("tile cannot extend outside image")
    mode, px, pal = bmp.load_bitmap(data, bm, h)
    if e["bpp"] == 32:
        o = bm.offset
        alpha = np.frombuffer(data[o:o + w * h * 4][3::4], np.uint8)
        if alpha.size < w * h:
            raise DecodeError("buffer is not large enough")
        mask = alpha.reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32) % 32
        total = int((wp * h) / 8)
        start = off + e["size"] - total
        if start < 0:
            raise DecodeError("negative seek value")
        mask = raster.raw_decode(data[start:start + total], 0, "1", "1;I",
                                 w, h, wp // 8, -1)
    rgba = raster.to_rgba(mode, px, pal)
    rgba[..., 3] = mask
    return "RGBA", rgba, None


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("ICO"):
        entries = _entries(Stream(data))
        mode, px, pal = _frame(data, entries[0])
    return raster.to_rgba(mode, px, pal)
