"""TGA texture decoding, as PIL 12.1.0's `TgaImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

Image types 1 (colour-mapped), 2 (true colour), 3 (grey) and their RLE
forms 9, 10 and 11; PIL's `MODES` table picks the raw mode from the type
and depth (8-bit colour-mapped, 1-, 8- and 16-bit grey, 16-bit BGRA with
its top bit as inverted alpha, 24- and 32-bit), and any other pair has no
decoder (white, as PIL's load raises). Colour maps of 16-, 24- and 32-bit
entries, offset by the first entry's index; a 15-bit map is PIL's refusal.
The id field is skipped. The orientation bits: 0x20 top-down, 0x10 a
horizontal flip. RLE packets are expanded as PIL's `TgaRleDecode` does
(`csrc/raster_decoder.cpp`): a literal packet runs on into the next row, a
repeated one that passes its row's end is an overrun (white).
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import check_pixels, opening
from .raster import DecodeError, Stream

MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def _i16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("TGA"):
        fp = Stream(data)
        s = fp.read(18)
        id_len, colormaptype, imagetype = s[0], s[1], s[2]
        depth, flags = s[16], s[17]
        w, h = _i16(s, 12), _i16(s, 14)
        if colormaptype not in (0, 1) or w <= 0 or h <= 0 or \
                depth not in (1, 8, 16, 24, 32):
            raise SyntaxError("not a TGA file")
        if imagetype in (3, 11):
            mode = {1: "1", 16: "LA"}.get(depth, "L")
        elif imagetype in (1, 9):
            mode = "P" if colormaptype else "L"
        elif imagetype in (2, 10):
            mode = "RGB" if depth == 24 else "RGBA"
        else:
            raise SyntaxError("unknown TGA mode")
        orientation = flags & 0x30
        flip = orientation in (0x10, 0x30)
        ystep = 1 if orientation in (0x20, 0x30) else -1
        if id_len:
            fp.read(id_len)
        pal = None
        if colormaptype:
            start, size, mapdepth = _i16(s, 3), _i16(s, 5), s[7]
            if mapdepth == 16:
                pal = ("BGRA;15Z", bytes(2 * start) + fp.read(2 * size))
            elif mapdepth == 24:
                pal = ("BGR", bytes(3 * start) + fp.read(3 * size))
            elif mapdepth == 32:
                pal = ("BGRA", bytes(4 * start) + fp.read(4 * size))
            else:
                raise SyntaxError("unknown TGA map depth")
        rawmode = MODES.get((imagetype & 7, depth))
        offset = fp.tell()
    check_pixels(w, h)
    if rawmode is None:
        raise DecodeError("cannot load this image")
    if imagetype & 8:
        px = _rle(data, offset, mode, rawmode, depth, w, h, ystep)
    else:
        px = raster.raw_decode(data, offset, mode, rawmode, w, h, 0, ystep)
    if flip:
        px = px[:, ::-1]
    palette = None
    if pal is not None:
        # `Image.load` puts the map on the image whatever its mode: "L" and
        # "P" become "P", "LA" "PA", any other mode refuses it (and PIL has
        # no unpacker for a 32-bit map)
        palette = raster.palette(*pal)
        if mode not in ("L", "P", "LA"):
            raise DecodeError(f"unrecognized image mode {mode}")
        mode = "PA" if mode == "LA" else "P"
    elif mode == "P":
        raise DecodeError("no palette")
    return raster.to_rgba(mode, px, palette)


def _rle(data, offset, mode, rawmode, depth, w, h, ystep):
    """The `tga_rle` tile: rows expanded natively, then unpacked."""
    row_bytes = (w * raster.raw_bits(mode, rawmode) + 7) // 8
    rows = np.zeros((h, row_bytes), np.uint8)
    st = raster.library().kt_tga_rle(data, len(data), offset, depth // 8,
                                     row_bytes, h, rows.ctypes.data)
    raster.check_status(st, "TGA RLE")
    px = raster.unpack(rows, rawmode, mode, w)
    return px[::-1] if ystep < 0 else px


def encode_tga_rle(img: np.ndarray):
    """(H, W, 3 or 4) uint8 -> (a 32-bit RLE TGA, bottom-up, the RGBA it
    decodes to). Every packet is a run of one colour within its row (a run
    may not pass a row's end in PIL's reader), at most 128 pixels long."""
    h, w = img.shape[:2]
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :img.shape[2]] = img
    rows = rgba[::-1].reshape(h * w, 4)           # bottom-up
    x = np.arange(h * w) % w
    start = np.ones(h * w, bool)
    start[1:] = (rows[1:] != rows[:-1]).any(-1) | (x[1:] == 0)
    first = np.flatnonzero(start)
    length = np.diff(np.append(first, h * w))
    # runs longer than 128 pixels split into packets of 128 and the rest
    n_packets = (length + 127) // 128
    run = np.repeat(np.arange(first.size), n_packets)
    k = np.arange(run.size) - np.repeat(np.cumsum(n_packets) - n_packets,
                                        n_packets)
    plen = np.minimum(length[run] - 128 * k, 128)
    packets = np.empty((run.size, 5), np.uint8)
    packets[:, 0] = 0x80 | (plen - 1)
    packets[:, 1:] = rows[first[run]][:, [2, 1, 0, 3]]    # BGRA
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 32,
                         8)
    return header + packets.tobytes(), rgba
