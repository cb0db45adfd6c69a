"""BMP and DIB texture decoding, as PIL 12.1.0's `BmpImagePlugin` reads
them (`Image.open(f).convert("RGBA")`, byte for byte).

Covered as PIL covers it: header sizes 12, 40, 52, 56, 64, 108 and 124;
1-, 4- and 8-bit palettes (a palette of greys opens as "1" or "L", its
indices read as grey levels); 16, 24 and 32 bits; BI_RGB (32-bit as BGRX:
alpha 255), BI_RLE8 and BI_RLE4 (PIL's Python `BmpRleDecoder`: deltas, end
of line, end of bitmap, short data), BI_BITFIELDS with only the masks of
PIL's `MASK_MODES`; a negative height is a top-down image. Everything
else PIL refuses the same way: an unsupported header, depth, bitfield
layout or compression raises `raster.DecodeError` (white in the bake); a
header that ends early raises `identify.Refused`, so the dispatch tries
the next plugin as `Image.open` does. The RLE loop runs in
`csrc/raster_decoder.cpp`.

`open_bitmap` / `load_bitmap` are also the DIB reader of `ico.py` (ICO and
CUR entries).
"""
from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import numpy as np

from . import raster
from .identify import check_pixels, opening
from .raster import DecodeError, Stream

BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
            16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
HEADER_SIZES = (40, 52, 56, 64, 108, 124)
SUPPORTED = {
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0),
         (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
    24: [(0xFF0000, 0xFF00, 0xFF)],
    16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)]}
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15"}


def _i16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _i32(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


@dataclass
class Bitmap:
    """What `BmpImageFile._bitmap` leaves: mode, size and the one tile."""
    mode: str
    width: int
    height: int
    rawmode: str
    rle: int            # 0 raw, else RLE (4 for RLE4, 8 for RLE8)
    stride: int
    direction: int      # -1 bottom-up, 1 top-down
    offset: int         # the tile's file offset
    palette: np.ndarray | None


def open_bitmap(fp: Stream, header: int = 0, offset: int = 0) -> Bitmap:
    """`BmpImageFile._bitmap`: the info header at `header` (or where `fp`
    stands), the palette, and the tile at `offset` (or after them). Raises
    what PIL raises: struct.error / IndexError for a short field (the
    caller's `opening` turns them into a refusal), DecodeError for a
    layout PIL refuses."""
    if header:
        fp.seek(header)
    header_size = _i32(fp.read(4))
    data = raster.safe_read(fp, header_size - 4)
    direction = -1
    masks = None
    if header_size == 12:
        width, height = _i16(data, 0), _i16(data, 2)
        bits = _i16(data, 6)
        compression = RAW
        padding = 3
        colors = 0
    elif header_size in HEADER_SIZES:
        y_flip = data[7] == 0xFF
        direction = 1 if y_flip else -1
        width = _i32(data, 0)
        height = _i32(data, 4) if not y_flip else 2 ** 32 - _i32(data, 4)
        bits = _i16(data, 10)
        compression = _i32(data, 12)
        colors = _i32(data, 28)
        padding = 4
        if compression == BITFIELDS:
            if len(data) >= 48:
                names = 4 if len(data) >= 52 else 3
                masks = [_i32(data, 36 + k * 4) for k in range(names)]
                if names == 3:
                    masks.append(0)
            else:
                masks = [_i32(fp.read(4)) for _ in range(3)] + [0]
    else:
        raise DecodeError(f"Unsupported BMP header type ({header_size})")
    colors = colors if colors else (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    mode, rawmode = BIT2MODE.get(bits, ("", ""))
    if not mode:
        raise DecodeError(f"Unsupported BMP pixel depth ({bits})")
    rle = 0
    if compression == BITFIELDS:
        rgba_mask, rgb_mask = tuple(masks), tuple(masks[:3])
        if bits == 32 and rgba_mask in SUPPORTED[32]:
            rawmode = MASK_MODES[(32, rgba_mask)]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits in (24, 16) and rgb_mask in SUPPORTED[bits]:
            rawmode = MASK_MODES[(bits, rgb_mask)]
        else:
            raise DecodeError("Unsupported BMP bitfields layout")
    elif compression == RAW:
        if bits == 32 and header == 22:        # 32-bit .cur offset
            rawmode, mode = "BGRA", "RGBA"
    elif compression in (RLE8, RLE4):
        rle = 4 if compression == RLE4 else 8
    else:
        raise DecodeError(f"Unsupported BMP compression ({compression})")
    pal = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise DecodeError(f"Unsupported BMP Palette size ({colors})")
        raw_pal = fp.read(padding * colors)
        indices = (0, 255) if colors == 2 else range(colors)
        grey = all(raw_pal[i * padding:i * padding + 3]
                   == bytes([v & 255]) * 3 for i, v in enumerate(indices))
        if grey:
            mode = "1" if colors == 2 else "L"
            rawmode = mode
        else:
            pal = raster.palette("BGRX" if padding == 4 else "BGR", raw_pal)
    stride = ((width * bits + 31) >> 3) & ~3
    return Bitmap(mode, width, height, rawmode, rle, stride, direction,
                  offset or fp.tell(), pal)


def _rle(data: bytes, bm: Bitmap, width: int, height: int) -> np.ndarray:
    """BmpRleDecoder.decode, then its `set_as_raw` of the indices."""
    if bm.mode not in ("P", "L"):
        raise DecodeError(f"unknown raw mode P for {bm.mode}")
    dest = width * height
    cap = dest + 256 * (width + 1) + 1024
    out = np.zeros(cap, np.uint8)
    n = ctypes.c_longlong()
    st = raster.library().kt_bmp_rle(
        data, len(data), bm.offset, int(bm.rle == 4), width, dest,
        out.ctypes.data, cap, ctypes.byref(n))
    raster.check_status(st, "BMP RLE")
    if n.value < dest:
        raise DecodeError("not enough image data")
    px = out[:dest].reshape(height, width)
    return px[::-1].copy() if bm.direction < 0 else px


def load_bitmap(data: bytes, bm: Bitmap, height: int | None = None):
    """The tile's pixels (at `height` rows when the caller cut the image,
    as CUR and ICO do): (mode, pixels, palette)."""
    h = bm.height if height is None else height
    if bm.rle:
        px = _rle(data, bm, bm.width, h)
    else:
        px = raster.raw_decode(data, bm.offset, bm.mode, bm.rawmode,
                               bm.width, h, bm.stride, bm.direction)
    if bm.mode == "P" and bm.palette is None:
        raise DecodeError("no palette")
    return bm.mode, px, bm.palette


def checked(bm: Bitmap) -> Bitmap:
    """ImageFile.__init__'s test after `_open`: a mode and a size > 0."""
    if not bm.mode or bm.width <= 0 or bm.height <= 0:
        raise SyntaxError("not identified by this plugin")
    return bm


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("BMP"):
        fp = Stream(data)
        head = fp.read(14)
        if not head.startswith(b"BM"):
            raise SyntaxError("Not a BMP file")
        bm = checked(open_bitmap(fp, offset=_i32(head, 10)))
    check_pixels(bm.width, bm.height)
    return raster.to_rgba(*load_bitmap(data, bm))


def decode_dib(data: bytes) -> np.ndarray:
    """A headerless DIB (`BITMAPINFOHEADER` first) -> RGBA, as PIL."""
    data = bytes(data)
    with opening("DIB"):
        bm = checked(open_bitmap(Stream(data)))
    check_pixels(bm.width, bm.height)
    return raster.to_rgba(*load_bitmap(data, bm))


def encode_bmp24(img: np.ndarray):
    """(H, W, 3) uint8 -> (a 24-bit BI_RGB bottom-up BMP, the RGBA it
    decodes to)."""
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)     # BGR
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, RAW, rows.size,
                       2835, 2835, 0, 0)
    offset = 14 + len(info)
    head = b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
    rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return head + info + rows.tobytes(), rgba
