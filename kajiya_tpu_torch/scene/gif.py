"""GIF texture decoding: the first frame, as PIL 12.1.0's `GifImagePlugin`
gives it (`Image.open(f).convert("RGBA")`, byte for byte).

The logical screen sets the size, grown to hold a frame that reaches past
it. The frame's local colour table, else the global one, is its palette
(mode "P"); a table that is the identity grey ramp (i, i, i), or none,
leaves mode "L", whose indices are grey levels (a grey local table over
a global one of colours takes the global one's colours, as PIL loads
it). A graphic-control
extension's transparency index becomes alpha 0, and the area outside the
frame holds that index (else index 0). Extensions and comments are
skipped as PIL skips them; a stray byte between blocks is passed over.
Interlaced rows are placed in GIF's four passes. The LZW stream is
expanded as PIL's `GifDecode.c` does it (`csrc/raster_decoder.cpp`):
codes of 3 to 12 bits, clear and end codes, a full table that stops
growing; data that ends, or an end code, before the frame is full is
PIL's "image file is truncated" (white, as its load raises). A header or
frame descriptor that ends early is PIL's refusal.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import check_pixels, opening
from .raster import DecodeError, Stream


def _i16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _sub_block(fp: Stream):
    s = fp.read(1)
    if s and s[0]:
        return fp.read(s[0])
    return None


def _palette_needed(p: bytes) -> bool:
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> (H, W, 4) uint8 RGBA of the first frame."""
    data = bytes(data)
    with opening("GIF"):
        fp = Stream(data)
        s = fp.read(13)
        if not s.startswith((b"GIF87a", b"GIF89a")):
            raise SyntaxError("not a GIF file")
        size = [_i16(s, 6), _i16(s, 8)]
        flags = s[10]
        global_pal = None
        if flags & 128:
            p = fp.read(3 << ((flags & 7) + 1))
            if _palette_needed(p):
                global_pal = p
        # GifImageFile._seek(0)
        s = fp.read(1)
        if not s or s == b";":
            raise EOFError("no more images in GIF file")
        local_pal = None          # None: no local table; False: a grey one
        transparency = None
        interlace = None
        while True:
            if not s:
                s = fp.read(1)
            if not s or s == b";":
                break
            if s == b"!":
                s = fp.read(1)
                block = _sub_block(fp)
                if s[0] == 249 and block is not None:
                    if block[0] & 1:
                        transparency = block[3]
                    _i16(block, 1)
                elif s[0] == 254:
                    while block:
                        block = _sub_block(fp)
                    s = b""
                    continue
                elif s[0] == 255 and block is not None:
                    if block.startswith(b"NETSCAPE2.0"):
                        block = _sub_block(fp)
                        if block and len(block) >= 3 and block[0] == 1:
                            _i16(block, 1)
                while _sub_block(fp):
                    pass
            elif s == b",":
                s = fp.read(9)
                x0, y0 = _i16(s, 0), _i16(s, 2)
                x1, y1 = x0 + _i16(s, 4), y0 + _i16(s, 6)
                if x1 > size[0] or y1 > size[1]:
                    size = [max(x1, size[0]), max(y1, size[1])]
                    check_pixels(*size)
                flags = s[8]
                interlace = (flags & 64) != 0
                if flags & 128:
                    p = fp.read(3 << ((flags & 7) + 1))
                    local_pal = p if _palette_needed(p) else False
                bits = fp.read(1)[0]
                offset = fp.tell()
                break
            s = b""
        if interlace is None:
            raise EOFError("image not found in GIF frame")
        if size[0] <= 0 or size[1] <= 0:
            raise SyntaxError("not identified by this plugin")
    check_pixels(*size)
    # a grey local table leaves mode "L", but the global table, if any,
    # is still put on the image when it loads: "L" becomes "P" with it
    pal = local_pal or global_pal
    w, h = size
    if not 0 <= bits <= 12:
        raise DecodeError("bad number of bits")
    if x1 <= x0 or y1 <= y0:
        raise DecodeError("tile cannot extend outside image")
    px = np.full((h, w), transparency or 0, np.uint8)
    sub = np.ascontiguousarray(px[y0:y1, x0:x1])
    st = raster.library().kt_gif_lzw(data, len(data), offset, bits,
                                     int(interlace), x1 - x0, y1 - y0,
                                     sub.ctypes.data, x1 - x0)
    raster.check_status(st, "GIF LZW")
    px[y0:y1, x0:x1] = sub
    if pal:
        return raster.to_rgba("P", px, raster.palette("RGB", pal),
                              transparency)
    return raster.to_rgba("L", px, None, transparency)


def _quantise(img: np.ndarray):
    """(H, W, 3) -> (palette (n <= 256, 3), indices (H, W)): the image's
    own colours, its low bits cleared (and the level centred) one bit at a
    time until at most 256 are left."""
    px = img.reshape(-1, 3)
    for shift in range(8):
        q = px if shift == 0 else \
            ((px >> shift) << shift) | (1 << (shift - 1))
        key = (q[:, 0].astype(np.uint32) << 16) | \
            (q[:, 1].astype(np.uint32) << 8) | q[:, 2]
        keys, idx = np.unique(key, return_inverse=True)
        if len(keys) <= 256:
            pal = np.stack([keys >> 16, keys >> 8, keys], -1) & 255
            return pal.astype(np.uint8), idx.reshape(img.shape[:2])
    raise AssertionError("unreachable")


def encode_gif256(img: np.ndarray):
    """(H, W, 3) uint8 -> (a GIF89a of one frame with a 256-entry global
    table, the RGBA it decodes to). The LZW stream holds every index as a
    literal 9-bit code, a clear code before each 255th, so the code size
    never grows."""
    h, w = img.shape[:2]
    pal, idx = _quantise(img)
    table = np.zeros((256, 3), np.uint8)
    table[:len(pal)] = pal
    lits = idx.reshape(-1).astype(np.uint16)
    n = lits.size
    # [clear, 254 literals] ..., end
    groups = (n + 253) // 254
    codes = np.empty(n + groups + 1, np.uint16)
    pos = np.arange(n) + np.arange(n) // 254 + 1
    codes[pos] = lits
    codes[np.arange(groups) * 255] = 256
    codes[-1] = 257
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    stream = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(stream[i:i + 255])]) + stream[i:i + 255]
                      for i in range(0, len(stream), 255))
    head = b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + \
        table.tobytes()
    desc = b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
    data = head + desc + b"\x08" + blocks + b"\x00;"
    rgba = np.concatenate([table[idx], np.full((h, w, 1), 255, np.uint8)],
                          -1)
    return data, rgba
