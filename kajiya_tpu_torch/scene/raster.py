"""What the BMP, ICO / CUR, TGA and GIF decoders share: a file-like view of
the bytes, PIL's raw unpackers and palettes, its `raw` tile decoder, its
`convert("RGBA")`, and the native loops of `csrc/raster_decoder.cpp`.

Each decoder follows its PIL 12.1.0 plugin statement by statement, so that
it gives the same bytes and refuses where PIL refuses. An image is a
(mode, pixels, palette) triple as PIL holds it before `convert("RGBA")`:
mode "1" and "L" and "P" as (H, W) uint8 ("1" as 0 / 255), "LA" (H, W, 2),
"RGB" (H, W, 3), "RGBA" (H, W, 4), and for "P" a (256, 4) RGBA palette.

The sequential loops (BMP RLE4 / RLE8, TGA RLE, GIF LZW) run in C++,
compiled with g++ at first use into the gitignored `_build/`
(`hostlib.load`); a failed build raises, and there is no Python loop to
fall back to.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import hostlib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "raster_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None

# native status codes
OK, TRUNCATED, BROKEN, OVERRUN, UNPACK = 0, 1, 2, 3, 4


class DecodeError(ValueError):
    """PIL raises while it loads the pixels (truncated or broken data, a
    layout it has no unpacker for): the bake turns the source white."""


def library() -> ctypes.CDLL:
    """The native loops, compiled at first use into BUILD_DIR."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostlib.load(SOURCE, "raster_decoder", CXX, CXX_FLAGS,
                           BUILD_DIR, "the raster decoder")
        i64, ptr, c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.kt_bmp_rle.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int,
                                   i64, ptr, i64, ctypes.POINTER(i64)]
        lib.kt_bmp_rle.restype = c_int
        lib.kt_tga_rle.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int,
                                   c_int, ptr]
        lib.kt_tga_rle.restype = c_int
        lib.kt_gif_lzw.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int,
                                   c_int, c_int, ptr, c_int]
        lib.kt_gif_lzw.restype = c_int
        _lib = lib
        return lib


class Stream:
    """A read-only file over bytes, as PIL's plugins read them: `read`
    returns fewer bytes (or none) at the end, `seek` may pass the end."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            out = self.data[self.pos:]
        else:
            out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def seek(self, pos: int) -> None:
        self.pos = pos

    def tell(self) -> int:
        return self.pos


def safe_read(fp: Stream, n: int) -> bytes:
    """ImageFile._safe_read: exactly n bytes (none for n <= 0), or
    OSError."""
    if n <= 0:
        return b""
    out = fp.read(n)
    if len(out) < n:
        raise DecodeError("Truncated File Read")
    return out


# ----------------------------------------------------------------------------
# unpackers: raw rows -> pixels of the image mode
# ----------------------------------------------------------------------------

# bits per pixel of each raw mode the decoders use, and the raw modes PIL
# unpacks into each image mode (any other pair is PIL's ValueError)
RAW_BITS = {"1": 1, "1;I": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "LA": 16,
            "BGR;15": 16, "BGR;16": 16, "BGRA;15Z": 16, "BGR": 24,
            "BGRX": 32, "XBGR": 32, "BGXR": 32, "BGRA": 32, "ABGR": 32,
            "RGBA": 32, "BGAR": 32}
UNPACKERS = {
    "1": ("1", "1;I"), "L": ("L",), "P": ("P", "P;1", "P;4"),
    "LA": ("LA",), "RGB": ("BGR;15", "BGR;16", "BGR", "BGRX", "XBGR",
                           "BGXR"),
    "RGBA": ("BGRA;15Z", "BGRA", "ABGR", "RGBA", "BGAR")}
# byte order of the 32-bit raw modes: the source byte of R, G, B, A
# (None: 255)
_ORDER32 = {"BGRX": (2, 1, 0, None), "XBGR": (3, 2, 1, None),
            "BGXR": (3, 1, 0, None), "BGRA": (2, 1, 0, 3),
            "ABGR": (3, 2, 1, 0), "RGBA": (0, 1, 2, 3), "BGAR": (3, 1, 0, 2)}


def _bits(rows: np.ndarray, w: int, nbits: int) -> np.ndarray:
    """(H, bytes) -> (H, w) of the MSB-first fields of nbits each."""
    if nbits == 8:
        return rows[:, :w]
    b = np.unpackbits(rows, axis=1)[:, :w * nbits]
    b = b.reshape(rows.shape[0], w, nbits)
    return (b * (1 << np.arange(nbits - 1, -1, -1, dtype=np.uint8))
            ).sum(-1, dtype=np.uint8)


def _scale(v, bits):
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def unpack(rows: np.ndarray, rawmode: str, mode: str, w: int) -> np.ndarray:
    """Raw rows (H, >= row bytes) uint8 -> pixels of `mode`, as PIL's
    unpacker for (mode, rawmode); ValueError where PIL has none."""
    if rawmode not in UNPACKERS.get(mode, ()):
        raise DecodeError(f"unknown raw mode {rawmode} for {mode}")
    h = rows.shape[0]
    if rawmode == "1":
        return _bits(rows, w, 1) * np.uint8(255)
    if rawmode == "1;I":
        return (1 - _bits(rows, w, 1)) * np.uint8(255)
    if rawmode in ("P;1", "P;4"):
        return _bits(rows, w, RAW_BITS[rawmode])
    if rawmode in ("P", "L"):
        return rows[:, :w].copy()
    if rawmode == "LA":
        return rows[:, :2 * w].reshape(h, w, 2).copy()
    if RAW_BITS[rawmode] == 16:
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint16)
        v = v[..., 0] | (v[..., 1] << 8)
        out = np.empty((h, w, 4 if mode == "RGBA" else 3), np.uint8)
        if rawmode == "BGR;16":
            out[..., 0] = _scale(v >> 11 & 31, 5)
            out[..., 1] = _scale(v >> 5 & 63, 6)
        else:
            out[..., 0] = _scale(v >> 10 & 31, 5)
            out[..., 1] = _scale(v >> 5 & 31, 5)
        out[..., 2] = _scale(v & 31, 5)
        if mode == "RGBA":
            out[..., 3] = np.where(v & 0x8000, 0, 255) if \
                rawmode == "BGRA;15Z" else 255
        return out
    if rawmode == "BGR":
        return rows[:, :3 * w].reshape(h, w, 3)[..., ::-1].copy()
    px = rows[:, :4 * w].reshape(h, w, 4)
    src = _ORDER32[rawmode]
    out = np.empty((h, w, 4 if mode == "RGBA" else 3), np.uint8)
    for c in range(out.shape[-1]):
        out[..., c] = 255 if src[c] is None else px[..., src[c]]
    return out


def raw_decode(data: bytes, offset: int, mode: str, rawmode: str, w: int,
               h: int, stride: int = 0, ystep: int = 1) -> np.ndarray:
    """PIL's `raw` tile decoder over the bytes from `offset`: rows of
    `stride` bytes (0: packed), bottom-up when ystep < 0. Fewer bytes than
    the rows need is PIL's "image file is truncated"."""
    if rawmode not in RAW_BITS or rawmode not in UNPACKERS.get(mode, ()):
        raise DecodeError(f"unknown raw mode {rawmode} for {mode}")
    nbytes = (w * RAW_BITS[rawmode] + 7) // 8
    if stride == 0:
        stride = nbytes
    elif stride < nbytes:
        raise DecodeError("raw decoder: stride shorter than a row")
    need = (h - 1) * stride + nbytes
    if offset < 0 or len(data) - offset < need:
        raise DecodeError("image file is truncated")
    buf = np.frombuffer(data, np.uint8, count=need, offset=offset)
    buf = np.concatenate([buf, np.zeros(h * stride - need, np.uint8)])
    px = unpack(buf.reshape(h, stride)[:, :nbytes], rawmode, mode, w)
    return px[::-1] if ystep < 0 else px


# ----------------------------------------------------------------------------
# palettes and convert("RGBA")
# ----------------------------------------------------------------------------

_PAL_RAW = {"RGB": (3, (0, 1, 2, None)), "BGR": (3, (2, 1, 0, None)),
            "BGRX": (4, (2, 1, 0, None))}


def palette(rawmode: str, data: bytes) -> np.ndarray:
    """PIL's putpalette(mode, rawmode, data) as `Image.load` applies it: 256
    entries of (0, 0, 0, 255), the first len(data) / entry bytes of them
    unpacked from `data` (more than 256 raise). (256, 4) uint8."""
    pal = np.zeros((256, 4), np.uint8)
    pal[:, 3] = 255
    if rawmode == "BGRA;15Z":
        n = len(data) // 2
        if n > 256:
            raise DecodeError("invalid palette size")
        px = unpack(np.frombuffer(data, np.uint8, count=2 * n)[None],
                    rawmode, "RGBA", n)[0]
        pal[:n] = px
        return pal
    if rawmode not in _PAL_RAW:
        raise DecodeError(f"unrecognized raw mode {rawmode} for a palette")
    size, order = _PAL_RAW[rawmode]
    n = len(data) // size
    if n > 256:
        raise DecodeError("invalid palette size")
    ent = np.frombuffer(data, np.uint8, count=n * size).reshape(n, size)
    for c in range(4):
        src = order[c]
        if src is not None:
            pal[:n, c] = ent[:, src]
    return pal


def to_rgba(mode: str, px: np.ndarray, pal: np.ndarray | None = None,
            transparency: int | None = None) -> np.ndarray:
    """PIL's `convert("RGBA")` of an image of `mode` (with `pal` for "P";
    `transparency`, an index or grey level, becomes alpha 0)."""
    if mode in ("1", "L"):
        out = np.repeat(px[..., None], 4, -1)
        out[..., 3] = 255
        if transparency is not None:
            out[..., 3] = np.where(px == transparency, 0, 255)
        return out
    if mode == "P":
        pal = pal.copy()
        if transparency is not None:
            pal[transparency, 3] = 0
        return pal[px]
    if mode == "PA":
        out = pal[px[..., 0]]
        out[..., 3] = px[..., 1]
        return out
    if mode == "LA":
        return np.stack([px[..., 0]] * 3 + [px[..., 1]], -1)
    if mode == "RGB":
        return np.concatenate(
            [px, np.full(px.shape[:2] + (1,), 255, np.uint8)], -1)
    return np.ascontiguousarray(px)


def check_status(status: int, what: str) -> None:
    if status == TRUNCATED:
        raise DecodeError(f"{what}: image file is truncated")
    if status == BROKEN:
        raise DecodeError(f"{what}: broken data stream")
    if status == OVERRUN:
        raise DecodeError(f"{what}: buffer overrun")
    if status == UNPACK:
        raise DecodeError(f"{what}: not enough values to unpack")
    if status != OK:
        raise DecodeError(f"{what}: status {status}")
