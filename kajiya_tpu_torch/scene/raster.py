"""What the BMP, ICO / CUR, TGA, GIF, TIFF, PCX, PPM, SGI, QOI, PSD, BLP,
FTEX, SUN and the other small plugins' decoders share: a file-like view of
the bytes, PIL's raw unpackers and palettes, its `raw` tile decoder, its
`convert("RGBA")`, and the native loops of `csrc/raster_decoder.cpp`.

Each decoder follows its PIL 12.1.0 plugin statement by statement, so that
it gives the same bytes and refuses where PIL refuses. An image is a
(mode, pixels, palette) triple as PIL holds it before `convert("RGBA")`:
mode "1" and "L" and "P" as (H, W) uint8 ("1" as 0 / 255), "I;16" and
"I;16B" uint16, "I" int32, "F" float32, "LA" and "PA" (H, W, 2), "RGB"
(H, W, 3), "RGBA" and "CMYK" (H, W, 4), "LAB" (H, W, 4) as `lab.py` holds
it, and for "P" and "PA" a (256, 4) RGBA palette.

The sequential loops (BMP RLE4 / RLE8, TGA RLE, GIF LZW, PCX RLE, SGI RLE,
PIL's PackBits, QOI, BLP's DXT, SUN RLE) and the writers' encoders run in
C++, compiled with g++ at first use into the gitignored `_build/`
(`hostlib.load`); a failed build raises, and there is no Python loop to
fall back to.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import hostlib
from . import lab

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
        lib.kt_pcx_rle.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int,
                                   c_int, c_int, ptr]
        lib.kt_sgi_rle.argtypes = [ctypes.c_char_p, i64, c_int, c_int, c_int,
                                   c_int, ptr]
        lib.kt_packbits_rows.argtypes = [ctypes.c_char_p, i64, i64, c_int,
                                         c_int, ptr]
        lib.kt_qoi.argtypes = [ctypes.c_char_p, i64, i64, i64, c_int, ptr]
        lib.kt_blp_dxt.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int,
                                   c_int, c_int, ptr]
        lib.kt_sun_rle.argtypes = [ctypes.c_char_p, i64, i64, i64, c_int, ptr]
        for f in (lib.kt_pcx_rle, lib.kt_sgi_rle, lib.kt_packbits_rows,
                  lib.kt_qoi, lib.kt_blp_dxt, lib.kt_sun_rle):
            f.restype = c_int
        lib.kt_sgi_rle_encode.argtypes = [ptr, i64, i64, ptr]
        lib.kt_pcx_rle_encode.argtypes = [ptr, i64, ptr]
        lib.kt_qoi_encode.argtypes = [ptr, i64, c_int, ptr]
        lib.kt_sun_rle_encode.argtypes = [ptr, i64, ptr]
        for f in (lib.kt_sgi_rle_encode, lib.kt_pcx_rle_encode,
                  lib.kt_qoi_encode, lib.kt_sun_rle_encode):
            f.restype = i64
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

# bits per pixel of PIL's unpacker for each (image mode, raw mode) the
# decoders use; any other pair is PIL's ValueError "unknown raw mode"
RAW_BITS = {(m, r): b for m, r, b in (
    ("1", "1", 1), ("1", "1;I", 1), ("1", "1;R", 1), ("1", "1;IR", 1),
    ("L", "L;2", 2), ("L", "L;2I", 2), ("L", "L;2R", 2), ("L", "L;2IR", 2),
    ("L", "L;4", 4), ("L", "L;4I", 4), ("L", "L;4R", 4), ("L", "L;4IR", 4),
    ("L", "L", 8), ("L", "L;I", 8), ("L", "L;R", 8), ("P", "P;1", 1),
    ("P", "P;2", 2), ("P", "P;4", 4), ("P", "P", 8), ("P", "P;R", 8),
    ("P", "PX", 16), ("PA", "PA", 16), ("LA", "LA", 16),
    ("I;16", "I;16", 16), ("I;16", "I;16N", 16), ("I;16", "I;16R", 16),
    ("I;16", "I;12", 12), ("I;16B", "I;16B", 16), ("I;16B", "I;16N", 16),
    ("I", "I", 32), ("I", "I;16S", 16), ("I", "I;16BS", 16),
    ("I", "I;32N", 32), ("I", "I;32S", 32), ("I", "I;32BS", 32),
    ("F", "F", 32), ("F", "F;32F", 32), ("F", "F;32BF", 32),
    ("RGB", "BGR;15", 16), ("RGB", "BGR;16", 16), ("RGB", "BGR", 24),
    ("RGB", "BGRX", 32), ("RGB", "XBGR", 32), ("RGB", "BGXR", 32),
    ("RGB", "RGB", 24), ("RGB", "RGB;R", 24), ("RGB", "RGBX", 32),
    ("RGB", "RGBXX", 40), ("RGB", "RGBXXX", 48), ("RGB", "RGB;16L", 48),
    ("RGB", "RGB;16B", 48), ("RGB", "RGB;16N", 48),
    ("RGB", "RGBX;16L", 64), ("RGB", "RGBX;16B", 64),
    ("RGB", "RGBX;16N", 64), ("RGBA", "BGRA;15Z", 16),
    ("RGBA", "BGRA", 32), ("RGBA", "ABGR", 32), ("RGBA", "RGBA", 32),
    ("RGBA", "BGAR", 32), ("RGBA", "RGBa", 32), ("RGBA", "RGBaX", 40),
    ("RGBA", "RGBaXX", 48), ("RGBA", "RGBAX", 40), ("RGBA", "RGBAXX", 48),
    ("RGBA", "RGBA;16L", 64), ("RGBA", "RGBA;16B", 64),
    ("RGBA", "RGBA;16N", 64), ("RGBA", "RGBa;16L", 64),
    ("RGBA", "RGBa;16B", 64), ("RGBA", "RGBa;16N", 64),
    ("CMYK", "CMYK", 32), ("CMYK", "CMYKX", 40), ("CMYK", "CMYKXX", 48),
    ("CMYK", "CMYK;16L", 64), ("CMYK", "CMYK;16B", 64),
    ("CMYK", "CMYK;16N", 64), ("LAB", "LAB", 24))}
# the bands each mode stores; a band of a multi-band mode is also a raw
# mode of its own (a planar layer), 8 bits wide
BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1,
         "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}
for _mode in ("RGB", "RGBA", "CMYK", "LAB"):
    RAW_BITS.update({(_mode, _band): 8 for _band in _mode})
# byte order of the 32-bit raw modes: the source byte of R, G, B, A
# (None: 255)
_ORDER32 = {"BGRX": (2, 1, 0, None), "XBGR": (3, 2, 1, None),
            "BGXR": (3, 1, 0, None), "BGRA": (2, 1, 0, 3),
            "ABGR": (3, 2, 1, 0), "RGBA": (0, 1, 2, 3), "BGAR": (3, 1, 0, 2)}
# a band's byte order in the 16-bit raw modes: which byte is the high one
_HIGH = {"L": 1, "N": 1, "B": 0}
# each byte with its bits in reverse order (FillOrder 2, the ";R" modes)
REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def raw_bits(mode: str, rawmode: str) -> int:
    """Bits per pixel of PIL's unpacker for (mode, rawmode); DecodeError
    (PIL's ValueError) where it has none."""
    bits = RAW_BITS.get((mode, rawmode))
    if bits is None:
        raise DecodeError(f"unknown raw mode {rawmode} for {mode}")
    return bits


def new(mode: str, w: int, h: int) -> np.ndarray:
    """Image.core.new: zeros in the storage of `mode` that `unpack` gives."""
    if mode in ("I;16", "I;16B"):
        return np.zeros((h, w), np.uint16)
    if mode == "I":
        return np.zeros((h, w), np.int32)
    if mode == "F":
        return np.zeros((h, w), np.float32)
    if mode == "LAB":
        return np.zeros((h, w, 4), np.uint8)
    b = BANDS[mode]
    return np.zeros((h, w) if b == 1 else (h, w, b), np.uint8)


def _bits(rows: np.ndarray, w: int, nbits: int) -> np.ndarray:
    """(H, bytes) -> (H, w) of the MSB-first fields of nbits each (uint8,
    uint16 above 8 bits)."""
    if nbits == 8:
        return rows[:, :w]
    dt = np.uint8 if nbits < 8 else np.uint16
    b = np.unpackbits(rows, axis=1)[:, :w * nbits]
    b = b.reshape(rows.shape[0], w, nbits).astype(dt)
    return (b * (1 << np.arange(nbits - 1, -1, -1, dtype=dt))).sum(-1,
                                                                   dtype=dt)


def _scale(v, bits):
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def unpack(rows: np.ndarray, rawmode: str, mode: str, w: int,
           out: np.ndarray | None = None) -> np.ndarray:
    """Raw rows (H, >= row bytes) uint8 -> pixels of `mode` (the storage of
    `new`), as PIL's unpacker for (mode, rawmode); DecodeError where PIL has
    none. A band's raw mode (a planar layer) writes its band into a copy of
    `out`, the image's pixels so far, and returns it."""
    bits = raw_bits(mode, rawmode)
    h = rows.shape[0]
    if len(rawmode) == 1 and BANDS[mode] > 1:
        out = out.copy()
        out[..., mode.index(rawmode)] = rows[:, :w]
        return out
    if mode == "1":
        v = REVERSE[rows] if rawmode in ("1;R", "1;IR") else rows
        f = _bits(v, w, 1)
        if rawmode in ("1;I", "1;IR"):
            f = 1 - f
        return f * np.uint8(255)
    if mode in ("L", "P") and rawmode != "PX":
        flags = rawmode.partition(";")[2]
        v = REVERSE[rows] if "R" in flags else rows
        f = _bits(v, w, bits).astype(np.int32)
        if mode == "L":
            f = f * (255 // ((1 << bits) - 1))
            if "I" in flags:
                f = 255 - f
        return f.astype(np.uint8)
    if rawmode in ("PX", "PA", "LA"):
        v = rows[:, :2 * w].reshape(h, w, 2)
        return v[..., 0].copy() if rawmode == "PX" else v.copy()
    if mode in ("I;16", "I;16B"):
        if rawmode == "I;12":
            return _bits(rows, w, 12)
        order = ">" if rawmode in ("I;16B", "I;16R") else "<"
        return rows[:, :2 * w].copy().view(order + "u2").astype(np.uint16)
    if mode == "I":
        dt = {"I": "<i4", "I;16S": "<i2", "I;16BS": ">i2", "I;32N": "<i4",
              "I;32S": "<i4", "I;32BS": ">i4"}[rawmode]
        return rows[:, :int(dt[-1]) * w].copy().view(dt).astype(np.int32)
    if mode == "F":
        dt = ">f4" if rawmode == "F;32BF" else "<f4"
        return rows[:, :4 * w].copy().view(dt).astype(np.float32)
    if mode == "LAB":
        return lab.unpack_lab(rows, w)
    if bits == 16:
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
            out[..., 3] = np.where(v & 0x8000, 0, 255)
        return out
    if rawmode == "BGR":
        return rows[:, :3 * w].reshape(h, w, 3)[..., ::-1].copy()
    if rawmode in _ORDER32:
        px = rows[:, :4 * w].reshape(h, w, 4)
        src = _ORDER32[rawmode]
        out = np.empty((h, w, 4 if mode == "RGBA" else 3), np.uint8)
        for c in range(out.shape[-1]):
            out[..., c] = 255 if src[c] is None else px[..., src[c]]
        return out
    return _unpack_bands(rows, rawmode, w)


def _unpack_bands(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """The RGB(A) / CMYK raw modes of 8 or 16 bits a band (the high byte
    kept), with padding bands and associated alpha: (H, w, 3 or 4)."""
    base, _, suffix = rawmode.partition(";")
    n = len(base)
    if suffix.startswith("16"):
        v = rows[:, :2 * n * w].reshape(-1, w, n, 2)[..., _HIGH[suffix[-1]]]
    else:
        v = rows[:, :n * w].reshape(-1, w, n)
        if rawmode == "RGB;R":
            v = REVERSE[v]
    px = np.ascontiguousarray(v[..., :len(base.rstrip("X"))])
    return unpremultiply(px) if base.startswith("RGBa") else px


def unpremultiply(px: np.ndarray) -> np.ndarray:
    """PIL's unpackRGBa: colour * 255 / alpha, clipped; alpha 0 gives 0."""
    a = px[..., 3:4].astype(np.int32)
    c = px[..., :3].astype(np.int32) * 255 // np.maximum(a, 1)
    out = np.concatenate([np.minimum(c, 255), a], -1).astype(np.uint8)
    out[px[..., 3] == 0] = 0
    full = px[..., 3] == 255
    out[full] = px[full]
    return out


class StrideError(DecodeError):
    """PIL's raw decoder refuses a stride shorter than a row
    (IMAGING_CODEC_CONFIG); `ImageFile.load` goes on with the next tile."""


def raw_decode(data: bytes, offset: int, mode: str, rawmode: str, w: int,
               h: int, stride: int = 0, ystep: int = 1,
               out: np.ndarray | None = None) -> np.ndarray:
    """PIL's `raw` tile decoder over the bytes from `offset`: rows of
    `stride` bytes (0: packed), bottom-up when ystep < 0, `out` the tile's
    pixels so far (for a band's raw mode). A stride shorter than a row
    raises StrideError; fewer bytes than the rows need is PIL's "image file
    is truncated"."""
    nbytes = (w * raw_bits(mode, rawmode) + 7) // 8
    if stride == 0:
        stride = nbytes
    elif stride < nbytes:
        raise StrideError("raw decoder: stride shorter than a row")
    need = (h - 1) * stride + nbytes
    if offset < 0 or len(data) - offset < need:
        raise DecodeError("image file is truncated")
    buf = np.frombuffer(data, np.uint8, count=need, offset=offset)
    buf = np.concatenate([buf, np.zeros(h * stride - need, np.uint8)])
    px = unpack(buf.reshape(h, stride)[:, :nbytes], rawmode, mode, w, out)
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


def planar_palette(data: bytes) -> np.ndarray:
    """putpalette("RGB", "RGB;L", data): len / 3 entries whose red, green
    and blue come from three planes of that length, the rest (0, 0, 0,
    255); more than 256 raise (PIL's "invalid palette size")."""
    n = len(data) // 3
    if n > 256:
        raise DecodeError("invalid palette size")
    pal = palette("RGB", b"")
    pal[:n, :3] = np.frombuffer(data, np.uint8, 3 * n).reshape(3, n).T
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
    if mode in ("I;16", "I;16B", "I", "F"):
        return to_rgba("L", grey(mode, px))
    if mode == "CMYK":
        return cmyk_to_rgba(px)
    if mode == "LAB":
        return lab.to_rgba(px)
    return np.ascontiguousarray(px)


def grey(mode: str, px: np.ndarray) -> np.ndarray:
    """PIL's conversion of the integer and float modes to "L": I;16 clips
    at 255, I at 0 and 255, F clips and truncates (NaN gives 0)."""
    if mode == "F":
        v = px.astype(np.float32)
        with np.errstate(invalid="ignore"):
            inner = np.where(np.isnan(v), 0, np.clip(v, 0, 255))
        out = np.where(v <= 0, 0, np.where(v >= 255, 255, inner))
        return out.astype(np.uint8)
    return np.clip(px.astype(np.int64), 0, 255).astype(np.uint8)


def cmyk_to_rgba(px: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB: each channel (255 - k) - round(c (255 - k) / 255)
    in its integer form."""
    nk = 255 - px[..., 3:4].astype(np.int32)
    t = px[..., :3].astype(np.int32) * nk + 128
    m = ((t >> 8) + t) >> 8
    rgb = np.clip(nk - m, 0, 255).astype(np.uint8)
    return np.concatenate(
        [rgb, np.full(px.shape[:2] + (1,), 255, np.uint8)], -1)


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
