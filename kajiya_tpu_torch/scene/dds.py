"""DDS texture decoder (no imaging library): what PIL's `DdsImagePlugin`
followed by `convert("RGBA")` gives, which the JAX package's bake uses.

The reference renderer bakes its textures to DDS (BC5 normals, BC7 colour).
`decode_dds` reads the top-level image only, as PIL does, from:

- uncompressed RGB(A) with bit masks (each channel scaled to 8 bits as
  `int(v / max * 255)`; a file that ends early reads zeros, as PIL's
  decoder does), L, LA, and 8-bit palette (P8) pixels;
- DXT1/3/5 and the BC4 / BC5 FourCCs (BC4U, ATI1, BC5U, ATI2, BC5S);
- the DX10 header's BC1-BC7 (UNORM and TYPELESS; BC7 also _SRGB), BC5_SNORM,
  BC6H_UF16 / SF16 and R8G8B8A8.

The BCn blocks are decoded by host C++ (`csrc/bcn_decoder.cpp`, compiled
with g++ at first use into the gitignored `_build/` through `hostlib.load`,
called through ctypes). Sizes that are not a multiple of 4 are cropped.
Everything PIL refuses (DXGI formats it has no decoder for, such as 81
BC4_SNORM or the BC1-BC3 _SRGB formats; other FourCCs; truncated data;
a bad header) raises `DdsError`, a ValueError, so the bake turns it white
as the JAX package's does.

`bc5_blocks` and `bc7_mode6_blocks` encode test textures: the normal and
metallic-roughness maps of `scene/assets.py`'s mixed-format city.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading

import numpy as np

from .. import hostlib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BCN_SOURCE = os.path.join(_PKG, "csrc", "bcn_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

DDS_MAGIC = b"DDS "
_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000

# FourCC -> (BCn, signed)
_FOURCC = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
           b"BC4U": (4, False), b"ATI1": (4, False), b"BC5S": (5, True),
           b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (BCn, signed), 0 for R8G8B8A8 pixels
_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False),
         76: (3, False), 77: (3, False), 79: (4, False), 80: (4, False),
         82: (5, False), 83: (5, False), 84: (5, True), 95: (6, False),
         96: (6, True), 97: (7, False), 98: (7, False), 99: (7, False),
         27: (0, False), 28: (0, False), 29: (0, False)}

_lock = threading.Lock()
_lib = None


class DdsError(ValueError):
    """The bytes are not a DDS file PIL would decode."""


def bcn_library() -> ctypes.CDLL:
    """The BCn block decoder, compiled at first use (`hostlib.load`)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostlib.load(BCN_SOURCE, "bcn_decoder", CXX, CXX_FLAGS,
                           BUILD_DIR, "the BCn decoder")
        lib.kt_bcn_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.kt_bcn_decode.restype = ctypes.c_int
        _lib = lib
        return lib


def decode_bcn(blocks: bytes, fmt: int, width: int, height: int,
               signed: bool = False) -> np.ndarray:
    """BCn block data (fmt 1-7) of a width x height image -> (H, W, 4)
    uint8, as PIL's "bcn" decoder and convert("RGBA") give it."""
    out = np.empty((height, width, 4), np.uint8)
    st = bcn_library().kt_bcn_decode(bytes(blocks), len(blocks), fmt,
                                     int(signed), width, height,
                                     out.ctypes.data)
    if st:
        raise DdsError(f"BC{fmt} data ends before the image does "
                       "(image file is truncated)")
    return out


def _shift_of(mask: int) -> int:
    """Trailing zero bits of a channel mask, as PIL counts them."""
    shift = 0
    if mask:
        while mask >> (shift + 1) << (shift + 1) == mask:
            shift += 1
    return shift


def _masked(data: bytes, width: int, height: int, bitcount: int,
            masks) -> np.ndarray:
    """PIL's DdsRgbDecoder: each pixel a little-endian integer of
    bitcount // 8 bytes, read with `fd.read` (pixel i starts at byte
    i * k of the body, zeros past its end; only the low bytes reach the
    32-bit masks), each channel int((v & mask) >> shift) / (mask >> shift)
    * 255)."""
    nbytes = bitcount // 8
    n = width * height
    body = np.frombuffer(data, np.uint8)
    value = np.zeros(n, np.uint64)
    if nbytes:
        # the pixels that start inside the body; the rest read nothing
        m = min(n, -(-body.size // nbytes))
        start = np.arange(m, dtype=np.int64) * nbytes
        for i in range(min(nbytes, 8)):
            at = start + i
            ok = at < body.size
            byte = np.zeros(m, np.uint64)
            byte[ok] = body[at[ok]]
            value[:m] |= byte << np.uint64(8 * i)
    out = np.full((n, 4), 255, np.uint8)
    for c, mask in enumerate(masks):
        shift = _shift_of(mask)
        total = mask >> shift
        if not total:
            out[:, c] = 0
            continue
        v = (value & np.uint64(mask)) >> np.uint64(shift)
        out[:, c] = np.floor(v.astype(np.float64) / total * 255).astype(
            np.uint8)
    return out.reshape(height, width, 4)


def _raw(data: bytes, width: int, height: int, channels: int) -> np.ndarray:
    need = width * height * channels
    if len(data) < need:
        raise DdsError("image file is truncated")
    return np.frombuffer(data, np.uint8, need).reshape(height, width,
                                                       channels)


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    if data[:4] != DDS_MAGIC:
        raise DdsError("not a DDS file")
    if len(data) < 8 or struct.unpack("<I", data[4:8])[0] != 124:
        raise DdsError("unsupported DDS header size")
    header = data[8:128]
    if len(header) != 120:
        raise DdsError(f"incomplete DDS header: {len(header)} bytes")
    _flags, height, width = struct.unpack("<3I", header[:12])
    _pfsize, pfflags, fourcc, bitcount = struct.unpack("<4I", header[68:84])
    if width <= 0 or height <= 0:
        raise DdsError("empty DDS image")
    from .identify import check_pixels

    check_pixels(width, height)
    body = data[128:]
    if pfflags & _DDPF_RGB:
        count = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack(f"<{count}I", header[84:84 + 4 * count])
        return _masked(body, width, height, bitcount, masks)
    out = np.empty((height, width, 4), np.uint8)
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            g = _raw(body, width, height, 1)
            out[..., :3] = g
            out[..., 3] = 255
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            la = _raw(body, width, height, 2)
            out[..., :3] = la[..., :1]
            out[..., 3] = la[..., 1]
        else:
            raise DdsError(f"unsupported luminance bit count {bitcount}")
        return out
    if pfflags & _DDPF_PAL8:
        pal = np.zeros((256, 4), np.uint8)
        entries = np.frombuffer(body[:1024][:len(body[:1024]) // 4 * 4],
                                np.uint8).reshape(-1, 4)
        pal[:len(entries)] = entries
        return pal[_raw(body[1024:], width, height, 1)[..., 0]]
    if not pfflags & _DDPF_FOURCC:
        raise DdsError(f"unknown DDS pixel format flags {pfflags:#x}")
    code = struct.pack("<I", fourcc)
    if code == b"DX10":
        if len(body) < 20:
            raise DdsError("truncated DX10 header")
        dxgi = struct.unpack("<I", body[:4])[0]
        body = body[20:]
        if dxgi not in _DXGI:
            raise DdsError(f"DXGI format {dxgi} (PIL has no decoder)")
        fmt, signed = _DXGI[dxgi]
        if fmt == 0:
            return _raw(body, width, height, 4).copy()
    elif code in _FOURCC:
        fmt, signed = _FOURCC[code]
    else:
        raise DdsError(f"DDS FourCC {code!r} (PIL has no decoder)")
    return decode_bcn(body, fmt, width, height, signed)


# ----------------------------------------------------------------------------
# writers of test textures
# ----------------------------------------------------------------------------

def dds_header(width: int, height: int, dxgi: int) -> bytes:
    """A DDS file header with a DX10 extension naming `dxgi` (no mips)."""
    pf = struct.pack("<4I", 32, _DDPF_FOURCC, struct.unpack(
        "<I", b"DX10")[0], 0) + bytes(16)
    head = struct.pack("<7I", 124, 0x1 | 0x2 | 0x4 | 0x1000, height, width,
                       0, 0, 1) + bytes(44) + pf + struct.pack(
        "<5I", 0x1000, 0, 0, 0, 0)
    dx10 = struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return DDS_MAGIC + head + dx10


def _blocks_of(img: np.ndarray) -> np.ndarray:
    """(H, W, C) with H, W multiples of 4 -> (H/4 * W/4, 16, C) texels of
    each 4x4 block, blocks in rows, texels in rows."""
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4) \
        .reshape(-1, 16, c)


def _unblock(px: np.ndarray, h: int, w: int) -> np.ndarray:
    c = px.shape[-1]
    return px.reshape(h // 4, w // 4, 4, 4, c).transpose(0, 2, 1, 3, 4) \
        .reshape(h, w, c)


def _pack_bits(fields, nbits: int) -> np.ndarray:
    """Little-endian bit packing of (values (N,), width) fields, in order,
    into (N, nbits / 8) bytes (nbits 64 or 128)."""
    n = len(fields[0][0])
    words = np.zeros((n, nbits // 64), np.uint64)
    pos = 0
    for vals, width in fields:
        v = np.asarray(vals, np.uint64) & np.uint64((1 << width) - 1)
        word, shift = divmod(pos, 64)
        words[:, word] |= v << np.uint64(shift)
        if shift + width > 64:                  # the field spans two words
            words[:, word + 1] |= v >> np.uint64(64 - shift)
        pos += width
    assert pos == nbits, pos
    return words.astype("<u8").view(np.uint8).reshape(n, nbits // 8)


def bc5_blocks(rg: np.ndarray):
    """(H, W, 2) uint8 red and green (H, W multiples of 4) -> (BC5 block
    bytes, the (H, W, 2) texels they decode to). Each channel takes its
    block's min and max as endpoints (a0 = max > a1 = min: the 8-value
    ramp) and the nearest of the 8 values per texel."""
    h, w, _ = rg.shape
    blocks = _blocks_of(rg).astype(np.int64)           # (N, 16, 2)
    out = []
    texels = np.empty_like(blocks)
    for c in range(2):
        v = blocks[..., c]
        a0 = v.max(1)
        a1 = v.min(1)
        flat = a0 == a1
        a0 = np.where(flat & (a0 < 255), a0 + 1, a0)
        a1 = np.where(flat & (a0 == a1), a1 - 1, a1)
        ramp = np.stack([a0, a1] + [((7 - i) * a0 + i * a1) // 7
                                    for i in range(1, 7)], 1)   # (N, 8)
        idx = np.abs(v[:, :, None] - ramp[:, None, :]).argmin(-1)
        texels[..., c] = np.take_along_axis(ramp, idx, 1)
        fields = [(a0, 8), (a1, 8)] + [(idx[:, i], 3) for i in range(16)]
        out.append(_pack_bits(fields, 64))
    data = np.concatenate(out, 1).tobytes()
    return data, _unblock(texels, h, w).astype(np.uint8)


_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def bc7_mode6_blocks(rgba: np.ndarray):
    """(H, W, 4) uint8 (H, W multiples of 4) -> (BC7 block bytes, all mode
    6, the (H, W, 4) texels they decode to). Endpoints are the block's
    per-channel min and max (7 bits plus a p-bit each), indices the nearest
    of the 16 weights along the endpoint line; the first texel's index is
    kept below 8, swapping the endpoints where needed."""
    h, w, _ = rgba.shape
    px = _blocks_of(rgba).astype(np.int64)              # (N, 16, 4)
    e0 = px.min(1)
    e1 = px.max(1)
    # 8-bit endpoints as 7 bits + a shared p-bit per endpoint: p = low bit
    # of the channel sum's majority; value = (v7 << 1) | p
    def quant(e):
        p = (np.round((e & 1).mean(1))).astype(np.int64)     # (N,)
        v7 = np.clip((e - p[:, None]) >> 1, 0, 127)
        return v7, p

    def value(v7, p):
        return (v7 << 1) | p[:, None]

    q0, p0 = quant(e0)
    q1, p1 = quant(e1)
    c0 = value(q0, p0).astype(np.float64)                # (N, 4)
    c1 = value(q1, p1).astype(np.float64)
    d = c1 - c0
    dd = np.maximum((d * d).sum(1), 1e-9)
    t = ((px - c0[:, None, :]) * d[:, None, :]).sum(-1) / dd[:, None]
    # the nearest weight (the lower one at a tie)
    idx = np.searchsorted((_W4[1:] + _W4[:-1]) / 2.0, t * 64)    # (N, 16)
    swap = idx[:, 0] >= 8
    idx = np.where(swap[:, None], 15 - idx, idx)
    q0, q1 = (np.where(swap[:, None], q1, q0), np.where(swap[:, None], q0, q1))
    p0, p1 = np.where(swap, p1, p0), np.where(swap, p0, p1)
    n = px.shape[0]
    fields = [(np.full(n, 1 << 6), 7)]
    for c in range(4):
        fields += [(q0[:, c], 7), (q1[:, c], 7)]
    fields += [(p0, 1), (p1, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    data = _pack_bits(fields, 128).tobytes()
    a = value(q0, p0)[:, None, :]
    b = value(q1, p1)[:, None, :]
    wt = _W4[idx][..., None]
    texels = ((64 - wt) * a + wt * b + 32) >> 6
    return data, _unblock(texels, h, w).astype(np.uint8)
