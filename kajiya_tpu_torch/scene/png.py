"""PNG decoder and encoder on zlib and numpy (no imaging library).

The JAX package decodes textures with PIL, which the card's machine does not
have. `decode_png` gives what PIL's `Image.open(f).convert("RGBA")` gives,
byte for byte, for the formats textures use:

- colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and
  6 (RGBA) at bit depth 8; grey and palette also at bit depths 1, 2 and 4;
- the five row filters, image data split over several IDAT chunks;
- tRNS for grey, RGB and palette images, with PIL's reading of it: a grey
  key is compared with the grey value after PIL scales 2- and 4-bit samples
  to 8 bits, so only a key of 0 takes effect there;
- chunk checksums are verified up to the first IDAT chunk, as PIL verifies
  them (it reads the image data and what follows without its checksums).

16-bit samples and Adam7 interlacing raise NotImplementedError (ROADMAP.md
lists them). Corrupt data raises `PngError`, a ValueError.

`encode_png` writes 8-bit grey, grey + alpha, RGB or RGBA PNGs with a chosen
row filter per row, for the viewer's output and for test images.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


class PngError(ValueError):
    """The bytes are not a well-formed PNG."""


def _read_chunks(data: bytes):
    """(IHDR, PLTE, tRNS, image data) of a PNG byte string."""
    if data[:8] != PNG_SIGNATURE:
        raise PngError("not a PNG file")
    pos, ihdr, plte, trns, idat = 8, None, None, None, []
    while True:
        if pos + 8 > len(data):
            raise PngError("truncated PNG: no image data")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise PngError(f"truncated {kind!r} chunk")
        pos += 12 + length
        if kind == b"IDAT":
            idat.append(body)
            continue
        if idat:            # the image data ends at its first other chunk
            break
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PngError(f"bad checksum in {kind!r}")
        if kind == b"IHDR":
            if length < 13:
                raise PngError("truncated IHDR")
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IEND":
            raise PngError("no image data")
    if ihdr is None:
        raise PngError("no IHDR chunk")
    return ihdr, plte, trns, b"".join(idat)


def _filter_factors(ftype: np.ndarray, ndim: int):
    """One 0/1 int16 factor per row for each of the filters Sub, Up,
    Average and Paeth, shaped (H, 1, ...) to broadcast over `ndim` axes."""
    shape = (-1,) + (1,) * (ndim - 1)
    return [(ftype == k).astype(np.int16).reshape(shape) for k in range(1, 5)]


def _predict(factors, a, b, c):
    """The PNG predictor from the left (a), upper (b) and upper-left (c)
    bytes, each row's filter chosen by its factors (None predicts 0)."""
    sub, up, avg, paeth_f = factors
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return sub * a + up * b + avg * ((a + b) >> 1) + paeth_f * paeth


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int):
    """Undo the row filters of (height, 1 + stride) filtered bytes.

    Byte (r, x) depends on (r, x - bpp), (r - 1, x) and (r - 1, x - bpp)
    only, so with a row viewed as (stride / bpp) pixels of bpp bytes, pixel
    (r, c) depends on the anti-diagonals r + c - 1 and r + c - 2 alone. The
    rows are skewed so that each anti-diagonal is one contiguous row of an
    array, and one numpy step decodes a whole diagonal, whatever mix of
    filters its rows use."""
    ftype = raw[:, 0]
    if int(ftype.max(initial=0)) > 4:
        raise PngError(f"unknown row filter {int(ftype.max())}")
    if not ftype.any():
        return raw[:, 1:]
    wp = stride // bpp
    r_idx = np.repeat(np.arange(height), wp)
    d_idx = r_idx + np.tile(np.arange(wp), height)
    # skewed[d, r] = pixel (r, d - r); decoded pixel (r, c) lands at
    # out[r + c + 2, r + 1], with row 0 and the column left of each row 0
    data = np.zeros((height + wp - 1, height, bpp), np.int16)
    data[d_idx, r_idx] = raw[:, 1:].reshape(height * wp, bpp)
    out = np.zeros((height + wp + 1, height + 1, bpp), np.int16)
    factors = _filter_factors(ftype, 2)
    for d in range(height + wp - 1):
        r0, r1 = max(0, d - wp + 1), min(height - 1, d) + 1
        pred = _predict([f[r0:r1] for f in factors], out[d + 1, r0 + 1:r1 + 1],
                        out[d + 1, r0:r1], out[d, r0:r1])
        out[d + 2, r0 + 1:r1 + 1] = (data[d, r0:r1] + pred) & 255
    return out[d_idx + 2, r_idx + 1].astype(np.uint8).reshape(height, stride)


def _unpack(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, stride) bytes of `depth`-bit samples -> (H, width) uint8."""
    if depth == 8:
        return rows
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    (width, height, depth, ctype, _comp, filt, interlace), plte, trns, z = \
        _read_chunks(data)
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PngError(f"bit depth {depth} with colour type {ctype}")
    if depth == 16:
        raise NotImplementedError(
            "16-bit PNG decoding is not ported (ROADMAP.md section 1)")
    if interlace:
        raise NotImplementedError(
            "interlaced (Adam7) PNG decoding is not ported (ROADMAP.md "
            "section 1)")
    if filt:
        raise PngError("unknown filter method")
    if width == 0 or height == 0:
        raise PngError("empty image")
    bits = _CHANNELS[ctype] * depth
    stride = (width * bits + 7) // 8
    need = height * (stride + 1)
    try:
        raw = zlib.decompressobj().decompress(z, need)
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from None
    if len(raw) < need:
        raise PngError("truncated image data")
    rows = _unfilter(np.frombuffer(raw, np.uint8).reshape(height, stride + 1),
                     height, stride, max(1, bits // 8))

    out = np.empty((height, width, 4), np.uint8)
    if ctype in (0, 3):
        v = _unpack(rows, width, depth)
        if ctype == 0:
            g = v * np.uint8(_GREY_SCALE[depth])
            out[..., :3] = g[..., None]
            out[..., 3] = 255
            if trns is not None and len(trns) >= 2:
                key = struct.unpack(">H", trns[:2])[0]
                if depth == 1:
                    key = 255 if key else 0
                out[..., 3] = np.where(g == key, 0, 255)
        else:
            # PIL's palette: entries past PLTE (all of them without one) are
            # black, alpha past tRNS 255
            plte = plte or b""
            pal = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8)
            lut = np.zeros((256, 4), np.uint8)
            lut[:, 3] = 255
            lut[:len(pal) // 3, :3] = pal.reshape(-1, 3)[:256]
            if trns is not None:
                alpha = np.frombuffer(trns[:256], np.uint8)
                lut[:len(alpha), 3] = alpha
            out[:] = lut[v]
        return out
    px = rows.reshape(height, width, _CHANNELS[ctype])
    if ctype == 2:
        out[..., :3] = px
        out[..., 3] = 255
        if trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            out[..., 3] = np.where((px == key).all(-1), 0, 255)
    elif ctype == 4:
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    else:
        out[:] = px
    return out


# ----------------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------------

_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray, filters=0,
               idat_bytes: int | None = None) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1-4 -> 8-bit PNG bytes (grey, grey +
    alpha, RGB or RGBA). `filters`: a row filter (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth) or a sequence cycled over the rows. `idat_bytes`
    splits the compressed data into IDAT chunks of at most that size."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"{c} channels")
    ftypes = np.resize(np.atleast_1d(np.asarray(filters, np.int64)), h)
    if ftypes.min() < 0 or ftypes.max() > 4:
        raise ValueError(f"row filters {filters}")
    x = img.reshape(h, w, c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    pred = _predict(_filter_factors(ftypes, 3), a, b, cc)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = ftypes
    rows[:, 1:] = ((x - pred) & 255).reshape(h, w * c)
    z = zlib.compress(rows.tobytes(), 6)
    step = idat_bytes or max(len(z), 1)
    idat = b"".join(_chunk(b"IDAT", z[i:i + step])
                    for i in range(0, max(len(z), 1), step))
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          _COLOR_TYPE[c], 0, 0, 0))
            + idat + _chunk(b"IEND", b""))
