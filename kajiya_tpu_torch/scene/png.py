"""PNG decoder and encoder on zlib and numpy (no imaging library).

The JAX package decodes textures with PIL, which the card's machine does not
have. `decode_png` gives what PIL's `Image.open(f).convert("RGBA")` gives,
byte for byte, for the formats textures use:

- colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and
  6 (RGBA) at bit depth 8; grey and palette also at bit depths 1, 2 and 4;
- 16-bit samples, as PIL reads them: colour types 2, 4 and 6 keep the high
  byte (0x1234 -> 0x12), while 16-bit grey opens as I;16, which
  `convert("RGBA")` clamps (0x1234 -> 255, 0x0080 -> 128);
- Adam7 interlacing, at every colour type and depth (PIL reads any nonzero
  interlace method as Adam7);
- the five row filters, image data split over several IDAT chunks;
- tRNS for grey, RGB and palette images, with PIL's reading of it: the key's
  low byte is compared with the 8-bit value after PIL's conversion (so a
  2- or 4-bit grey key other than 0 never matches, and a 16-bit key is
  compared with the clamped grey or the high bytes);
- chunk checksums are verified up to the first IDAT chunk, as PIL verifies
  them (it reads the image data and what follows without its checksums).

Corrupt data raises `PngError`, a ValueError.

`encode_png` writes 8- or 16-bit grey, grey + alpha, RGB or RGBA PNGs with
a chosen row filter per row, for the viewer's output and for test images.
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


def _is_cid(kind: bytes) -> bool:
    return len(kind) == 4 and all(65 <= c <= 90 or 97 <= c <= 122
                                  for c in kind)


def _read_chunks(data: bytes):
    """(IHDR, PLTE, tRNS, image data) of a PNG byte string, read as PIL
    reads it: the chunks before the first IDAT whole and with their
    checksums; the image data as far as the file holds it (an IDAT cut
    short, or no IEND, is an error only where the image needs the missing
    bytes); the chunks after it without checksums, stopping at IEND, at
    the file's end or at bytes that are no chunk name."""
    if data[:8] != PNG_SIGNATURE:
        raise PngError("not a PNG file")
    pos, ihdr, plte, trns, idat = 8, None, None, None, []
    while True:
        if pos + 8 > len(data):
            raise PngError("truncated PNG: no image data")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            break
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise PngError(f"truncated {kind!r} chunk")
        pos += 12 + length
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
    # the image data: consecutive IDAT chunks, the last maybe cut short
    while True:
        idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
        if pos + 8 > len(data):
            break
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind != b"IDAT":
            break
    # PngImageFile.load_end: every other chunk after the image data is read
    # through (a chunk cut short raises), up to IEND
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if not _is_cid(kind) or kind == b"IEND":
            break
        if pos + 8 + length > len(data):
            raise PngError(f"truncated {kind!r} chunk after the image data")
        pos += 12 + length
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


# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pixels(raw: np.ndarray, width: int, height: int, depth: int,
            channels: int) -> np.ndarray:
    """(height, 1 + stride) filtered rows -> (height, width, channels)
    samples: uint16 at depth 16, else uint8 (sub-byte samples unpacked)."""
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter(raw.reshape(height, stride + 1), height, stride,
                     max(1, bits // 8))
    if depth == 16:
        be = rows.reshape(height, width * channels, 2).astype(np.uint16)
        return ((be[..., 0] << 8) | be[..., 1]).reshape(height, width,
                                                        channels)
    if depth == 8:
        return rows.reshape(height, width, channels)
    return _unpack(rows, width, depth)[..., None]


def _image_samples(z: bytes, width: int, height: int, depth: int,
                   channels: int, interlace: int) -> np.ndarray:
    """Inflate and unfilter the image data, either one pass or the seven
    Adam7 passes (each its own filtered rows, empty passes absent)."""
    bits = channels * depth
    if interlace:
        passes = []
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx if width > x0 else 0
            ph = (height - y0 + dy - 1) // dy if height > y0 else 0
            if pw and ph:
                passes.append((x0, y0, dx, dy, pw, ph))
    else:
        passes = [(0, 0, 1, 1, width, height)]
    sizes = [ph * (1 + (pw * bits + 7) // 8) for *_, pw, ph in passes]
    need = sum(sizes)
    try:
        raw = zlib.decompressobj().decompress(z, need)
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from None
    if len(raw) < need:
        raise PngError("truncated image data")
    raw = np.frombuffer(raw, np.uint8)
    if not interlace:
        return _pixels(raw, width, height, depth, channels)
    out = np.empty((height, width, channels),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        out[y0::dy, x0::dx] = _pixels(raw[pos:pos + size], pw, ph, depth,
                                      channels)
        pos += size
    return out


def decode_png(data: bytes, transparency: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`.
    `transparency=False` ignores tRNS, as PIL does for a PNG inside an ICO
    (the icon's image takes the PNG's pixels and palette, not its info)."""
    (width, height, depth, ctype, _comp, filt, interlace), plte, trns, z = \
        _read_chunks(data)
    if not transparency:
        trns = None
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PngError(f"bit depth {depth} with colour type {ctype}")
    if filt:
        raise PngError("unknown filter method")
    if width == 0 or height == 0:
        raise PngError("empty image")
    from .identify import check_pixels

    check_pixels(width, height)
    px = _image_samples(z, width, height, depth, _CHANNELS[ctype], interlace)

    out = np.empty((height, width, 4), np.uint8)
    if ctype == 0:
        v = px[..., 0]
        if depth == 16:
            # PIL opens I;16, and convert("RGBA") clamps it to 0..255
            g = np.minimum(v, 255).astype(np.uint8)
        else:
            g = v * np.uint8(_GREY_SCALE[depth])
        out[..., :3] = g[..., None]
        out[..., 3] = 255
        if trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            if depth == 1:
                key = 255 if key else 0
            # PIL compares the 8-bit value with the key's low byte
            out[..., 3] = np.where(g == (key & 255), 0, 255)
        return out
    if ctype == 3:
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
        out[:] = lut[px[..., 0]]
        return out
    if depth == 16:
        px = (px >> 8).astype(np.uint8)   # PIL keeps the high byte
    if ctype == 2:
        out[..., :3] = px
        out[..., 3] = 255
        if trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">HHH", trns[:6])) & 255
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
    """(H, W) or (H, W, C) uint8 or uint16, C in 1-4 -> 8- or 16-bit PNG
    bytes (grey, grey + alpha, RGB or RGBA). `filters`: a row filter
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) or a sequence cycled over the
    rows. `idat_bytes` splits the compressed data into IDAT chunks of at
    most that size."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"encode_png takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"{c} channels")
    ctype = _COLOR_TYPE[c]
    depth = 8
    if img.dtype == np.uint16:
        # big-endian sample bytes; a pixel of 2c bytes filters as one
        img = img.astype(">u2").view(np.uint8).reshape(h, w, 2 * c)
        depth, c = 16, 2 * c
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
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, 0))
            + idat + _chunk(b"IEND", b""))
