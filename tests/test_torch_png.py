"""The port's PNG decoder and encoder (`kajiya_tpu_torch/scene/png.py`)
against PIL, which the JAX package decodes textures with: every supported
colour type and bit depth, each row filter and a mix of them, image data
over several IDAT chunks, tRNS, 16-bit samples, Adam7 interlacing, and
corrupt or unsupported files. Tolerance: byte for byte (PIL's `Image.open(...).convert("RGBA")`)."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import textures
from kajiya_tpu_torch.scene.png import (PNG_SIGNATURE, PngError, decode_png,
                                        encode_png)

W, H = 13, 11          # odd sizes: partial bytes at depths 1, 2 and 4
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (6, 8)]
FILTERS = [0, 1, 2, 3, 4, "mixed"]


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(row, prev, bpp, f):
    """The PNG row filter `f` of one row of bytes, byte by byte."""
    out = bytearray(len(row))
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
        out[x] = (row[x] - pred) & 255
    return bytes(out)


def raw_png(samples, depth, ctype, filters=0, plte=None, trns=None,
            idat_bytes=None, interlace=0):
    """A PNG of (H, W, C) integer samples at any depth, written sample by
    sample (independent of the port's encoder)."""
    h, w, c = samples.shape
    bits = c * depth
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    rows, prev = [], bytes(stride)
    for r in range(h):
        flat = samples[r].reshape(-1).astype(np.int64)
        if depth < 8:
            acc = bytearray(stride)
            for i, s in enumerate(flat):
                acc[i * depth // 8] |= int(s) << (8 - depth - i * depth % 8)
            row = bytes(acc)
        elif depth == 8:
            row = flat.astype(np.uint8).tobytes()
        else:
            row = flat.astype(">u2").tobytes()
        f = filters[r % len(filters)] if isinstance(filters, tuple) \
            else filters
        rows.append(bytes([f]) + _filter_row(row, prev, bpp, f))
        prev = row
    z = zlib.compress(b"".join(rows), 9)
    step = idat_bytes or len(z)
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for i in range(0, len(z), step):
        out += _chunk(b"IDAT", z[i:i + step])
    return out + _chunk(b"IEND", b"")


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _samples(rng, ctype, depth, n_pal=None):
    hi = (n_pal or 256) if ctype == 3 else 1 << depth
    return rng.integers(0, min(hi, 1 << depth),
                        (H, W, CHANNELS[ctype]))


@pytest.mark.parametrize("filt", FILTERS, ids=str)
@pytest.mark.parametrize("ctype,depth", FORMATS)
def test_decode_matches_pil(ctype, depth, filt):
    rng = np.random.default_rng(ctype * 100 + depth)
    plte = None
    if ctype == 3:
        plte = rng.integers(0, 256, 3 * (1 << depth), dtype=np.uint8).tobytes()
    filters = (0, 1, 2, 3, 4) if filt == "mixed" else filt
    data = raw_png(_samples(rng, ctype, depth), depth, ctype, filters,
                   plte=plte, idat_bytes=23)
    np.testing.assert_array_equal(decode_png(data), _pil(data))


@pytest.mark.parametrize("ctype,depth,trns", [
    (0, 8, struct.pack(">H", 77)),
    (0, 1, struct.pack(">H", 1)),
    (0, 1, struct.pack(">H", 0)),
    (0, 2, struct.pack(">H", 0)),
    (0, 2, struct.pack(">H", 2)),     # PIL compares with the scaled value
    (0, 4, struct.pack(">H", 5)),
    (2, 8, struct.pack(">HHH", 3, 1, 2)),
    (3, 8, bytes([0, 128, 255, 7])),  # per-entry alpha, the rest opaque
    (3, 4, bytes([255, 255, 0, 255])),  # one transparent entry
    (3, 2, bytes([255, 255])),
])
def test_transparency_matches_pil(ctype, depth, trns):
    rng = np.random.default_rng(7)
    s = rng.integers(0, min(4, 1 << depth), (H, W, CHANNELS[ctype]))
    if (ctype, depth) == (0, 8):
        s[::2, ::3] = 77
    plte = None
    if ctype == 3:
        plte = rng.integers(0, 256, 3 * (1 << depth),
                            dtype=np.uint8).tobytes()
    data = raw_png(s, depth, ctype, (0, 1, 2, 3, 4), plte=plte, trns=trns)
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("plte", [bytes(range(9)), None])
def test_palette_index_past_plte_matches_pil(plte):
    """Indices past the PLTE entries (all of them without a PLTE chunk)
    read PIL's padding of the palette: black, opaque past tRNS."""
    s = np.arange(H * W).reshape(H, W, 1) % 8
    data = raw_png(s, 8, 3, 0, plte=plte, trns=bytes([9, 99]))
    np.testing.assert_array_equal(decode_png(data), _pil(data))


def test_idat_checksum_not_verified_as_pil():
    """PIL reads the image data without its checksum; so does the port,
    while a bad checksum before it fails both."""
    rng = np.random.default_rng(1)
    data = bytearray(raw_png(_samples(rng, 2, 8), 8, 2, 4))
    i = data.index(b"IDAT")
    n = struct.unpack(">I", data[i - 4:i])[0]
    data[i + 4 + n] ^= 0xFF
    np.testing.assert_array_equal(decode_png(bytes(data)), _pil(bytes(data)))
    bad = bytearray(raw_png(_samples(rng, 2, 8), 8, 2, 4))
    bad[29] ^= 0xFF                       # the IHDR checksum
    with pytest.raises(PngError, match="checksum"):
        decode_png(bytes(bad))
    with pytest.raises(OSError):          # PIL: cannot identify image file
        _pil(bytes(bad))


@pytest.mark.parametrize("case", ["zlib", "truncated", "filter",
                                  "signature", "no_idat"])
def test_corrupt_data_raises(case):
    rng = np.random.default_rng(2)
    s = _samples(rng, 6, 8)
    if case == "zlib":
        # a zlib header whose check bits fail
        data = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, H, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", b"\x78\x00" + bytes(64))
            + _chunk(b"IEND", b""))
    elif case == "truncated":
        z = zlib.compress(b"\0" * 10)
        data = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, H, 8, 6, 0, 0, 0)) + _chunk(b"IDAT", z)
            + _chunk(b"IEND", b""))
    elif case == "filter":
        rows = b"".join(b"\x07" + bytes(4 * W) for _ in range(H))
        data = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, H, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))
    elif case == "signature":
        data = b"\x89PNX" + raw_png(s, 8, 6, 0)[4:]
    else:
        data = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, H, 8, 6, 0, 0, 0)) + _chunk(b"IEND", b"")
    with pytest.raises(PngError):
        decode_png(data)
    with pytest.raises((OSError, SyntaxError, ValueError)):
        _pil(data)


@pytest.mark.parametrize("case", ["grey16", "rgb16", "rgba16", "interlaced"])
def test_unported_png_raises(case):
    """16-bit samples and Adam7 interlacing, which the decoder once refused,
    now decode to PIL's bytes, directly and through the bake (never a
    NotImplementedError, never a white texture)."""
    rng = np.random.default_rng(4)
    ctype, depth, interlace = {"grey16": (0, 16, 0), "rgb16": (2, 16, 0),
                               "rgba16": (6, 16, 0),
                               "interlaced": (2, 8, 1)}[case]
    samples = rng.integers(0, 1 << depth, (H, W, CHANNELS[ctype]))
    data = (adam7_png(samples, depth, ctype) if interlace
            else raw_png(samples, depth, ctype, 0))
    np.testing.assert_array_equal(decode_png(data), _pil(data))
    atlas, sub = textures.bake_texture_pages(
        ["data:image/png;base64," + __import__("base64").b64encode(
            data).decode()])
    page, size, ox, oy = sub[1]
    want = np.asarray(Image.fromarray(_pil(data)).resize((128, 128),
                                                         Image.LANCZOS))
    np.testing.assert_array_equal(atlas[page, oy:oy + size, ox:ox + size],
                                  want)


def adam7_png(samples, depth, ctype, plte=None, trns=None):
    """An Adam7-interlaced PNG of (H, W, C) samples: each pass's sub-image
    filtered and packed as raw_png packs a whole image (filters cycled per
    row), the passes' rows concatenated into one zlib stream."""
    h, w, _ = samples.shape
    passes = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        one = raw_png(sub, depth, ctype, filters=(0, 1, 2, 3, 4))
        i = one.index(b"IDAT")
        n = struct.unpack(">I", one[i - 4:i])[0]
        passes.append(zlib.decompress(one[i + 4:i + 4 + n]))
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(b"".join(passes)))
            + _chunk(b"IEND", b""))


ALL_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
               (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
               (6, 16)]


@pytest.mark.parametrize("ctype,depth", ALL_FORMATS,
                         ids=[f"c{c}d{d}" for c, d in ALL_FORMATS])
@pytest.mark.parametrize("size", [(1, 1), (5, 3), (11, 13), (17, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_adam7_matches_pil(ctype, depth, size):
    """Adam7 at every colour type and depth, at sizes where some passes are
    empty (1x1, 5x3) or partial: PIL's bytes."""
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = size
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
    plte = (rng.integers(0, 256, 3 << depth, dtype=np.uint8).tobytes()
            if ctype == 3 else None)
    data = adam7_png(samples, depth, ctype, plte=plte)
    np.testing.assert_array_equal(decode_png(data), _pil(data))
    flat = raw_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4), plte=plte)
    np.testing.assert_array_equal(decode_png(data), decode_png(flat))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("filt", FILTERS, ids=str)
def test_16bit_matches_pil(ctype, filt):
    """16-bit samples as PIL reads them: colour types 2, 4 and 6 keep the
    high byte; grey opens as I;16 and convert("RGBA") clamps it (0x1234 ->
    255, 0x0080 -> 128). The samples hold values below 256 too, so the
    clamp and the high byte both show."""
    rng = np.random.default_rng(ctype + 40)
    s = rng.integers(0, 1 << 16, (H, W, CHANNELS[ctype]))
    s[::2] >>= 8                      # every other row below 256
    filters = (0, 1, 2, 3, 4) if filt == "mixed" else filt
    data = raw_png(s, 16, ctype, filters)
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pil(data))
    if ctype == 0:
        np.testing.assert_array_equal(got[..., 0], np.minimum(s[..., 0], 255))
    else:
        np.testing.assert_array_equal(got[..., 0], s[..., 0] >> 8)


@pytest.mark.parametrize("case", ["grey16_low", "grey16_clamped",
                                  "grey16_high", "rgb16_high_bytes",
                                  "rgb16_full_key", "rgb16_low_bytes",
                                  "grey8_wide_key", "adam7_rgb"])
def test_16bit_transparency_matches_pil(case):
    """tRNS at 16 bits, as PIL reads it: the key's low byte against the
    converted 8-bit value (the clamped grey, the RGB high bytes)."""
    grey = np.array([[[0x1234], [0x0080], [0x00FF], [0x0100], [0x0034],
                      [0xFFFF]]])
    rgb = np.array([[[0x1234, 0x0012, 0x0056], [0x1200, 0x3400, 0x5600],
                     [0x12, 0x34, 0x56], [0x1234, 0x3456, 0x5678]]])
    ctype, depth, s, key = {
        "grey16_low": (0, 16, grey, (0x0080,)),
        "grey16_clamped": (0, 16, grey, (0x00FF,)),
        "grey16_high": (0, 16, grey, (0x0034,)),
        "rgb16_high_bytes": (2, 16, rgb, (0x12, 0x34, 0x56)),
        "rgb16_full_key": (2, 16, rgb, (0x1234, 0x3456, 0x5678)),
        "rgb16_low_bytes": (2, 16, rgb, (0x1200, 0x3400, 0x5600)),
        "grey8_wide_key": (0, 8, np.array([[[0x12], [0x34]]]), (0x134,)),
        "adam7_rgb": (2, 16, np.tile(rgb, (5, 3, 1)), (0x12, 0x34, 0x56)),
    }[case]
    trns = struct.pack(f">{len(key)}H", *key)
    data = (adam7_png(s, depth, ctype, trns=trns) if case.startswith("adam7")
            else raw_png(s, depth, ctype, trns=trns))
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pil(data))
    assert (got[..., 3] == 0).any() != (case == "rgb16_full_key")


@pytest.mark.parametrize("head", [b"\xff\xd8\xff\xe0\0\x10JFIF\0",
                                  b"DDS |\0\0\0", b"GIF89a\x01\0",
                                  b"BM\x36\0\0\0", b"RIFF\0\0\0\0WEBPVP8 ",
                                  b"II*\0\x08\0\0\0"])
def test_undecoded_formats_raise(tmp_path, head):
    """A JPEG, DDS, GIF, BMP, WebP or TIFF head followed by zeros is a
    corrupt file PIL refuses (the TIFF's directory holds no entry, so its
    `_open` finds no dimensions): the bake turns it white, as the JAX
    package's does."""
    p = tmp_path / "img.bin"
    p.write_bytes(head + b"\0" * 64)
    with pytest.raises(Exception):
        _pil(p.read_bytes())
    atlas, sub = textures.bake_texture_pages([str(p)])
    page, size, ox, oy = sub[1]
    assert (atlas[page, oy:oy + size, ox:ox + size] == 255).all()


@pytest.mark.parametrize("tail", ["no_iend", "cut_iend", "cut_crc",
                                  "cut_adler", "cut_rows", "text_after",
                                  "cut_text_after", "garbage_after"])
def test_cut_after_image_data_as_pil(tail):
    """A file cut after its image data: PIL reads the image data as far as
    the file holds it and stops once the rows are done, so a missing IEND,
    a cut checksum or a cut end of the zlib stream still decodes; a chunk
    after the image data that the file cuts short, or rows the data lacks,
    raise (white in both bakes). Tolerance: exact."""
    rng = np.random.default_rng(len(tail))
    px = rng.integers(0, 256, (9, 11, 3), np.uint8)
    data = raw_png(px, 8, 2, idat_bytes=120)
    end = len(data) - 12                         # where IEND starts
    text = _chunk(b"tEXt", b"Comment\0kajiya")
    data = {
        "no_iend": data[:end],
        "cut_iend": data[:end + 6],
        "cut_crc": data[:end - 2],
        "cut_adler": data[:end - 6],
        "cut_rows": data[:end - 40],
        "text_after": data[:end] + text + data[end:],
        "cut_text_after": data[:end] + text[:-6],
        "garbage_after": data[:end] + b"\x01\x02\x03\x04\x05\x06\x07\x08",
    }[tail]
    try:
        want = _pil(data)
    except Exception:
        with pytest.raises(PngError):
            decode_png(data)
        assert tail in ("cut_rows", "cut_text_after")
        return
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filt", FILTERS, ids=str)
def test_encoder_roundtrip_through_pil(channels, filt):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (H, W, channels), dtype=np.uint8)
    filters = (0, 1, 2, 3, 4) if filt == "mixed" else filt
    data = encode_png(img, filters=filters, idat_bytes=31)
    assert data.count(b"IDAT") > 1
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    np.testing.assert_array_equal(decode_png(data), _pil(data))
    raw = zlib.decompress(b"".join(
        data[i + 4:i + 4 + struct.unpack(">I", data[i - 4:i])[0]]
        for i in range(len(data)) if data[i:i + 4] == b"IDAT"))
    got = np.frombuffer(raw, np.uint8).reshape(H, -1)[:, 0]
    want = np.resize(np.atleast_1d(filters), H)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encoder_16bit_roundtrip_through_pil(channels):
    """uint16 images encode as 16-bit PNGs (the mixed-format city's
    emissive map): PIL reads back the high bytes, the port's decoder gives
    PIL's bytes, and the raw samples survive the row filters."""
    rng = np.random.default_rng(channels + 20)
    img = rng.integers(0, 1 << 16, (H, W, channels), dtype=np.uint16)
    data = encode_png(img, filters=(0, 1, 2, 3, 4), idat_bytes=31)
    assert data[24] == 16
    np.testing.assert_array_equal(decode_png(data), _pil(data))
    z = zlib.decompress(b"".join(
        data[i + 4:i + 4 + struct.unpack(">I", data[i - 4:i])[0]]
        for i in range(len(data)) if data[i:i + 4] == b"IDAT"))
    assert len(z) == H * (1 + W * channels * 2)
    if channels in (2, 4):          # alpha: the last sample's high byte
        np.testing.assert_array_equal(_pil(data)[..., 3], img[..., -1] >> 8)


def test_decode_large_mixed_filters_is_fast():
    """A 512^2 RGBA image with all five filters decodes exactly and in well
    under a second a megapixel (the bake's budget)."""
    import time

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (512, 512, 4), dtype=np.uint8)
    data = encode_png(img, filters=(0, 1, 2, 3, 4))
    t0 = time.perf_counter()
    out = decode_png(data)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(out, img)
    assert dt < 5.0, dt
