"""Port parity: TIFF textures (`scene/tiff.py`, `csrc/tiff_decoder.cpp`)
against PIL 12.1.0's `Image.open(f).convert("RGBA")`, which reads TIFF
through its own raw decoder (compression 1) and libtiff 4.7.1 (the rest).

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises; NotImplementedError
only where a test allows it). PIL's writer blocks tiles and planar files,
so most files here come from `_tiff`, a writer of any layout: every mode of
the plugin's OPEN_INFO that a texture can be (bilevel, 2 / 4 / 8-bit grey
either way up, LA, P and PA, RGB, RGBX, RGBA associated or not, 16-bit
RGB(A), CMYK, I;16 both byte orders, I;16S, I;32, F) by raw, PackBits, LZW,
deflate and LZMA, in strips and tiles, contiguous and planar, with the
predictors, in both byte orders; JPEG-in-TIFF strips and tiles (YCbCr 1x1,
2x1, 2x2, with and without JPEGTables); YCbCr that is not JPEG at every
subsampling; every Orientation; BigTIFF; FillOrder 2; then the refusals,
the compressions that once raised NotImplementedError, LAB, a WebP-compressed file
(white in both bakes), a seeded cut-and-flip sweep, the committed fixtures
against their manifest, the city's writer, and the bake against JAX's.
Inputs are made from numpy seeds."""
import collections
import hashlib
import io
import json
import lzma
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import assets, identify, textures, tiff
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            port_rgba, uri)

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "tiff")


# ----------------------------------------------------------------------------
# a TIFF writer of any layout
# ----------------------------------------------------------------------------

def _lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes, a clear code first, the width growing one
    code early, a clear before the table fills, EOI last."""
    codes, nbits, nxt = [(256, 9)], 9, 258
    table = {bytes([i]): i for i in range(256)}
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], nbits))
        table[wc] = nxt
        nxt += 1
        if nxt in (512, 1024, 2048):
            nbits += 1
        if nxt == 4094:
            codes.append((256, nbits))
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([ch])
    if w:
        codes.append((table[w], nbits))
    codes.append((257, nbits))
    acc = n = 0
    out = bytearray()
    for code, nb in codes:
        acc, n = (acc << nb) | code, n + nb
        while n >= 8:
            out.append((acc >> (n - 8)) & 0xFF)
            n -= 8
    if n:
        out.append((acc << (8 - n)) & 0xFF)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        while j < n and j - i < 128 and not (j + 1 < n and
                                             data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _compress(raw: bytes, comp: int) -> bytes:
    return {1: lambda b: b, 5: _lzw, 8: zlib.compress, 32946: zlib.compress,
            32773: _packbits,
            34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ)}.get(
        comp, lambda b: b)(raw)


def _row(vals, bps, order, fmt):
    """One row of samples -> its bytes."""
    if bps < 8:
        bits = np.zeros(len(vals) * bps, np.uint8)
        for b in range(bps):
            bits[b::bps] = (vals >> (bps - 1 - b)) & 1
        return np.packbits(bits).tobytes()
    dt = {3: "f", 2: "i", 1: "u"}[fmt] + str(bps // 8)
    return np.asarray(vals).astype(order + dt).tobytes()


def _differenced(rows, bps, stride, order, predictor):
    """Rows (H, bytes) as the predictor writes them: horizontal
    differencing of samples (2), or of MSB-first byte planes (3)."""
    if predictor == 3:
        nb = bps // 8
        out = np.empty_like(rows)
        for r in range(rows.shape[0]):
            v = rows[r].reshape(-1, nb)
            planes = (v[:, ::-1] if order == "<" else v).T.reshape(-1)
            d = planes.astype(np.int16)
            d[stride:] = planes[stride:].astype(np.int16) - planes[:-stride]
            out[r] = d & 0xFF
        return out
    dt = np.dtype(order + {8: "u1", 16: "u2", 32: "u4"}[bps])
    v = rows.copy().view(dt).astype(np.int64)
    d = v.copy()
    d[:, stride:] = v[:, stride:] - v[:, :-stride]
    return (d & ((1 << bps) - 1)).astype(dt).view(np.uint8).reshape(
        rows.shape[0], -1)


def _tiff(samples, bps=8, *, order="<", photometric=1, compression=1,
          predictor=1, planar=1, tile=None, rows_per_strip=None,
          sample_format=1, extra=None, colormap=None, fillorder=None,
          orientation=None, bigtiff=False, tags=(), segments=None):
    """A TIFF of (H, W, S) sample values; `segments` replaces the encoded
    strips or tiles, `tags` adds (tag, type, values) entries."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, s = samples.shape
    rps = rows_per_strip or h
    planes = [samples[..., i:i + 1] for i in range(s)] if planar == 2 \
        else [samples]
    blocks = []
    for pl in planes:
        if tile:
            tw, th = tile
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    blk = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                    part = pl[y0:y0 + th, x0:x0 + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    blocks.append(blk)
        else:
            blocks += [pl[y0:y0 + rps] for y0 in range(0, h, rps)]
    blobs = []
    for blk in blocks:
        rows = np.stack([np.frombuffer(_row(blk[r].reshape(-1), bps, order,
                                            sample_format), np.uint8)
                         for r in range(blk.shape[0])])
        if predictor != 1:
            rows = _differenced(rows, bps, blk.shape[2], order, predictor)
        blob = _compress(rows.tobytes(), compression)
        if fillorder == 2 and compression != 1:
            blob = _REV[np.frombuffer(blob, np.uint8)].tobytes()
        blobs.append(blob)
    if segments is not None:
        blobs = segments
    head = 16 if bigtiff else 8
    body, offsets = bytearray(), []
    for b in blobs:
        offsets.append(head + len(body))
        body += b + b"\0" * (len(b) % 2)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * s),
         259: (3, [compression]), 262: (3, [photometric]), 277: (3, [s]),
         284: (3, [planar])}
    if tile:
        t.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                  324: (4, offsets), 325: (4, [len(b) for b in blobs])})
    else:
        t.update({273: (4, offsets), 278: (4, [rps]),
                  279: (4, [len(b) for b in blobs])})
    for tag, val in ((317, predictor if predictor != 1 else None),
                     (339, [sample_format] * s if sample_format != 1
                      else None),
                     (338, extra), (320, colormap), (266, fillorder),
                     (274, orientation)):
        if val is not None:
            t[tag] = (3, list(val) if isinstance(val, (list, tuple))
                      else [val])
    for tag, typ, vals in tags:
        t[tag] = (typ, vals)
    fmt = {1: "B", 2: "B", 3: "H", 4: "L", 7: "B", 16: "Q"}
    inline = 8 if bigtiff else 4
    ifd_off = head + len(body)
    ext_off = ifd_off + (8 if bigtiff else 2) + len(t) * (
        20 if bigtiff else 12) + (8 if bigtiff else 4)
    ents, ext = bytearray(), bytearray()
    for tag in sorted(t):
        typ, vals = t[tag]
        if isinstance(vals, (bytes, bytearray)):
            data = bytes(vals)
        elif typ == 5:
            data = b"".join(struct.pack(order + "LL", *v) for v in vals)
        else:
            data = struct.pack(order + fmt[typ] * len(vals), *vals)
        cnt = len(vals)
        if len(data) <= inline:
            field = data.ljust(inline, b"\0")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "L"),
                                ext_off + len(ext))
            ext += data + b"\0" * (len(data) % 2)
        ents += struct.pack(order + ("HHQ" if bigtiff else "HHL"), tag, typ,
                            cnt) + field
    magic = b"II" if order == "<" else b"MM"
    if bigtiff:
        hdr = magic + struct.pack(order + "HHHQ", 43, 8, 0, ifd_off)
        ifd = struct.pack(order + "Q", len(t)) + ents + bytes(8)
    else:
        hdr = magic + struct.pack(order + "HL", 42, ifd_off)
        ifd = struct.pack(order + "H", len(t)) + ents + bytes(4)
    return bytes(hdr + body + ifd + ext)


def _jpeg_segments(rgb, rows=None, tile=None, subsampling=2, tables=True):
    """JPEG strips or tiles of an RGB image from PIL's JPEG encoder; with
    `tables`, their DQT and DHT segments move into a JPEGTables stream."""
    h, w, _ = rgb.shape
    parts = []
    if tile:
        tw, th = tile
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                blk = np.zeros((th, tw, 3), np.uint8)
                p = rgb[y0:y0 + th, x0:x0 + tw]
                blk[:p.shape[0], :p.shape[1]] = p
                parts.append(blk)
    else:
        parts = [rgb[y0:y0 + (rows or h)] for y0 in range(0, h, rows or h)]
    segs = []
    for p in parts:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(p)).save(
            buf, "JPEG", quality=85, subsampling=subsampling)
        segs.append(buf.getvalue())
    if not tables:
        return segs, None
    out, tab = [], b""
    for j in segs:
        keep, i = bytearray(j[:2]), 2
        while i < len(j):
            m, n = j[i + 1], (j[i + 2] << 8) | j[i + 3]
            if m == 0xDA:
                keep += j[i:]
                break
            if m in (0xDB, 0xC4):
                tab = tab if len(out) else tab + j[i:i + 2 + n]
            else:
                keep += j[i:i + 2 + n]
            i += 2 + n
        out.append(bytes(keep))
    return out, b"\xff\xd8" + tab + b"\xff\xd9"


def _jpeg_tiff(rgb, rows=None, tile=None, subsampling=2, tables=True,
               photometric=6, order="<", orientation=None):
    segs, tab = _jpeg_segments(rgb, rows, tile, subsampling, tables)
    tags = [(530, 3, [(1, 1), (2, 1), (2, 2)][subsampling])] \
        if photometric == 6 else []
    if tab:
        tags.append((347, 7, tab))
    return _tiff(rgb, 8, order=order, photometric=photometric, compression=7,
                 rows_per_strip=rows, tile=tile, segments=segs, tags=tags,
                 orientation=orientation)


def _assert_as_pil_or_unported(data):
    """PIL's bytes, or an error where PIL raises, or NotImplementedError
    naming TIFF and ROADMAP.md; never pixels that differ. The outcome:
    "decoded", "refused" or "unported"."""
    try:
        assert_as_pil(data)
    except NotImplementedError as e:
        assert "ROADMAP" in str(e) and ("TIFF" in str(e) or
                                        "JPEG" in str(e)), e
        return "unported"
    return "refused" if pil_rgba(data) is None else "decoded"


# ----------------------------------------------------------------------------
# the matrix: mode x compression x layout x planar x byte order x predictor
# ----------------------------------------------------------------------------

_PAL = [int(v) for v in np.random.default_rng(5).integers(0, 65536, 768)]
MODES = {
    "1": dict(bps=1, photometric=1, s=1, top=1),
    "1;I": dict(bps=1, photometric=0, s=1, top=1),
    "L;2": dict(bps=2, photometric=1, s=1, top=3),
    "L;2I": dict(bps=2, photometric=0, s=1, top=3),
    "L;4": dict(bps=4, photometric=1, s=1, top=15),
    "L;4I": dict(bps=4, photometric=0, s=1, top=15),
    "L": dict(bps=8, photometric=1, s=1, top=255),
    "L;I": dict(bps=8, photometric=0, s=1, top=255),
    "LA": dict(bps=8, photometric=1, s=2, top=255, extra=[2]),
    "P;1": dict(bps=1, photometric=3, s=1, top=1, colormap=_PAL[:6]),
    "P;4": dict(bps=4, photometric=3, s=1, top=15, colormap=_PAL[:48]),
    "P": dict(bps=8, photometric=3, s=1, top=255, colormap=_PAL),
    "PA": dict(bps=8, photometric=3, s=2, top=255, colormap=_PAL,
               extra=[2]),
    "RGB": dict(bps=8, photometric=2, s=3, top=255),
    "RGBX": dict(bps=8, photometric=2, s=4, top=255, extra=[0]),
    "RGBa": dict(bps=8, photometric=2, s=4, top=255, extra=[1]),
    "RGBA": dict(bps=8, photometric=2, s=4, top=255, extra=[2]),
    "RGBA-no-extra": dict(bps=8, photometric=2, s=4, top=255),
    "RGB;16": dict(bps=16, photometric=2, s=3, top=65535),
    "RGBA;16": dict(bps=16, photometric=2, s=4, top=65535, extra=[2]),
    "RGBa;16": dict(bps=16, photometric=2, s=4, top=65535, extra=[1]),
    "CMYK": dict(bps=8, photometric=5, s=4, top=255),
    "CMYK;16": dict(bps=16, photometric=5, s=4, top=65535),
    "I;16": dict(bps=16, photometric=1, s=1, top=65535),
    "I;16-white": dict(bps=16, photometric=0, s=1, top=65535),
    "I;16S": dict(bps=16, photometric=1, s=1, top=600, sample_format=2),
    "I;32S": dict(bps=32, photometric=1, s=1, top=600, sample_format=2),
    "I;32": dict(bps=32, photometric=1, s=1, top=600),
    "F;32F": dict(bps=32, photometric=1, s=1, top=None, sample_format=3),
}
COMPRESSIONS = {"raw": 1, "packbits": 32773, "lzw": 5, "deflate": 8,
                "lzma": 34925}


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("mode", list(MODES))
def test_modes_compressions_layouts(mode, comp):
    """Each mode by each compression, in strips and in tiles, contiguous
    and planar, little- and big-endian, with each predictor libtiff applies
    to it (none on raw and PackBits; 2 on integer samples of 8 bits or
    more; 3 on floats): PIL's bytes, or its error (a planar layer PIL has
    no raw unpacker for, a 16-bit planar raw file it reads as 8 bits)."""
    kw = dict(MODES[mode])
    s, top = kw.pop("s"), kw.pop("top")
    code = COMPRESSIONS[comp]
    rng = np.random.default_rng(abs(hash((mode, comp))) % 2 ** 32)
    preds = [1]
    if code not in (1, 32773):
        if kw.get("sample_format") == 3:
            preds.append(3)
        elif kw["bps"] >= 8:
            preds.append(2)
    for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)}, {}):
        for planar in (1, 2):
            for order in "<>":
                for pred in preds:
                    h, w = (int(v) for v in rng.integers(3, 36, 2))
                    if top is None:
                        v = (rng.random((h, w, s)) * 400 - 50).astype(
                            np.float32)
                    else:
                        v = rng.integers(0, top + 1, (h, w, s))
                        if kw.get("sample_format") == 2:
                            v = v - 100
                    assert_as_pil(_tiff(v, order=order, compression=code,
                                        planar=planar, predictor=pred,
                                        **layout, **kw))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGB", "RGBA",
                                  "RGBX", "CMYK", "I;16", "I;16B", "I", "F"])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits",
                                         "tiff_adobe_deflate"])
def test_pil_written(mode, compression):
    """Every mode PIL saves as TIFF, raw and compressed, read back."""
    rng = np.random.default_rng(7)
    img = Image.fromarray(rng.integers(0, 256, (13, 21, 4), np.uint8),
                          "RGBA").convert(mode if mode not in ("RGBX",)
                                          else "RGB")
    if mode == "RGBX":
        img = img.convert("RGBX")
    if mode in ("I;16", "I;16B", "I", "F"):
        arr = rng.integers(0, 1000, (13, 21))
        img = Image.fromarray(arr.astype({"I;16": "<u2", "I;16B": ">u2",
                                          "I": "<i4", "F": "<f4"}[mode]),
                              mode if mode != "I;16B" else "I;16B")
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=compression)
    assert_as_pil(buf.getvalue(), must_decode=True)


def test_lab_raises_unported():
    """PIL converts LAB through LittleCMS, which the port now mirrors
    (`scene/lab.py`): the LAB TIFF PIL writes decodes to PIL's bytes, and
    raises NotImplementedError no more (the name is the test's earlier
    one)."""
    buf = io.BytesIO()
    Image.new("LAB", (5, 4), (50, 10, 200)).save(buf, "TIFF")
    want = pil_rgba(buf.getvalue())
    assert want is not None
    np.testing.assert_array_equal(tiff.decode_tiff(buf.getvalue()), want)


# ----------------------------------------------------------------------------
# JPEG, YCbCr, orientation, BigTIFF, fill order
# ----------------------------------------------------------------------------

def _picture(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([(7 * x) % 256, (5 * y) % 256, (3 * (x + y)) % 256], -1)
    return np.clip(rgb + rng.integers(-30, 30, rgb.shape), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("tables", [True, False], ids=["tables", "inline"])
@pytest.mark.parametrize("layout", ["strip", "strips", "tiles"])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["1x1", "2x1", "2x2"])
def test_jpeg_in_tiff(subsampling, layout, tables):
    """JPEG (7): each strip or tile its own stream after the JPEGTables,
    YCbCr converted by libjpeg with fancy upsampling inside the strip or
    tile; an RGB-coded one kept as coded."""
    rng = np.random.default_rng(40 + subsampling)
    for k in range(3):
        h, w = (int(v) for v in rng.integers(9, 60, 2))
        rgb = _picture(rng, h, w)
        lay = {"strip": {}, "strips": {"rows": 16},
               "tiles": {"tile": (16, 16)}}[layout]
        assert_as_pil(_jpeg_tiff(rgb, subsampling=subsampling, tables=tables,
                                 order="<>"[k % 2], **lay), must_decode=True)
    assert_as_pil(_jpeg_tiff(rgb, subsampling=0, photometric=2,
                             tables=tables), must_decode=True)


def _without_tables(stream):
    """A JPEG stream with its DQT and DHT segments taken out."""
    keep, i = bytearray(stream[:2]), 2
    while i < len(stream):
        m, n = stream[i + 1], (stream[i + 2] << 8) | stream[i + 3]
        if m == 0xDA:
            return bytes(keep + stream[i:])
        if m not in (0xDB, 0xC4):
            keep += stream[i:i + 2 + n]
        i += 2 + n
    return bytes(keep)


def test_jpeg_tables_carried_per_slot(monkeypatch):
    """48 JPEG strips, each even one with tables of its own quality and
    each odd one with none: an odd strip decodes with the tables its
    predecessor defined, as libtiff's one decompressor does, and each strip
    is decoded with the last table of each slot only, so the stream does
    not grow with the strips before it."""
    from kajiya_tpu_torch.scene import jpeg

    rgb = _picture(np.random.default_rng(47), 96, 24)
    segs = []
    for k in range(48):
        buf = io.BytesIO()
        Image.fromarray(rgb[2 * k:2 * k + 2]).save(
            buf, "JPEG", quality=20 + 3 * (k // 2), subsampling=0)
        segs.append(buf.getvalue() if k % 2 == 0
                    else _without_tables(buf.getvalue()))
    data = _tiff(rgb, 8, photometric=6, compression=7, rows_per_strip=2,
                 segments=segs, tags=[(530, 3, (1, 1))])
    lengths = []
    decode = jpeg.decode_jpeg_stream

    def recorded(stream, color):
        lengths.append(len(stream))
        return decode(stream, color)

    monkeypatch.setattr(jpeg, "decode_jpeg_stream", recorded)
    assert_as_pil(data, must_decode=True)
    assert len(lengths) == 48
    assert max(lengths) < max(len(s) for s in segs) + 1000


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                 (4, 2), (4, 4)])
def test_ycbcr_not_jpeg(sub):
    """YCbCr that is not JPEG: libtiff's TIFFRGBAImage (tif_color.c's
    integer tables, ReferenceBlackWhite and YCbCrCoefficients, the
    subsampling blocks), by LZW, deflate, PackBits and raw (PIL cannot read
    the raw one: it bakes white in both)."""
    hs, vs = sub
    rng = np.random.default_rng(hs * 10 + vs)
    for k, comp in enumerate((5, 8, 32773, 1)):
        h, w = (int(v) for v in rng.integers(4, 40, 2))
        rps = vs * int(rng.integers(1, 4))
        if (-(-w // hs) * (hs * vs + 2)) % vs:
            w = hs * 2
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cb = rng.integers(0, 256, (-(-h // vs), -(-w // hs))).astype(
            np.uint8)
        cr = rng.integers(0, 256, cb.shape).astype(np.uint8)
        segs = []
        for y0 in range(0, h, rps):
            rows = y[y0:y0 + rps]
            bh, bw = -(-rows.shape[0] // vs), -(-w // hs)
            yp = np.zeros((bh * vs, bw * hs), np.uint8)
            yp[:rows.shape[0], :w] = rows
            yb = yp.reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(
                bh, bw, -1)
            c0 = y0 // vs
            blk = np.concatenate([yb, cb[c0:c0 + bh, :, None],
                                  cr[c0:c0 + bh, :, None]], -1)
            segs.append(_compress(blk.tobytes(), comp))
        tags = [(530, 3, [hs, vs])]
        if k % 2:
            tags.append((532, 5, [(15, 1), (235, 1), (128, 1), (240, 1),
                                  (128, 1), (240, 1)]))
        if k == 2:
            tags.append((529, 5, [(2126, 10000), (7152, 10000),
                                  (722, 10000)]))
        assert_as_pil(_tiff(np.zeros((h, w, 3), np.uint8), photometric=6,
                            compression=comp, rows_per_strip=rps,
                            segments=segs, tags=tags,
                            orientation=k + 1 if k else None))


def test_ycbcr_saved_by_pil():
    """PIL's YCbCr TIFFs: LZW of (0, 1, 2) reads back as (0, 1, 0), as
    libtiff converts it; JPEG and raw as PIL reads them."""
    im = Image.new("RGB", (1, 1), (0, 1, 2)).convert("YCbCr")
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression="tiff_lzw")
    assert tuple(tiff.decode_tiff(buf.getvalue())[0, 0]) == (0, 1, 0, 255)
    for comp in ("tiff_lzw", "jpeg", "raw"):
        assert_as_pil(_pil_saved_ycbcr(comp), must_decode=comp != "raw")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(orientation):
    """exif_transpose of each Orientation, on both routes (the size swaps
    for 5-8), and a YCbCr file whose libtiff reader leaves it alone."""
    rng = np.random.default_rng(orientation)
    v = rng.integers(0, 256, (7, 11, 3))
    for comp in (1, 5):
        data = _tiff(v, photometric=2, compression=comp,
                     orientation=orientation)
        assert_as_pil(data, must_decode=True)
        assert port_rgba(data).shape[:2] == ((11, 7) if orientation >= 5
                                             else (7, 11))
    assert_as_pil(_jpeg_tiff(_picture(rng, 20, 30), rows=8,
                             orientation=orientation), must_decode=True)


@pytest.mark.parametrize("order", "<>")
def test_bigtiff_and_fill_order(order):
    """BigTIFF headers and 8-byte entries (PIL takes a big-endian BigTIFF
    header, "MM\\0+", for a classic one, and refuses it; so does the
    port); FillOrder 2, which the raw route unpacks with the reversed raw
    modes and libtiff undoes before decoding."""
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (9, 13, 3))
    for comp in (1, 5, 8, 34925):
        assert_as_pil(_tiff(rgb, photometric=2, compression=comp,
                            bigtiff=True, order=order),
                      must_decode=order == "<")
    for bps, top in ((1, 1), (4, 15), (8, 255)):
        v = rng.integers(0, top + 1, (9, 13))
        for comp in (1, 5, 32773):
            assert_as_pil(_tiff(v, bps, compression=comp, fillorder=2,
                                order=order))


def test_lzw_compat_and_large_tables():
    """LZW past 4096 codes (clear codes mid-strip, all code widths), and
    the old bit-reversed LZW codes libtiff still decodes."""
    rng = np.random.default_rng(12)
    big = rng.integers(0, 256, (64, 96, 3)) // 4 * 4
    assert_as_pil(_tiff(big, photometric=2, compression=5),
                  must_decode=True)
    # old-style: LSB-first codes, the width growing at the table's mask
    data = bytes(rng.integers(0, 256, 600).astype(np.uint8) // 64)
    codes, nbits, nxt, w = [(256, 9)], 9, 258, b""
    table = {bytes([i]): i for i in range(256)}
    for ch in data:
        if w + bytes([ch]) in table:
            w += bytes([ch])
            continue
        codes.append((table[w], nbits))
        table[w + bytes([ch])] = nxt
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        w = bytes([ch])
    codes += [(table[w], nbits), (257, nbits)]
    acc = n = 0
    out = bytearray()
    for code, nb in codes:
        acc |= code << n
        n += nb
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8
    out.append(acc & 0xFF)
    assert out[0] == 0 and out[1] & 1
    img = np.frombuffer(data, np.uint8).reshape(20, 30)
    assert_as_pil(_tiff(img, compression=5, segments=[bytes(out)]),
                  must_decode=True)


# ----------------------------------------------------------------------------
# refusals, white files and NotImplementedError
# ----------------------------------------------------------------------------

def _base(**kw):
    return _tiff(np.zeros((4, 5, 3), np.uint8), photometric=2, **kw)


REFUSED = {
    "unknown compression": lambda: _base(compression=32766),
    "unknown pixel mode": lambda: _tiff(np.zeros((4, 5, 2), np.uint8),
                                        photometric=2),
    "samples per pixel": lambda: _base(tags=[(277, 3, [7])]),
    "data organization": lambda: _tiff(np.zeros((4, 5, 3), np.uint8),
                                       photometric=2,
                                       tags=[(258, 3, [8, 8])]),
    "missing width": lambda: _entry(_base(), 256),
    "no offsets": lambda: _entry(_base(), 273),
}
WHITE = {
    "invalid dimensions": lambda: _base(tags=[(256, 5, [(5, 1)])]),
    "windows media photo": lambda: _base(tags=[(0xBC01, 3, [1])]),
    "truncated raw": lambda: _entry(_base(), 273, lambda d: len(d) - 10),
    "webp compression": lambda: _base(compression=50001),
    "raw ycbcr": lambda: _pil_saved_ycbcr("raw"),
    "rows per strip from 2^31": lambda: _entry(_base(compression=8), 278,
                                               lambda d: 3_000_000_000),
}


def _entry(data, tag, value=None):
    """The file with one IFD entry changed: its value set to value(data),
    or (value None) its tag renumbered to an unused one."""
    out = bytearray(data)
    ifd = struct.unpack_from("<L", out, 4)[0]
    n = struct.unpack_from("<H", out, ifd)[0]
    for k in range(n):
        e = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, e)[0] == tag:
            if value is None:
                struct.pack_into("<H", out, e, 65000)
            else:
                struct.pack_into("<L", out, e + 8, value(data))
    return bytes(out)


def _pil_saved_ycbcr(compression):
    """A YCbCr TIFF as PIL writes it (its data after the directory)."""
    buf = io.BytesIO()
    Image.fromarray(_picture(np.random.default_rng(3), 23, 31)).convert(
        "YCbCr").save(buf, "TIFF", compression=compression)
    return buf.getvalue()


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_as_pil(case):
    """Files `TiffImageFile._open` refuses (SyntaxError, TypeError,
    KeyError): the port raises `identify.Refused`, so the walk moves on,
    and both bakes turn them white."""
    data = REFUSED[case]()
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data))
    with pytest.raises(identify.Refused):
        tiff.decode_tiff(data)
    assert_as_pil(data)


@pytest.mark.parametrize("rps", [4, 5, 2 ** 28 + 7, 2 ** 31 - 1, 2 ** 31,
                                 3_000_000_000, 2 ** 32 - 2, 2 ** 32 - 1])
@pytest.mark.parametrize("compression", [1, 8])
def test_rows_per_strip_as_pil(compression, rps):
    """RowsPerStrip at the image's height, past it, and around the signed
    and unsigned 32-bit limits: PIL's raw route takes any value, and
    TiffDecode.c fails from 2^31 up to the 2^32 - 1 that means one strip."""
    data = _entry(_tiff(np.random.default_rng(9).integers(0, 256, (4, 5, 3)),
                        photometric=2, compression=compression), 278,
                  lambda d: rps)
    assert_as_pil(data)


@pytest.mark.parametrize("case", list(WHITE))
def test_white_as_pil(case):
    """Files PIL opens or fails to load (an "Invalid dimensions"
    ValueError, a Windows Media Photo OSError, a truncated strip, WebP
    compression that PIL's libtiff has no codec for, a raw YCbCr file it
    reads as RGBX, a RowsPerStrip that TiffDecode.c's signed int
    overflows): a decode error, not a refusal, and white in both
    bakes."""
    data = WHITE[case]()
    assert pil_rgba(data) is None
    with pytest.raises(ValueError) as e:
        tiff.decode_tiff(data)
    assert not isinstance(e.value, identify.Refused)
    assert_bake_white_in_both(data)


def assert_bake_white_in_both(data):
    from kajiya_tpu.scene import textures as tex_j

    atlas_t, sub_t = textures.bake_texture_pages([uri(data)])
    atlas_j, sub_j = tex_j.build_texture_pages([uri(data)])
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    page, size, ox, oy = sub_t[1]
    assert (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


@pytest.mark.parametrize("code", [2, 3, 4, 6, 32771, 32809, 34676, 34677,
                                  50000])
def test_unported_compressions_raise(code):
    """The compressions that once raised NotImplementedError (CCITT RLE /
    G3 / G4, old-style JPEG, tiff_raw_16, ThunderScan, SGILog and zstd),
    each on the file this test has always made: PIL's outcome, never
    NotImplementedError. PIL decodes the CCITT ones; the others get an
    8-bit 4 x 5 grey strip of zeros as their data."""
    if code in (2, 3, 4):
        buf = io.BytesIO()
        img = np.random.default_rng(code).random((12, 20)) > 0.5
        Image.fromarray(img).save(buf, "TIFF", compression={
            2: "tiff_ccitt", 3: "group3", 4: "group4"}[code])
        data = buf.getvalue()
        assert pil_rgba(data) is not None
    else:
        data = _tiff(np.zeros((4, 5), np.uint8), compression=code)
    assert_as_pil(data)
    if pil_rgba(data) is None:
        assert_bake_white_in_both(data)


# ----------------------------------------------------------------------------
# the cut-and-flip sweep
# ----------------------------------------------------------------------------

def _fuzz_base(k):
    r = np.random.default_rng(k)
    h, w = (int(v) for v in r.integers(4, 40, 2))
    comp = (1, 5, 8, 32773, 34925)[k % 5]
    lay = ({}, {"rows_per_strip": int(r.integers(1, 8))},
           {"tile": (16, 16)})[k % 3]
    order = "<>"[k % 2]
    kind = k % 9
    if kind == 8:
        return _jpeg_tiff(r.integers(0, 256, (h, w, 3)).astype(np.uint8),
                          rows=lay.get("rows_per_strip"),
                          tile=lay.get("tile"), subsampling=k % 3,
                          tables=k % 2 == 0, order=order)
    v, kw = [
        (r.integers(0, 256, (h, w, 3)), dict(photometric=2)),
        (r.integers(0, 256, (h, w, 4)), dict(photometric=2, extra=[2])),
        (r.integers(0, 256, (h, w, 1)), dict(photometric=1)),
        (r.integers(0, 65536, (h, w, 3)), dict(photometric=2, bps=16)),
        (r.integers(0, 256, (h, w, 1)), dict(photometric=3,
                                             colormap=_PAL)),
        (r.integers(0, 2, (h, w, 1)), dict(photometric=0, bps=1)),
        ((r.random((h, w, 1)) * 300).astype(np.float32),
         dict(photometric=1, bps=32, sample_format=3)),
        (r.integers(0, 256, (h, w, 4)), dict(photometric=5))][kind]
    pred = 1
    if comp in (5, 8, 34925) and k % 4 == 1:
        pred = 3 if kind == 6 else 2 if kw.get("bps", 8) >= 8 else 1
    return _tiff(v, order=order, compression=comp, predictor=pred,
                 planar=2 if k % 7 == 3 else 1,
                 orientation=(k % 8) + 1 if k % 5 == 2 else None,
                 bigtiff=k % 11 == 0, **lay, **kw)


# the sweep's files that raise NotImplementedError, by case: no change may
# send more of them there (PERF.md gives the outcomes)
CUT_UNPORTED = (8, 4, 3, 3, 6, 4)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a case) over every layout and
    codec above: PIL's bytes, PIL's error, or NotImplementedError where
    libtiff's outcome is not modelled; never pixels that differ."""
    rng = np.random.default_rng(1700 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base((50 * part + t) % 53))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[_assert_as_pil_or_unported(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


# ----------------------------------------------------------------------------
# the writer, the fixtures and the bake
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["lzw-tiles", "deflate-planar",
                                    "packbits-16-be", "raw-orientation"])
def test_writer_decodes_to_its_texels(layout):
    """`tiff.write_tiff` in each layout of the TIFF-textured city's maps:
    PIL and the port both decode it to the texels the city's writer
    reports."""
    rng = np.random.default_rng(31)
    img = (rng.integers(0, 256, (45, 70, 3)) // 16 * 16).astype(np.uint8)
    data = {"lzw-tiles": lambda: tiff.write_tiff(
                img, compression=5, predictor=2, tile=(32, 16)),
            "deflate-planar": lambda: tiff.write_tiff(
                img, compression=8, planar=2, rows_per_strip=8),
            "packbits-16-be": lambda: tiff.write_tiff(
                img.astype(np.uint16) * 257, compression=32773, order=">"),
            "raw-orientation": lambda: tiff.write_tiff(
                np.ascontiguousarray(np.rot90(img, 1)), orientation=6)}[
        layout]()
    want = np.concatenate([img, np.full((45, 70, 1), 255, np.uint8)], -1)
    np.testing.assert_array_equal(pil_rgba(data), want)
    np.testing.assert_array_equal(port_rgba(data), want)


def test_city_maps_decode_to_their_texels(tmp_path):
    """The TIFF-textured city's maps (`assets.write_city_assets(...,
    formats="tiff")`) decode, in PIL and in the port, to the texels their
    writer reports."""
    written = assets.write_city_assets(str(tmp_path), map_size=64,
                                       emissive_size=32, ground_size=(8, 16),
                                       formats="tiff")
    assert len(written) == 10
    for name, (img, want) in written.items():
        with open(tmp_path / "meshes" / name, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(pil_rgba(data), want)
        np.testing.assert_array_equal(port_rgba(data), want)


def test_fixtures_match_manifest():
    """The committed fixtures decode, in PIL and in the port, to the RGBA
    digests of `manifest.json` (which `chip_smoke.py` checks on the card's
    host, where there is no PIL)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == {"jpeg_ycbcr22.tif", "lzma.tif",
                             "float_predictor.tif", "cmyk.tif", "lab.tif",
                             "bigtiff.tif", "tiled.tif", "g3_1d.tif",
                             "g3_2d.tif", "g4.tif", "rle.tif", "zstd.tif",
                             "rlew.tif", "thunderscan.tif",
                             "ojpeg_420.tif", "ojpeg_444.tif",
                             "sgilog.tif"}
    total = 0
    for name, rec in manifest.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        assert len(data) == rec["bytes"]
        want = pil_rgba(data)
        if rec.get("white"):
            # PIL fails to load it; the port raises what the bake whitens
            assert want is None and rec["rgba_sha256"] is None, name
            with pytest.raises(ValueError):
                tiff.decode_tiff(data)
            continue
        assert hashlib.sha256(want.tobytes()).hexdigest() == \
            rec["rgba_sha256"], name
        if rec.get("unported"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tiff.decode_tiff(data)
            continue
        got = tiff.decode_tiff(data)
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            rec["rgba_sha256"], name
    assert total < 300_000


def test_bake_matches_jax():
    """TIFF sources through both packages' bakes (decode, Lanczos resize,
    pages): equal atlases."""
    rng = np.random.default_rng(33)
    rgb = _picture(rng, 40, 56)
    rgba = rng.integers(0, 256, (30, 20, 4))
    assert_bake_matches_jax([
        _tiff(rgb, photometric=2, compression=5, predictor=2,
              tile=(16, 16)),
        _tiff(rgba, photometric=2, extra=[2], compression=8, planar=2),
        _jpeg_tiff(rgb, rows=16),
        _tiff(rgb.astype(np.uint16) * 257, 16, photometric=2,
              compression=32773, order=">", orientation=6)])
