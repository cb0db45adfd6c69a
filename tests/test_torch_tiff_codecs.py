"""Port parity: TIFF's CCITT (RLE, RLEW, Group 3, Group 4), zstd,
ThunderScan, old-style JPEG and SGILog compressions (`scene/tiff.py`,
`csrc/tiff_decoder.cpp`, `csrc/zstd_decoder.cpp`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")` over libtiff 4.7.1 and libzstd 1.5.7.

Tolerance: exact everywhere (PIL's bytes, or an error the bake turns white
where PIL raises; NotImplementedError only where a test allows it). The
files come from the port's writer (`tiff.write_tiff`, every layout PIL's
writer blocks), from PIL's writer (CCITT and zstd as libtiff encodes them)
and from builders here: zstd frames taken apart and put together again,
ThunderScan codes by hand, and old-style JPEG in the JPEGInterchangeFormat
and the tables-tag forms around PIL's JPEG encoder. Inputs are made from
numpy seeds."""
import collections
import functools
import io
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import assets, tiff
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            port_rgba)
from test_torch_tiff import (_assert_as_pil_or_unported, _differenced,
                             _picture, _tiff, assert_bake_white_in_both)


def _bilevel(rng, h, w):
    img = (rng.random((h, w)) > rng.random()).astype(np.uint8)
    img[h // 3:, w // 4:] = 1
    img[h // 2:, :w // 2] = 0
    return img


# ----------------------------------------------------------------------------
# CCITT
# ----------------------------------------------------------------------------

CCITT = {"rle": (2, None), "rlew": (32771, None), "g3-1d": (3, 0),
         "g3-2d": (3, 1), "g3-1d-fill": (3, 4), "g3-2d-fill": (3, 5),
         "g4": (4, None)}


@pytest.mark.parametrize("layout", ["strip", "strips", "tiles"])
@pytest.mark.parametrize("case", list(CCITT))
def test_ccitt_as_pil(case, layout):
    """Each CCITT code (G3 in 1D, 2D and fill-bit forms) under Photometric
    0 and 1 and FillOrder 1 and 2, in one strip, in strips and in tiles:
    PIL's bytes, and the image the writer was given."""
    code, opts = CCITT[case]
    rng = np.random.default_rng(code * 10 + (opts or 0))
    lay = {"strip": {}, "strips": {"rows_per_strip": 7},
           "tiles": {"tile": (32, 16)}}[layout]
    for photometric in (0, 1):
        for fillorder in (1, 2):
            h, w = (int(v) for v in rng.integers(2, 70, 2))
            img = _bilevel(rng, h, w)
            data = tiff.write_tiff(img, photometric=photometric,
                                   compression=code, bits=1,
                                   fillorder=fillorder, t4options=opts, **lay)
            assert_as_pil(data, must_decode=True)
            grey = (img if photometric == 1 else 1 - img) * 255
            np.testing.assert_array_equal(port_rgba(data)[..., 0], grey)


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4"])
def test_ccitt_pil_written(compression):
    """PIL's own CCITT files (libtiff's encoder; Group 3 with T4Options 0,
    1, 4 and 5): PIL's bytes."""
    rng = np.random.default_rng(len(compression))
    for opts in ((0, 1, 4, 5) if compression == "group3" else (None,)):
        img = Image.fromarray(rng.random((23, 61)) > 0.4)
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression=compression,
                 tiffinfo={292: opts} if opts is not None else {})
        assert_as_pil(buf.getvalue(), must_decode=True)


def test_ccitt_refusals_and_white():
    """What libtiff's Fax3SetupState refuses (BitsPerSample other than 1)
    bakes white in both; a Group 3 strip cut inside a row is libtiff's
    premature end (white), one cut before a row's EOL keeps its rows."""
    img = _bilevel(np.random.default_rng(3), 12, 20)
    grey = _tiff(np.zeros((4, 5), np.uint8), 8, compression=3)
    assert pil_rgba(grey) is None
    assert_bake_white_in_both(grey)
    data = tiff.write_tiff(img, photometric=1, compression=3, bits=1,
                           t4options=0)
    count = struct.pack("<HHL", 279, 4, 1)
    at = data.index(count) + 8
    for cut in (3, 10, 40, 70):
        cut_file = bytearray(data)
        struct.pack_into("<L", cut_file, at, cut)
        _assert_as_pil_or_unported(bytes(cut_file))


# ----------------------------------------------------------------------------
# zstd
# ----------------------------------------------------------------------------

def _frame_parts(frame: bytes):
    """(header, [(block header, body)], checksum) of a frame the port's
    encoder wrote (no dictionary, no content size, a window byte)."""
    pos, blocks = 6, []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        size = 1 if (bh >> 1) & 3 == 1 else bh >> 3
        blocks.append((frame[pos:pos + 3], frame[pos + 3:pos + 3 + size]))
        pos += 3 + size
        if bh & 1:
            return frame[:6], blocks, frame[pos:]


def _zstd_tiff(img, segments, **kw):
    img = np.asarray(img)
    return _tiff(img, 8 if img.dtype == np.uint8 else 16,
                 photometric=2 if img.ndim == 3 and img.shape[2] == 3 else 1,
                 compression=50000, segments=segments, **kw)


@functools.lru_cache(maxsize=1)
def _zstd_cases():
    """Built at first use, not at import: PIL's plugin registry takes its
    order from the first call that fills it (test_torch_identify.py)."""
    rng = np.random.default_rng(50)
    noise = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    flat = np.full((40, 60, 3), 77, np.uint8)
    pic = _picture(rng, 40, 60)
    big = _picture(rng, 160, 320)                    # 153,600 bytes a strip
    z = tiff._compress
    cases = {
        "constant": _zstd_tiff(flat, [z(flat.tobytes(), 50000)]),
        "noise": _zstd_tiff(noise, [z(noise.tobytes(), 50000)]),
        "structured": _zstd_tiff(pic, [z(pic.tobytes(), 50000)]),
        "multi-block": _zstd_tiff(big, [z(big.tobytes(), 50000)]),
    }
    frame = z(pic.tobytes(), 50000)
    head, blocks, check = _frame_parts(frame)
    plain = head[:4] + bytes((head[4] & ~4,)) + head[5:] + b"".join(
        h + b for h, b in blocks)
    skip = b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"skip!"
    cases.update({
        "checksum-flag": _zstd_tiff(pic, [frame]),
        "no-checksum": _zstd_tiff(pic, [plain]),
        "bad-checksum": _zstd_tiff(pic, [frame[:-1] + bytes((frame[-1] ^ 1,))]),
        "skippable-first": _zstd_tiff(pic, [skip + frame]),
        "second-frame": _zstd_tiff(pic, [frame + frame]),
        "short-frame": _zstd_tiff(pic, [z(pic[:20].tobytes(), 50000)
                                        + frame]),
        "oversize-window": _zstd_tiff(pic, [head[:5] + bytes((18 << 3,))
                                            + frame[6:]]),
        "dictionary": _zstd_tiff(pic, [head[:4] + bytes((head[4] | 1, head[5],
                                                         7)) + frame[6:]]),
        "reserved-block": _zstd_tiff(pic, [head + bytes((blocks[0][0][0] | 6,))
                                           + frame[7:]]),
    })
    # PIL's zstd (libtiff's encoder: Huffman literals, FSE tables, repeat
    # offsets), 8 and 16 bits, with libtiff's horizontal differencing
    for mode in ("RGB", "L", "I;16"):
        arr = _picture(rng, 70, 90)
        im = Image.fromarray(arr).convert(mode) if mode != "I;16" else \
            Image.fromarray(arr[..., 0].astype(np.uint16) * 250)
        for pred in (1, 2):
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression="zstd", tiffinfo={317: pred})
            cases[f"pil-{mode}-predictor{pred}"] = buf.getvalue()
    # horizontal differencing and the floating-point predictor
    rows = np.frombuffer(pic.tobytes(), np.uint8).reshape(40, -1)
    diff = _differenced(rows, 8, 3, "<", 2)
    cases["predictor-2"] = _zstd_tiff(pic, [z(diff.tobytes(), 50000)],
                                      predictor=2)
    f32 = (rng.random((20, 30)) * 300 - 40).astype(np.float32)
    frows = np.frombuffer(f32.astype("<f4").tobytes(), np.uint8).reshape(20,
                                                                        -1)
    fdiff = _differenced(frows, 32, 1, "<", 3)
    cases["predictor-3"] = _tiff(f32, 32, photometric=1, compression=50000,
                                 predictor=3, sample_format=3,
                                 segments=[z(fdiff.tobytes(), 50000)])
    return cases


ZSTD_CASES = ("constant", "noise", "structured", "multi-block",
              "checksum-flag", "no-checksum", "bad-checksum",
              "skippable-first", "second-frame", "short-frame",
              "oversize-window", "dictionary", "reserved-block",
              "pil-RGB-predictor1", "pil-RGB-predictor2",
              "pil-L-predictor1", "pil-L-predictor2", "pil-I;16-predictor1",
              "pil-I;16-predictor2", "predictor-2", "predictor-3")


def test_zstd_cases_listed():
    """The parametrisation names every case `_zstd_cases` builds."""
    assert tuple(_zstd_cases()) == ZSTD_CASES


@pytest.mark.parametrize("case", ZSTD_CASES)
def test_zstd_as_pil(case):
    """zstd strips as ZSTDDecode drives libzstd: RLE, raw and compressed
    blocks, frames of more than one block, the checksum (a bad one is an
    error), a skippable frame first (the decode ends with it: white), a
    second frame (not read), a frame shorter than the strip (white), a
    window above 2^27, a dictionary ID, a reserved block type, PIL's own
    files and both predictors."""
    data = _zstd_cases()[case]
    assert_as_pil(data, must_decode=case in ("constant", "noise",
                                             "structured", "multi-block",
                                             "checksum-flag", "no-checksum",
                                             "second-frame", "predictor-2",
                                             "predictor-3")
                  or case.startswith("pil-"))


# ----------------------------------------------------------------------------
# ThunderScan
# ----------------------------------------------------------------------------

def test_thunderscan_as_pil():
    """ThunderScan: the writer's 4-bit files (runs, 2- and 3-bit deltas,
    raw values) in strips, both photometrics and fill orders; hand-made
    rows whose pixel count falls short or runs over (libtiff's error:
    white); an 8-bit file (ThunderSetupDecode refuses it: white)."""
    rng = np.random.default_rng(32809)
    for k in range(6):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        img = rng.integers(0, 16, (h, w))
        img[:, w // 2:] = 9
        img[h // 2:] = np.clip(np.cumsum(rng.integers(-1, 2, (h - h // 2, w)),
                                         1), 0, 15)
        data = tiff.write_tiff(img, photometric=k % 2, compression=32809,
                               bits=4, fillorder=1 + k // 3,
                               rows_per_strip=[None, 3, 5][k % 3])
        assert_as_pil(data, must_decode=True)
        np.testing.assert_array_equal(
            port_rgba(data)[..., 0], (img if k % 2 else 15 - img) * 17)
    full = bytes([0xC5, 0x06, 0xC9])           # 5, a run of six, 9
    for seg in (full * 4, full * 3 + bytes([0xC3, 0x02]),
                full * 3 + bytes([0xC3, 0x3F]), bytes([0x7F]) + full * 3):
        data = _tiff(np.zeros((4, 8), np.uint8), 4, compression=32809,
                     segments=[seg])
        assert_as_pil(data, must_decode=seg == full * 4)
    eight = _tiff(np.zeros((4, 8), np.uint8), 8, compression=32809,
                  segments=[full * 4])
    assert pil_rgba(eight) is None
    assert_bake_white_in_both(eight)


# ----------------------------------------------------------------------------
# old-style JPEG
# ----------------------------------------------------------------------------

def _markers(j):
    """[(marker, start, end)] up to and including SOS, and the offset of
    the entropy-coded data."""
    out, i = [], 2
    while True:
        m, n = j[i + 1], (j[i + 2] << 8) | j[i + 3]
        out.append((m, i, i + 2 + n))
        i += 2 + n
        if m == 0xDA:
            return out, i


def _ifd_file(blobs, tags):
    """A little-endian TIFF: `blobs` from offset 8, then the directory of
    `tags` {tag: (type, values)}, where a value ("blob", k) is blob k's
    offset."""
    body, offs = bytearray(), []
    for b in blobs:
        offs.append(8 + len(body))
        body += b + b"\0" * (len(b) % 2)
    t = {k: (typ, [offs[v[1]] if isinstance(v, tuple) else v for v in vals])
         for k, (typ, vals) in tags.items()}
    ifd_off = 8 + len(body)
    ext_off = ifd_off + 2 + 12 * len(t) + 4
    ents, ext = bytearray(), bytearray()
    for tag in sorted(t):
        typ, vals = t[tag]
        data = struct.pack("<" + ("H" if typ == 3 else "L") * len(vals),
                           *vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack("<L", ext_off + len(ext))
            ext += data + b"\0" * (len(data) % 2)
        ents += struct.pack("<HHL", tag, typ, len(vals)) + field
    return bytes(b"II*\0" + struct.pack("<L", ifd_off) + body +
                 struct.pack("<H", len(t)) + ents + b"\0" * 4 + ext)


def ojpeg_tiff(img, subsampling=2, form="jif", rows=None, sub_tag=True,
               photometric=6, quality=80):
    """An old-style JPEG TIFF (compression 6) around PIL's JPEG of `img`
    (RGB, or (H, W) grey): "jif" puts the JPEG's markers in the
    JPEGInterchangeFormat block and its entropy-coded data in the strips,
    "whole" points both at the whole JPEG, "tables" writes the quantisation
    and Huffman tables through the JPEGQTables / DCTables / ACTables tags.
    With `rows`, the JPEG has restart markers every strip of that many
    rows, and each strip holds one interval (libtiff writes the RSTn)."""
    grey = img.ndim == 2
    kw = {"quality": quality}
    if not grey:
        kw["subsampling"] = subsampling
    mcu_rows = 16 if subsampling == 2 and not grey else 8
    if rows:
        kw["restart_marker_rows"] = rows // mcu_rows
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    j = buf.getvalue()
    h, w = img.shape[:2]
    spp = 1 if grey else 3
    ms, start = _markers(j)
    ent = j[start:j.rindex(b"\xff\xd9")]
    strips, cur, t = [], bytearray(), 0
    while t < len(ent):
        if rows and ent[t] == 0xFF and t + 1 < len(ent) and \
                0xD0 <= ent[t + 1] <= 0xD7:
            strips.append(bytes(cur))
            cur, t = bytearray(), t + 2
            continue
        cur.append(ent[t])
        t += 1
    strips.append(bytes(cur))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp),
            259: (3, [6]), 262: (3, [photometric]), 277: (3, [spp]),
            278: (4, [rows or h])}
    if not grey and sub_tag:
        tags[530] = (3, [(1, 1), (2, 1), (2, 2)][subsampling])
    blobs = []
    if form == "whole":
        blobs = [j]
        tags.update({513: (4, [("blob", 0)]), 514: (4, [len(j)]),
                     273: (4, [("blob", 0)]), 279: (4, [len(j)])})
        return _ifd_file(blobs, tags)
    if form == "jif":
        blobs = [j[:start]] + strips
        tags.update({513: (4, [("blob", 0)]), 514: (4, [start])})
        first = 1
    else:
        blobs = list(strips)
        first = 0
        qts, dcs, acs = {}, {}, {}
        for m, a, b in ms:
            body = j[a + 4:b]
            p = 0
            while m == 0xDB and p < len(body):
                qts[body[p] & 15] = body[p + 1:p + 65]
                p += 65
            while m == 0xC4 and p < len(body):
                q = sum(body[p + 1:p + 17])
                (dcs if body[p] >> 4 == 0 else acs)[body[p] & 15] = \
                    body[p + 1:p + 17 + q]
                p += 17 + q
            if m == 0xC0:
                tq = [body[8 + 3 * k] for k in range(body[5])]
            if m == 0xDA:
                td = [body[2 + 2 * k] for k in range(body[0])]
        for tag, tables in ((519, [qts[q] for q in tq]),
                            (520, [dcs[x >> 4] for x in td]),
                            (521, [acs[x & 15] for x in td])):
            refs = []
            for table in tables:
                refs.append(("blob", len(blobs)))
                blobs.append(table)
            tags[tag] = (4, refs)
        tags[512] = (3, [1])
    n = len(strips)
    tags.update({273: (4, [("blob", first + k) for k in range(n)]),
                 279: (4, [len(s) for s in strips])})
    return _ifd_file(blobs, tags)


@pytest.mark.parametrize("form", ["jif", "whole", "tables"])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_old_style_jpeg_as_pil(subsampling, form):
    """Old-style JPEG at 4:4:4, 4:2:2 and 4:2:0, in the interchange, whole
    and tables forms, one strip and strips with restart intervals, with and
    without a YCbCrSubSampling tag (OJPEG reads the sampling from the frame
    header, or takes 2x2 without one): libjpeg's raw planes through
    TIFFRGBAImage, PIL's bytes."""
    rng = np.random.default_rng(600 + subsampling)
    for rows in ((None,) if form == "whole" else (None, 16, 32)):
        # the tables form has no frame header to correct a missing tag by
        for sub_tag in (True, False) if form != "tables" or \
                subsampling == 2 else (True,):
            h, w = (int(v) for v in rng.integers(20, 90, 2))
            data = ojpeg_tiff(_picture(rng, h, w), subsampling, form, rows,
                              sub_tag)
            assert_as_pil(data, must_decode=True)


def test_old_style_jpeg_420_is_not_a_plain_decode():
    """At 4:2:0 PIL's pixels are libtiff's (nearest chroma, tif_color.c),
    levels away from libjpeg's own upsampled decode of the same JPEG; the
    port gives PIL's."""
    rgb = _picture(np.random.default_rng(420), 64, 80)
    data = ojpeg_tiff(rgb, 2, "jif")
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=80, subsampling=2)
    plain = np.asarray(Image.open(buf).convert("RGBA")).astype(int)
    got = port_rgba(data)
    np.testing.assert_array_equal(got, pil_rgba(data))
    assert np.abs(got.astype(int) - plain).max() > 20


def test_old_style_jpeg_grey_and_white():
    """A grey old-style JPEG (Photometric 0 and 1: libjpeg's rows as they
    are), and what PIL whitens: missing tables, a frame of another width,
    three samples under a grey photometric."""
    rng = np.random.default_rng(601)
    grey = _picture(rng, 40, 56)[..., 1]
    for form in ("jif", "tables"):
        for photometric in (0, 1):
            for rows in (None, 16):
                assert_as_pil(ojpeg_tiff(grey, 0, form, rows,
                                         photometric=photometric),
                              must_decode=True)
    good = ojpeg_tiff(_picture(rng, 32, 48), 2, "tables")
    no_tables = good.replace(struct.pack("<HHL", 519, 4, 3),
                             struct.pack("<HHL", 64999, 4, 3))
    assert pil_rgba(no_tables) is None
    assert_bake_white_in_both(no_tables)
    wide = bytearray(ojpeg_tiff(_picture(rng, 32, 48), 2, "jif"))
    at = bytes(wide).index(struct.pack("<HHL", 256, 4, 1)) + 8
    struct.pack_into("<L", wide, at, 40)
    assert_as_pil(bytes(wide))
    rgb_grey = ojpeg_tiff(_picture(rng, 32, 48), 0, "jif", photometric=1)
    assert_as_pil(rgb_grey)


# ----------------------------------------------------------------------------
# SGILog, and the once-unported compressions as PIL reads them
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("code", [34676, 34677])
def test_sgilog_as_pil(code):
    """SGILog and SGILog24 under each photometric (bilevel, grey, RGB,
    palette, CMYK, YCbCr, LAB, LogL, LogLuv) and sample size: PIL refuses
    what its OPEN_INFO lacks (LogL and LogLuv among them), and libtiff's
    LogLuvSetupDecode fails every other one (white)."""
    for photometric in (0, 1, 2, 3, 5, 6, 8, 32844, 32845):
        for bps, spp in ((1, 1), (8, 1), (8, 3), (16, 1), (16, 3), (32, 3)):
            kw = {"colormap": [0] * (3 << bps)} if photometric == 3 and \
                bps <= 8 else {}
            v = np.zeros((4, 5, spp), np.uint8 if bps <= 8 else np.uint16)
            data = _tiff(v, bps, photometric=photometric, compression=code,
                         **kw)
            assert pil_rgba(data) is None
            assert_as_pil(data)


# ----------------------------------------------------------------------------
# the writers, the bake and the sweep
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["zstd-tiles-predictor", "zstd-16-planar",
                                    "thunderscan", "g4-window-mask",
                                    "rlew", "g3-2d"])
def test_writer_decodes_to_its_texels(layout):
    """`tiff.write_tiff` with each new encoder: PIL and the port both
    decode the file to the texels it was given."""
    rng = np.random.default_rng(77)
    img = (rng.integers(0, 256, (45, 70, 3)) // 16 * 16).astype(np.uint8)
    mask = _bilevel(rng, 45, 70)
    nib = rng.integers(0, 16, (45, 70))
    data, want = {
        "zstd-tiles-predictor": lambda: (tiff.write_tiff(
            img, compression=50000, predictor=2, tile=(32, 16)), img),
        "zstd-16-planar": lambda: (tiff.write_tiff(
            img.astype(np.uint16) * 257, compression=50000, planar=2,
            order=">"), img),
        "thunderscan": lambda: (tiff.write_tiff(
            nib, photometric=1, compression=32809, bits=4,
            rows_per_strip=8), np.repeat((nib * 17)[..., None], 3, -1)),
        "g4-window-mask": lambda: (tiff.write_tiff(
            mask, photometric=0, compression=4, bits=1, fillorder=2),
            np.repeat(((1 - mask) * 255)[..., None], 3, -1)),
        "rlew": lambda: (tiff.write_tiff(
            mask, photometric=1, compression=32771, bits=1,
            rows_per_strip=16), np.repeat((mask * 255)[..., None], 3, -1)),
        "g3-2d": lambda: (tiff.write_tiff(
            mask, photometric=1, compression=3, bits=1, t4options=5),
            np.repeat((mask * 255)[..., None], 3, -1)),
    }[layout]()
    want = np.concatenate([want, np.full((45, 70, 1), 255, np.uint8)], -1)
    np.testing.assert_array_equal(pil_rgba(data), want)
    np.testing.assert_array_equal(port_rgba(data), want)


def test_city_maps_decode_to_their_texels(tmp_path):
    """The TIFF-codec city's maps (`assets.write_city_assets(...,
    formats="tiffcodec")`: zstd RGB tiles with differencing, zstd 16-bit
    planar big-endian normals, ThunderScan metallic-roughness, a Group 4
    emissive window mask) decode, in PIL and in the port, to the texels
    their writer reports."""
    written = assets.write_city_assets(str(tmp_path), map_size=64,
                                       emissive_size=32, ground_size=(8, 16),
                                       formats="tiffcodec")
    assert len(written) == 10
    for name, (img, want) in written.items():
        with open(tmp_path / "meshes" / name, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(pil_rgba(data), want)
        np.testing.assert_array_equal(port_rgba(data), want)


def test_bake_matches_jax():
    """The new codecs through both packages' bakes (decode, Lanczos resize,
    pages): equal atlases; a refused codec bakes white in both."""
    rng = np.random.default_rng(34)
    rgb = _picture(rng, 40, 56)
    assert_bake_matches_jax([
        tiff.write_tiff(rgb, compression=50000, predictor=2, tile=(32, 32)),
        tiff.write_tiff(rgb.astype(np.uint16) * 257, compression=50000,
                        planar=2, order=">"),
        tiff.write_tiff(rng.integers(0, 16, (30, 20)), photometric=1,
                        compression=32809, bits=4),
        tiff.write_tiff(_bilevel(rng, 33, 47), photometric=0, compression=4,
                        bits=1, fillorder=2),
        ojpeg_tiff(rgb, 2, "jif")])
    assert_bake_white_in_both(_zstd_cases()["skippable-first"])


def _sweep_base(k):
    r = np.random.default_rng(k)
    h, w = (int(v) for v in r.integers(2, 48, 2))
    kind = k % 9
    lay = ({}, {"rows_per_strip": int(r.integers(1, 9))},
           {"tile": (32, 16)})[k % 3]
    if kind < 5:
        code = (2, 32771, 3, 3, 4)[kind]
        return tiff.write_tiff(
            _bilevel(r, h, w), photometric=k % 2, compression=code, bits=1,
            fillorder=1 + (k // 9) % 2,
            t4options=(k // 3) % 2 + 4 * (k % 2) if code == 3 else None,
            **lay)
    if kind == 5:
        img = r.integers(0, 16, (h, w))
        img[:, w // 2:] = 3
        return tiff.write_tiff(img, photometric=1, compression=32809, bits=4,
                               rows_per_strip=lay.get("rows_per_strip"))
    if kind == 6:
        buf = io.BytesIO()
        Image.fromarray(r.random((h, w)) > 0.5).save(
            buf, "TIFF", compression=("group4", "group3", "tiff_ccitt",
                                      "zstd")[k % 4])
        return buf.getvalue()
    if kind == 7:
        img = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
        img[h // 2:] //= 64
        return tiff.write_tiff(img, compression=50000, predictor=1 + k % 2,
                               **lay)
    return ojpeg_tiff(_picture(r, h + 16, w + 16), k % 3,
                      ("jif", "tables")[k % 2], (None, 16)[(k // 2) % 2])


def _shrink_segment(data: bytearray, rng) -> bytearray:
    """The file with one strip's or tile's byte count cut short (its data
    left in place): the codec meets the end of its data, not of the
    file."""
    ifd = struct.unpack_from("<L", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        e = ifd + 2 + 12 * k
        tag, typ, cnt = struct.unpack_from("<HHL", data, e)
        if tag in (279, 325) and typ == 4:
            at = e + 8 if cnt == 1 else struct.unpack_from("<L", data, e + 8)[0]
            at += 4 * int(rng.integers(0, cnt))
            n = struct.unpack_from("<L", data, at)[0]
            struct.pack_into("<L", data, at, int(rng.integers(0, max(n, 1))))
    return data


# the sweep's files that raise NotImplementedError, by case: no change may
# send more of them there (PERF.md gives the outcomes; 5 of 300 since the
# JPEG decoder follows libjpeg's recoveries, 15 since libtiff's directory
# reader was ported, 60 before)
CUT_UNPORTED = (1, 1, 0, 1, 1, 1)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut, shortened or flipped files (50 a case) over the new
    codecs: PIL's bytes, PIL's refusal or white, or NotImplementedError
    where libtiff's outcome is not modelled (a directory cut short, rows a
    truncated CCITT strip leaves in PIL's uninitialised buffer, a corrupt
    old-style JPEG strip that TIFFRGBAImage reads zeroed); never pixels
    that differ."""
    rng = np.random.default_rng(1800 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_sweep_base((50 * part + t) % 71))
        r = rng.random()
        if r < 0.2:
            data = data[:int(rng.integers(0, len(data)))]
        elif r < 0.45:
            data = _shrink_segment(data, rng)
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[_assert_as_pil_or_unported(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen
