"""libjpeg-turbo 3.1.3's recoveries in the port's JPEG decoder
(`csrc/jpeg_decoder.cpp` through `scene/jpeg.py`): what libjpeg decodes
past with a warning under PIL, held byte for byte to PIL's
`Image.open(f).convert("RGBA")`, and what it refuses, held to PIL's error
(the bake's white). One parametrised test per recovery: a segment that ends
early (zero bits, then the segment skipped; PIL's 65536-byte feed and
libjpeg's read-ahead where no EOI follows), bad Huffman codes, restart
markers out of sequence (jpeg_resync_to_restart), scans out of the
progression, block smoothing of progressive files, lossless (SOF3) frames,
arithmetic-coded frames, and the frame headers libjpeg refuses. Then the committed fixtures of
`tests/data/jpeg/` (tools/make_jpeg_fixtures.py) against their manifest,
which `chip_smoke.py` holds the card's host to; the JPEG-recovery city's
maps (`assets.write_city_assets(..., formats="jpegrec")`) at 256^2 and
2048^2 against PIL and the manifest's digests; the bake of `tcityjpeg4`
against JAX's `build_texture_pages`; and that no site of the decoder
raises NotImplementedError any more."""
import collections
import glob
import hashlib
import io
import json
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import assets, jpeg, textures
from kajiya_tpu_torch.scene.identify import Refused
from kajiya_tpu_torch.scene.jpeg import (JpegError, decode_jpeg,
                                         decode_jpeg_planes,
                                         decode_jpeg_stream)
from test_torch_bmp import assert_bake_matches_jax
from test_torch_jpeg_decode import _assert_as_pil, _image, _pil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
_MANIFEST_PATH = os.path.join(FIXTURES, "manifest.json")
MANIFEST = json.load(open(_MANIFEST_PATH)) if os.path.exists(
    _MANIFEST_PATH) else {}
FILES = sorted(n for n, r in MANIFEST.items() if not r.get("city_map"))


def _file(seed, h, w, mode="RGB", **kw):
    img = _image(np.random.default_rng(seed), h, w,
                 {"L": 1, "RGB": 3, "CMYK": 4}[mode])
    im = Image.fromarray(img[..., 0] if mode == "L" else img) \
        if mode != "CMYK" else Image.frombytes("CMYK", (w, h), img.tobytes())
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _markers(data, codes):
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] in codes]


def _scan_start(data):
    return data.index(b"\xff\xda")


def _outcomes(files):
    """Each file as PIL decodes it, or refused in both: the count of
    each."""
    return collections.Counter(_assert_as_pil(d) for d in files)


# ---------------------------------------------------------------------------
# 1. a segment that ends early
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "baseline", "baseline-420-restart", "progressive", "progressive-restart",
    "grey", "cmyk", "big-baseline", "big-progressive"])
def test_premature_end_as_pil(case):
    """A scan cut anywhere and closed with EOI (JWRN_HIT_MARKER: the MCU
    that runs out gets zero bits, the rest of the segment stays zero), and
    cut without EOI near its end (PIL's suspending source: libjpeg's
    read-ahead reaching the end makes PIL raise "image file is
    truncated"). The big files cross PIL's 65536-byte blocks, where libjpeg
    leaves its fast Huffman path."""
    kw = dict(quality=90)
    mode, h, w = "RGB", 48, 64
    if "progressive" in case:
        kw["progressive"] = True
    if "restart" in case:
        kw["restart_marker_blocks"] = 3
    if "420" in case:
        kw["subsampling"] = 2
    if case == "grey":
        mode = "L"
    if case == "cmyk":
        mode = "CMYK"
    if case.startswith("big"):
        h, w, kw["quality"] = 400, 480, 97
    data = _file(len(case), h, w, mode, **kw)
    if case.startswith("big"):
        assert len(data) > 2 * 65536
    sos = _scan_start(data)
    rng = np.random.default_rng(len(case))
    cuts = rng.integers(sos + 12, len(data) - 2, 10)
    files = [data[:c] + b"\xff\xd9" for c in cuts]
    files += [data[:len(data) - j] for j in range(2, 6)]
    seen = _outcomes(files)
    # a progressive file's cuts may fall in the tables between its scans
    assert seen["decoded"] >= (6 if "progressive" in case else 10), seen


def test_premature_end_without_eoi_decodes_where_pil_does():
    """Flat images whose last MCUs need few bits: with the EOI taken off,
    libjpeg's bit buffer may hold the rest of the scan before the data
    ends; PIL then decodes the file. Both outcomes occur, and the port's
    is PIL's each time."""
    y, x = np.mgrid[0:64, 0:80]
    seen = collections.Counter()
    for q in range(40, 100, 2):
        img = np.stack([x * 2, y * 3, np.full_like(x, q)], -1).astype(
            np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=q)
        seen[_assert_as_pil(buf.getvalue()[:-2])] += 1
    assert seen["decoded"] and seen["refused"], seen


# ---------------------------------------------------------------------------
# 2. bad Huffman codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sequential", "progressive-ac",
                                  "progressive-refine", "restart"])
def test_bad_codes_as_pil(case):
    """Flipped entropy bytes: a code of no table reads as symbol 0 after 17
    bits (JWRN_HUFF_BAD_CODE), on the fast path and the slow one; a
    refinement code of a size other than 1 is read as one."""
    kw = dict(quality=85)
    if case.startswith("progressive"):
        kw["progressive"] = True
    if case == "restart":
        kw["restart_marker_blocks"] = 2
    data = _file(10 + len(case), 64, 64, "RGB", **kw)
    if case == "progressive-refine":
        start = _markers(data, (0xDA,))[-1]
    else:
        start = _scan_start(data)
    rng = np.random.default_rng(len(case))
    files = []
    for _ in range(24):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start + 14, len(d) - 2))
            d[i] ^= 1 << int(rng.integers(0, 8))
        files.append(bytes(d))
    seen = _outcomes(files)
    assert seen["decoded"] >= 12, seen


# ---------------------------------------------------------------------------
# 3. restart markers out of sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("edit", ["renumber", "drop", "duplicate", "other",
                                  "junk"])
def test_restart_resync_as_pil(edit, progressive):
    """An RSTn renumbered to each other value (jpeg_resync_to_restart
    discards it, scans on, or leaves it for an empty segment), dropped,
    duplicated, replaced by another marker, or preceded by junk bytes."""
    data = _file(20 + len(edit), 48, 72, "RGB", quality=80,
                 progressive=progressive, restart_marker_blocks=2)
    rst = _markers(data, range(0xD0, 0xD8))
    files = []
    for i in rst[1:len(rst):max(1, len(rst) // 4)]:
        if edit == "renumber":
            files += [data[:i + 1] + bytes([0xD0 + v]) + data[i + 2:]
                      for v in range(8) if 0xD0 + v != data[i + 1]]
        elif edit == "drop":
            files.append(data[:i] + data[i + 2:])
        elif edit == "duplicate":
            files.append(data[:i] + data[i:i + 2] + data[i:])
        elif edit == "other":
            files += [data[:i + 1] + bytes([m]) + data[i + 2:]
                      for m in (0xD9, 0xC4, 0x01, 0xBF)]
        else:
            files.append(data[:i] + bytes((0x12, 0xFF, 0x00, 0x34)) +
                         data[i:])
    seen = _outcomes(files)
    assert seen["decoded"] >= len(files) // 2, seen


# ---------------------------------------------------------------------------
# 4. scans out of the progression
# ---------------------------------------------------------------------------

def _scans(data):
    """The file's head, its scans (each with the tables before it) and its
    tail."""
    first = _scan_start(data)
    segs, start = [], first
    for i in _markers(data, (0xDA,)):
        j = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        while data[j] != 0xFF or data[j + 1] == 0 or \
                0xD0 <= data[j + 1] <= 0xD7:
            j += 1
        segs.append(data[start:j])
        start = j
    return data[:first], segs, data[start:]


@pytest.mark.parametrize("case", ["ac-before-dc", "repeated", "refine-first",
                                  "swapped", "dropped-dc",
                                  "sequential-spectral"])
def test_scan_order_as_pil(case):
    """JWRN_BOGUS_PROGRESSION: an AC scan before its DC, a scan repeated, a
    refinement scan before its first pass, two scans swapped, the DC scan
    dropped; each is decoded, its coefficient bits updated. A sequential
    scan with Ss, Se, Ah or Al set is decoded as a baseline one
    (JWRN_NOT_SEQUENTIAL)."""
    if case == "sequential-spectral":
        files = []
        base = _file(30, 40, 48, "RGB", quality=85)
        sos = _scan_start(base)
        o = sos + 5 + 2 * base[sos + 4]
        for ss, se, a in ((0, 0, 0), (1, 63, 0), (0, 10, 0x21), (5, 2, 0x10),
                          (0, 63, 0x01)):
            d = bytearray(base)
            d[o:o + 3] = bytes((ss, se, a))
            files.append(bytes(d))
        seen = _outcomes(files)
        assert seen["decoded"] == len(files), seen
        return
    data = _file(31, 40, 56, "RGB", quality=85, progressive=True)
    head, segs, tail = _scans(data)
    n = len(segs)
    order = {"ac-before-dc": [1, 0] + list(range(2, n)),
             "repeated": [0, 1, 2, 1] + list(range(3, n)),
             "refine-first": [0, n - 1] + list(range(1, n - 1)),
             "swapped": [0, 3, 2, 1] + list(range(4, n)),
             "dropped-dc": list(range(1, n))}[case]
    got = _assert_as_pil(head + b"".join(segs[k] for k in order) + tail)
    assert got == "decoded"


# ---------------------------------------------------------------------------
# 5. block smoothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
@pytest.mark.parametrize("size", [(8, 8), (16, 16), (17, 40), (40, 16),
                                  (48, 64)])
def test_block_smoothing_as_pil(size, mode):
    """A progressive file cut after each of its scans (closed with EOI) is
    block-smoothed (decompress_smooth_data: DC and the first nine AC
    coefficients estimated from a 5 x 5 window of DC values where they are
    not known exactly); narrow and short components take the window's edge
    rules, a cut inside a scan the bits of the scan before it."""
    h, w = size
    for sub in (0, 2):
        data = _file(h * w + sub, h, w, mode, quality=70, subsampling=sub,
                     progressive=True)
        sos = _markers(data, (0xDA,))
        files = [data[:s] + b"\xff\xd9" for s in sos[1:]]
        seen = _outcomes(files)
        assert seen["decoded"] == len(files), seen
        # cut inside the scans' data (not in the tables between them)
        files = [data[:s + 40] + b"\xff\xd9" for s in sos[1:]
                 if s + 40 < len(data) - 2]
        _outcomes(files)


# ---------------------------------------------------------------------------
# 6. lossless frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_as_pil(psv):
    """The port's lossless writer (one predictor, grey) at odd sizes: PIL
    and the port decode it to its samples; then cut with and without EOI
    and with flipped bytes (zero differences and the predictor reset
    where the data runs out), as PIL decodes them."""
    rng = np.random.default_rng(psv)
    for h, w in ((1, 1), (3, 17), (33, 20)):
        grey = _image(rng, h, w, 1)[..., 0]
        data = jpeg.encode_jpeg_lossless(grey, psv=psv)
        want = np.concatenate([np.repeat(grey[..., None], 3, -1),
                               np.full((h, w, 1), 255, np.uint8)], -1)
        np.testing.assert_array_equal(_pil(data), want)
        np.testing.assert_array_equal(decode_jpeg(data), want)
    sos = _scan_start(data)
    files = [data[:c] + b"\xff\xd9" for c in range(sos + 12, len(data), 37)]
    files += [data[:len(data) - j] for j in range(1, 4)]
    for k in range(10):
        d = bytearray(data)
        d[sos + 12 + 29 * k % (len(d) - sos - 14)] ^= 1 << (k % 8)
        files.append(bytes(d))
    _outcomes(files)


@pytest.mark.parametrize("name", [n for n in FILES
                                  if n.startswith("lossless_")])
def test_lossless_fixtures_decode(name):
    """The libjpeg-written lossless fixtures: predictors 1-7, point
    transforms, restarts, one and three components, h2v2 sampling (box
    upsampling: a lossless frame has no fancy upsampling) and the RGB
    colour space all decode, none raises, each as PIL decodes it."""
    rec = MANIFEST[name]
    assert not rec.get("white") and not rec.get("unported")
    got = textures._decode_image(os.path.join(FIXTURES, name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["rgba_sha256"]


# ---------------------------------------------------------------------------
# 7. frame headers libjpeg refuses
# ---------------------------------------------------------------------------

def _sof(data):
    return next(i for i in _markers(data, (0xC0, 0xC1, 0xC2)))


@pytest.mark.parametrize("case", ["12bit", "dnl", "fraction", "four-ycc",
                                  "four-raw"])
def test_refused_frames(case):
    """Where each frame-header site is reached from: 12-bit and height-0
    (DNL) frames are refused by PIL's `_open` before libjpeg (Refused), and
    libjpeg errs on them where libtiff hands them over
    (JERR_BAD_PRECISION, JERR_EMPTY_IMAGE: JpegError); a non-integer
    sampling ratio fails at libjpeg's upsampler (PIL raises) but gives raw
    planes (libtiff's old-style codec); four components under libtiff's
    YCbCr fail (JERR_BAD_J_COLORSPACE), under its unknown colour space come
    out as coded."""
    if case.startswith("four"):
        data = _file(40, 16, 24, "CMYK", quality=90)
        if case == "four-ycc":
            with pytest.raises(JpegError, match="four components"):
                decode_jpeg_stream(data, 1)
        else:
            raw = decode_jpeg_stream(data, 2)
            assert raw.shape == (16, 24, 4)
            cmyk = np.asarray(Image.open(io.BytesIO(data)))
            # PIL reads Adobe CMYK inverted ("CMYK;I")
            np.testing.assert_array_equal(255 - raw, cmyk)
        return
    data = bytearray(_file(41, 24, 40, "RGB", quality=85, subsampling=0))
    i = _sof(data)
    if case == "12bit":
        data[i + 4] = 12
    elif case == "dnl":
        data[i + 5:i + 7] = b"\x00\x00"
    else:
        # components 1 and 2 sampled 3 x 1 and 2 x 1: 3 / 2 is no integer
        data[i + 11] = 0x31
        data[i + 14] = 0x21
    data = bytes(data)
    with pytest.raises(Exception):
        _pil(data)
    if case == "fraction":
        with pytest.raises(JpegError, match="JERR_FRACT_SAMPLE_NOTIMPL"):
            decode_jpeg(data)
        planes = decode_jpeg_planes(data)
        assert [p.shape for p in planes] == [(24, 48), (24, 32), (24, 16)]
        return
    with pytest.raises(Refused):
        decode_jpeg(data)
    with pytest.raises(JpegError):
        decode_jpeg_stream(data, 1)


def test_unported_sites_are_listed():
    """No site of the decoder is left unported: it has no status for "not
    implemented", and `scene/jpeg.py` raises nothing but JpegError (and
    `identify.Refused` from PIL's header walk)."""
    with open(os.path.join(REPO, "kajiya_tpu_torch", "csrc",
                           "jpeg_decoder.cpp")) as f:
        src = f.read()
    assert not re.findall(r"\bunported\(", src)
    assert "Fail{2" not in src
    with open(os.path.join(REPO, "kajiya_tpu_torch", "scene",
                           "jpeg.py")) as f:
        assert "NotImplementedError" not in f.read()


@pytest.mark.parametrize("name", [n for n in FILES
                                  if n.startswith("arith_")])
def test_arithmetic_as_pil(name):
    """Arithmetic-coded frames (jdarith.c: sequential and progressive,
    DAC conditioning, restarts; the QM-coder's states of T.81 Table D.2):
    each fixture, then cut and closed with EOI, without it, and with bytes
    flipped, as PIL decodes it. A scan past PIL's first 65536-byte block
    fails in libjpeg (the arithmetic decoder cannot suspend): white."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = "refused" if MANIFEST[name].get("white") else "decoded"
    assert _assert_as_pil(data) == want
    if want == "refused":
        assert len(data) > 65536
        return
    sos = _scan_start(data)
    rng = np.random.default_rng(len(name))
    files = [data[:c] + b"\xff\xd9" for c in rng.integers(sos, len(data), 8)]
    files += [data[:len(data) - j] for j in (1, 2, 5)]
    for _ in range(8):
        d = bytearray(data)
        i = int(rng.integers(sos + 10, len(d) - 2))
        d[i] ^= 1 << int(rng.integers(0, 8))
        files.append(bytes(d))
    seen = _outcomes(files)
    assert seen["decoded"] >= 8, seen


# ---------------------------------------------------------------------------
# the fixtures, the writers and the JPEG-recovery city
# ---------------------------------------------------------------------------

def test_manifest_lists_every_kind():
    kinds = collections.Counter(n.split("_")[0] for n in FILES)
    assert set(kinds) == {"lossless", "arith", "smooth", "rst", "cut",
                          "badcode", "order"}
    assert kinds["lossless"] >= 10 and kinds["arith"] >= 4
    assert sum(MANIFEST[n]["bytes"] for n in FILES) < 1_000_000
    assert sorted(n for n in FILES if MANIFEST[n].get("white")) == [
        "arith_big_white.jpg", "cut_no_eoi.jpg"]
    assert max(MANIFEST[n]["bytes"] for n in FILES) > 65536
    assert len([n for n in MANIFEST if MANIFEST[n].get("city_map")]) == 10


@pytest.mark.parametrize("name", FILES)
def test_fixture_matches_manifest(name):
    """Each fixture: PIL still gives the manifest's digest, and the port
    the same bytes (white where PIL fails)."""
    rec = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == rec["bytes"]
    if rec.get("white"):
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises((OSError, ValueError)):
            textures._decode_image(path)
        return
    pil = _pil(data)
    assert list(pil.shape) == rec["shape"]
    assert hashlib.sha256(pil.tobytes()).hexdigest() == rec["rgba_sha256"]
    np.testing.assert_array_equal(textures._decode_image(path), pil)


@pytest.mark.parametrize("restart", [1, 2, 5, 13])
def test_encoder_restart_interval(restart):
    """`encode_jpeg(img, restart)`: RSTn every `restart` MCUs, decoded as
    PIL decodes it; no interval gives the old stream."""
    img = _image(np.random.default_rng(restart), 50, 70, 3)
    data = jpeg.encode_jpeg(img, restart=restart)
    assert len(_markers(data, range(0xD0, 0xD8))) == -(-5 * 4 // restart) - 1
    np.testing.assert_array_equal(decode_jpeg(data), _pil(data))
    assert jpeg.encode_jpeg(img, restart=0) == jpeg.encode_jpeg(img)


@pytest.fixture(scope="module")
def jpeg_city(tmp_path_factory):
    """The small frames' JPEG-recovery city, as chip_smoke.py writes
    `tcityjpeg4`."""
    root = str(tmp_path_factory.mktemp("tcityjpeg4"))
    written = assets.write_city_assets(root, map_size=256, emissive_size=128,
                                       ground_size=(256, 512),
                                       formats="jpegrec")
    return root, written, assets.write_city_ron(root, n=4)


@pytest.mark.parametrize("map_size", [256, 2048])
def test_city_maps_as_pil(map_size, jpeg_city, tmp_path):
    """Every map of the JPEG-recovery city decodes, in PIL and in the
    port, to the same bytes (the lossless ones to their writer's texels);
    at 2048^2 each equals the manifest's PIL digest, which chip_smoke.py's
    format_phase holds the card's host to."""
    if map_size == 256:
        root, written = jpeg_city[:2]
    else:
        root = str(tmp_path)
        written = assets.write_city_assets(root, ground_size=(64, 128),
                                           formats="jpegrec")
    kinds = collections.Counter()
    for name, (_img, want) in sorted(written.items()):
        path = os.path.join(root, "meshes", name)
        pil = _pil(open(path, "rb").read())
        got = textures._decode_image(path)
        np.testing.assert_array_equal(got, pil, err_msg=name)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        kinds["exact" if want is not None else "pil"] += 1
        if map_size == 2048:
            rec = MANIFEST["city/jpegrec/" + name]
            assert rec["bytes"] == os.path.getsize(path)
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                rec["rgba_sha256"], name
    assert kinds == {"exact": 3, "pil": 7}


def test_city_maps_are_damaged(jpeg_city):
    """The city's maps are the damaged kinds they stand for: a base colour
    whose scan ends before the image (its bottom rows grey), normals with
    one RSTn out of sequence, lossless metallic-roughness, an emissive map
    that differs from its clean encoding."""
    root, written, _ = jpeg_city
    path = os.path.join(root, "meshes", "b0_base.jpg")
    data = open(path, "rb").read()
    assert data.endswith(b"\xff\xd9")
    base = textures._decode_image(path)
    assert (base[-8:, :, :3] == base[-1, -1, :3]).all()
    data = open(os.path.join(root, "meshes", "b0_normal.jpg"), "rb").read()
    nums = [data[i + 1] - 0xD0 for i in _markers(data, range(0xD0, 0xD8))]
    assert sum(b != (a + 1) % 8 for a, b in zip(nums, nums[1:])) == 2
    data = open(os.path.join(root, "meshes", "b0_mr.jpg"), "rb").read()
    assert b"\xff\xc3" in data
    img, _ = written["b1_emissive.jpg"]
    clean = decode_jpeg(jpeg.encode_jpeg(img))
    assert not np.array_equal(
        textures._decode_image(os.path.join(root, "meshes",
                                            "b1_emissive.jpg")), clean)


def test_jpeg_city_bake_matches_jax(jpeg_city):
    """`tcityjpeg4`'s maps through both bakes: the same atlas bytes and
    slot table, no map white that JAX decodes."""
    root, _written, _ = jpeg_city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.jpg")))
    assert len(srcs) == 10
    from kajiya_tpu.scene import textures as tex_j

    atlas_t, sub_t = textures.bake_texture_pages(srcs)
    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


@pytest.fixture(scope="module")
def jpeg_scenes(jpeg_city):
    """`tcityjpeg4` loaded whole (.ron -> glTF -> bake -> trace scene) by
    both packages."""
    from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
    from kajiya_tpu.scene.scene import load_ron_scene as load_ron_j
    from kajiya_tpu.world import build_trace_scene as build_ts_j
    from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
    from kajiya_tpu_torch.scene.scene import load_ron_scene as load_ron_t
    from kajiya_tpu_torch.world import build_trace_scene as build_ts_t

    ron = jpeg_city[2]
    ts_j, _ = build_ts_j(build_gpu_j(load_ron_j(ron)))
    ts_t, _ = build_ts_t(build_gpu_t(load_ron_t(ron), device="cpu"),
                         device="cpu")
    return ts_j, ts_t


def test_jpeg_city_texture_tables_match(jpeg_scenes):
    """The scene tables of `tcityjpeg4` equal JAX's."""
    ts_j, ts_t = jpeg_scenes
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ts_t.gpu, f).cpu()),
            np.asarray(getattr(ts_j.gpu, f)), err_msg=f)


@pytest.mark.parametrize("cone", [False, True], ids=["static_mip", "cone"])
def test_jpeg_city_hit_attributes_match(jpeg_scenes, cone):
    """`tcityjpeg4`'s hits at the PNG city's tolerance, ATTR_TOL
    (tests/test_torch_frame_textured_formats.py)."""
    from test_torch_frame_textured_formats import _check_hit_attributes

    _check_hit_attributes(jpeg_scenes, cone)


def test_fixtures_bake_matches_jax():
    """Fixtures of each recovery through both bakes."""
    names = ("lossless_p4_rgb.jpg", "smooth_dc_rgb420.jpg",
             "rst_renumbered_next.jpg", "cut_eoi_restart.jpg",
             "badcode_flipped.jpg", "order_ac_before_dc.jpg",
             "lossless_h2v2_rgb.jpg", "cut_no_eoi_decodes.jpg",
             "arith_prog.jpg", "arith_dac.jpg")
    sources = []
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            sources.append(f.read())
    assert_bake_matches_jax(sources)
