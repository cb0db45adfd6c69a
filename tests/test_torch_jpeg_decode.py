"""The port's JPEG decoder (`kajiya_tpu_torch/scene/jpeg.py::decode_jpeg`,
host C++ `csrc/jpeg_decoder.cpp`) against PIL 12.1.0 on libjpeg-turbo, which
the JAX package's bake decodes textures with. Tolerance: byte for byte
(`np.asarray(Image.open(...).convert("RGBA"))`).

Files come from PIL's encoder (L, RGB, CMYK; 4:4:4, 4:2:2, 4:2:0, 4:1:1;
baseline and progressive; optimized tables; restart intervals; qualities
1-100; sizes from 1x1 to 2048 wide) and from the port's own encoder. A few
are edited by hand: a 4:4:0 frame (h1v2 upsampling), a YCCK frame, an RGB
frame without markers, and the frames the decoder refuses."""
import collections
import io
import struct
import time

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import textures
from kajiya_tpu_torch.scene.identify import Refused
from kajiya_tpu_torch.scene.jpeg import JpegError, decode_jpeg, encode_jpeg

SIZES = [(1, 1), (3, 5), (17, 33), (64, 48), (100, 131)]


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _image(rng, h, w, c):
    """Smooth content with noise (what textures hold), in c channels."""
    coarse = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, c), np.uint8)
    up = np.stack([np.asarray(Image.fromarray(coarse[..., i]).resize(
        (w, h), Image.BILINEAR)) for i in range(c)], -1).astype(np.int64)
    return np.clip(up + rng.integers(-20, 21, up.shape), 0, 255).astype(
        np.uint8)


def _save(img, mode, **kw):
    if mode == "L":
        im = Image.fromarray(img[..., 0])
    elif mode == "RGB":
        im = Image.fromarray(img)
    else:
        im = Image.frombytes("CMYK", img.shape[1::-1], img.tobytes())
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _same(data):
    np.testing.assert_array_equal(decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK"])
def test_decode_matches_pil(mode, subsampling, progressive):
    """Every mode, subsampling and process, at odd and even sizes, with and
    without optimized Huffman tables and a restart interval."""
    rng = np.random.default_rng(subsampling * 10 + progressive)
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    for i, (h, w) in enumerate(SIZES):
        for q, rst in ((5, 0), (50, 2), (90, 0), (100, 1)):
            data = _save(_image(rng, h, w, c), mode, quality=q,
                         subsampling=subsampling, progressive=progressive,
                         optimize=bool(i % 2), restart_marker_blocks=rst)
            assert (b"\xff\xc2" in data) == progressive
            _same(data)


def test_every_quality_matches_pil():
    """Qualities 1 to 100 (quantisers from 255 down to 1) on noise, which
    drives the inverse DCT to its output limits."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 40, 3), np.uint8)
    for q in range(1, 101):
        _same(_save(img, "RGB", quality=q, subsampling=q % 3,
                    progressive=bool(q % 2)))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_wide_image_matches_pil(progressive):
    """2048 wide, 4:2:0, with restart markers every row of MCUs."""
    rng = np.random.default_rng(8)
    data = _save(_image(rng, 24, 2048, 3), "RGB", quality=85,
                 progressive=progressive, restart_marker_rows=1)
    assert b"\xff\xd0" in data
    _same(data)


def test_port_encoder_output_matches_pil():
    rng = np.random.default_rng(9)
    for h, w in ((1, 1), (15, 17), (64, 96)):
        _same(encode_jpeg(_image(rng, h, w, 3)))


def _sof(data):
    """Offset of the frame header's marker."""
    i = 2
    while data[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return i


@pytest.mark.parametrize("case", ["411", "440", "ycck", "rgb_adobe",
                                  "rgb_ids", "sof1"])
def test_sampling_and_colour_variants_match_pil(case):
    """4:1:1 (box replication), 4:4:0 (h1v2 fancy upsampling: the sampling
    factors of a 4:2:2 frame of square 16-pixel MCUs swapped), YCCK (a CMYK
    frame's Adobe transform set to 2), RGB coded as RGB (Adobe transform 0,
    and component ids 'R' 'G' 'B' with no JFIF or Adobe marker), and an
    extended sequential (SOF1) frame."""
    rng = np.random.default_rng(10)
    if case == "411":
        data = _save(_image(rng, 40, 72, 3), "RGB", subsampling="4:1:1")
    elif case == "440":
        data = bytearray(_save(_image(rng, 48, 48, 3), "RGB", subsampling=1))
        i = _sof(data)
        assert data[i + 11] == 0x21
        data[i + 11] = 0x12
        data = bytes(data)
    elif case == "ycck":
        data = bytearray(_save(_image(rng, 33, 21, 4), "CMYK"))
        i = data.index(b"Adobe")
        assert data[i + 11] == 0
        data[i + 11] = 2
        data = bytes(data)
    elif case == "rgb_adobe":
        data = _save(_image(rng, 33, 21, 3), "RGB", keep_rgb=True)
        assert b"Adobe" in data
    elif case == "rgb_ids":
        data = bytearray(_save(_image(rng, 33, 21, 3), "RGB", quality=90))
        i = _sof(data)
        for k, cid in enumerate(b"RGB"):
            data[i + 10 + 3 * k] = cid
        j = data.index(b"\xff\xda")
        for k, cid in enumerate(b"RGB"):
            data[j + 5 + 2 * k] = cid
        assert data[2:4] == b"\xff\xe0"
        n = struct.unpack(">H", data[4:6])[0]
        data = bytes(data[:2] + data[4 + n:])      # drop the JFIF marker
    else:
        data = bytearray(_save(_image(rng, 33, 21, 3), "RGB"))
        data[_sof(data) + 1] = 0xC1
        data = bytes(data)
    _same(data)


def _progressive_scans(data):
    """Offsets of the SOS markers of a progressive file."""
    out, i = [], 0
    while True:
        i = data.find(b"\xff\xda", i + 1)
        if i < 0:
            return out
        out.append(i)


def test_block_smoothing_refused():
    """A progressive file whose last scans are missing (its first AC bands
    incomplete) is block-smoothed by libjpeg (decompress_smooth_data): the
    port smooths it too, to PIL's bytes, after every scan but the last
    two. The whole file decodes exactly."""
    rng = np.random.default_rng(11)
    data = _save(_image(rng, 32, 32, 3), "RGB", progressive=True)
    _same(data)
    scans = _progressive_scans(data)
    assert len(scans) > 4
    for k in range(1, len(scans) - 2):
        _same(data[:scans[k]] + b"\xff\xd9")


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "12bit",
                                  "hierarchical"])
def test_unported_frames_raise(case):
    """A baseline file's frame header relabelled: as arithmetic-coded
    (SOF9), libjpeg's arithmetic decoder reads the Huffman data as QM-coded
    bits, and the port gives PIL's bytes. A baseline scan under a lossless
    (SOF3) frame header has Ss 0, which libjpeg's lossless decoder refuses
    (JERR_BAD_PROGRESSION): PIL raises and the port raises JpegError. A
    12-bit frame is refused as PIL's `_open` refuses it ("cannot handle
    12-bit layers"), and a hierarchical one (SOF5) is corrupt as libjpeg's
    JERR_SOF_UNSUPPORTED makes PIL's load raise: all three bake white, as
    in the JAX package."""
    rng = np.random.default_rng(12)
    data = bytearray(_save(_image(rng, 16, 16, 3), "RGB"))
    i = _sof(data)
    if case == "12bit":
        data[i + 4] = 12
    else:
        data[i + 1] = {"arithmetic": 0xC9, "lossless": 0xC3,
                       "hierarchical": 0xC5}[case]
    if case in ("12bit", "hierarchical", "lossless"):
        with pytest.raises(Exception):
            _pil(bytes(data))
        with pytest.raises(Refused if case == "12bit" else JpegError):
            decode_jpeg(bytes(data))
        return
    _same(bytes(data))


def test_corrupt_files():
    """A file cut inside its entropy data (no EOI): PIL raises, so the port
    raises JpegError and the bake turns it white. A scan cut short but
    closed by EOI: libjpeg pads it with zeros and warns (PIL decodes it);
    the port decodes it to PIL's bytes. Bytes after SOI that hold no frame:
    both refuse (PIL's `_open` runs off the end)."""
    rng = np.random.default_rng(13)
    data = _save(_image(rng, 64, 64, 3), "RGB", quality=90)
    sos = data.index(b"\xff\xda")
    cut = data[:sos + (len(data) - sos) // 2]
    with pytest.raises(OSError):
        _pil(cut)
    with pytest.raises(JpegError, match="truncated"):
        decode_jpeg(cut)
    atlas, sub = textures.bake_texture_pages(
        ["data:image/jpeg;base64," + __import__("base64").b64encode(
            cut).decode()])
    page, size, ox, oy = sub[1]
    assert (atlas[page, oy:oy + size, ox:ox + size] == 255).all()
    closed = cut + b"\xff\xd9"
    _same(closed)
    junk = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64)
    with pytest.raises(Exception):
        _pil(junk)
    with pytest.raises(Refused):
        decode_jpeg(junk)


def _hostile(case):
    """A PIL-written file edited into one that PIL refuses."""
    rng = np.random.default_rng(15)
    data = bytearray(_save(_image(rng, 16, 16, 3), "RGB",
                           progressive=case == "selector_ac"))
    if case == "bomb":                          # 65535 x 65535 in SOF0
        i = _sof(data)
        data[i + 5:i + 9] = b"\xff\xff\xff\xff"
        return bytes(data)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    if case == "no_scan":
        return bytes(data[:sos[0]]) + b"\xff\xd9"
    # the first component's table selectors (Td, Ta) of a sequential scan,
    # or of a progressive AC scan, set to 5 and 5: libjpeg has 4 tables
    k = sos[0] if case == "selector" else next(
        i for i in sos if data[i + 4] == 1 and data[i + 7] != 0)
    data[k + 6] = 0x55
    return bytes(data)


@pytest.mark.parametrize("case", ["selector", "selector_ac", "bomb",
                                  "no_scan"])
def test_refused_headers_bake_white_in_both(case):
    """Headers PIL refuses: a Huffman table selector above 3 (libjpeg errs
    where the scan uses the table), a 65535 x 65535 frame (PIL's
    decompression-bomb limit; the port parses its markers without
    allocating the image), and a frame with no scan. The port raises
    ValueError (JpegError where libjpeg's parser refuses the file, Refused
    where PIL's `_open` does), and both packages' bakes turn it white."""
    from kajiya_tpu.scene import textures as tex_j

    data = _hostile(case)
    with pytest.raises(Exception):
        _pil(data)
    want = {"bomb": ValueError, "no_scan": Refused}.get(case, JpegError)
    with pytest.raises(want):
        decode_jpeg(data)
    uri = "data:image/jpeg;base64," + __import__("base64").b64encode(
        data).decode()
    atlas_t, sub_t = textures.bake_texture_pages([uri])
    atlas_j, sub_j = tex_j.build_texture_pages([uri])
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    page, size, ox, oy = sub_t[1]
    assert (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


def test_decode_2048_is_fast():
    """A 2048^2 4:2:0 texture decodes exactly and well under a second on
    one core (the bound allows for a loaded test machine)."""
    rng = np.random.default_rng(14)
    img = _image(rng, 256, 256, 3)
    big = np.asarray(Image.fromarray(img).resize((2048, 2048),
                                                 Image.BICUBIC))
    data = _save(big, "RGB", quality=90)
    t0 = time.perf_counter()
    out = decode_jpeg(data)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(out, _pil(data))
    assert dt < 3.0, dt


def _gradient_jpeg():
    """The 64x64 gradient of the marker and table sweeps, at quality 75."""
    y, x = np.mgrid[0:64, 0:64]
    img = np.stack([(7 * x) % 256, (5 * y) % 256, (3 * (x + y)) % 256],
                   -1).astype(np.uint8)
    return _save(img, "RGB", quality=75)


def _pil_or_none(data):
    try:
        return _pil(data)
    except Exception:
        return None


def _port_or_none(data, unported_ok):
    """The bake's decode (None where it turns white); NotImplementedError
    passes as "unported" where the caller allows it."""
    uri = "data:image/jpeg;base64," + __import__("base64").b64encode(
        data).decode()
    try:
        return textures._decode_image(uri)
    except NotImplementedError:
        if not unported_ok:
            raise
        return "unported"
    except (OSError, ValueError):
        return None


def _assert_as_pil(data, unported_ok=False):
    """PIL's bytes, or an error where PIL raises (or NotImplementedError,
    with `unported_ok`); the outcome: "decoded", "refused" or "unported"."""
    want, got = _pil_or_none(data), _port_or_none(data, unported_ok)
    if isinstance(got, str):
        return got
    if want is None:
        assert got is None, "PIL raises, the port decodes"
        return "refused"
    assert got is not None, "PIL decodes, the port raises"
    np.testing.assert_array_equal(got, want)
    return "decoded"


@pytest.mark.parametrize("high", range(16))
def test_first_marker_code_as_pil(high):
    """Byte 3 (APP0's marker code) set to each value: `JpegImageFile._open`
    refuses a code outside its table and a frame header it cannot handle,
    walks on past a code with no handler, and libjpeg then fails on what it
    cannot read (a second SOI, JPG / JPGn, SOF5-7 / SOF13-15, DHP, EXP) or
    skips it (DNL, DAC). Decoded in both, or refused in both."""
    base = _gradient_jpeg()
    for v in range(16 * high, 16 * high + 16):
        data = bytearray(base)
        data[3] = v
        _assert_as_pil(bytes(data))


# the sweeps' files that raise NotImplementedError, by case: no change may
# send more of them there (PERF.md gives the outcomes)
AC_SYMBOL_UNPORTED = (0,) * 16
CUT_UNPORTED = (0,) * 6


@pytest.mark.parametrize("high", range(16))
def test_ac_table_symbol_as_pil(high):
    """Symbol 1 of the luma AC Huffman table (byte 232) set to each value:
    the garbled scan's coefficients leave the range in which libjpeg-turbo's
    SIMD inverse DCT (16-bit lanes) equals its C one, and its codes end the
    data early or match no table (warnings libjpeg decodes past). PIL's
    bytes or PIL's error."""
    base = _gradient_jpeg()
    assert base[210:212] == b"\xff\xc4"
    seen = collections.Counter()
    for v in range(16 * high, 16 * high + 16):
        data = bytearray(base)
        data[232] = v
        seen[_assert_as_pil(bytes(data), unported_ok=True)] += 1
    assert seen["unported"] <= AC_SYMBOL_UNPORTED[high], seen


def _fuzz_source(k):
    """The k-th base file of the cut-and-flip sweep: L, RGB or CMYK, noise
    or gradients, baseline or progressive, with or without restarts, each
    subsampling."""
    r = np.random.default_rng(k)
    w, h = int(r.integers(8, 70)), int(r.integers(8, 70))
    if k % 3 == 0:
        img = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
    else:
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([(7 * x) % 256, (5 * y) % 256, (3 * (x + y)) % 256],
                       -1).astype(np.uint8)
    im = Image.fromarray(img)
    mode = ("RGB", "L", "CMYK", "RGB")[k % 4]
    if mode != "RGB":
        im = im.convert(mode)
    kw = {"quality": int(r.integers(5, 100)),
          "subsampling": int(r.integers(0, 3))}
    if k % 5 == 1:
        kw["progressive"] = True
    if k % 7 == 2:
        kw["restart_marker_blocks"] = 2
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """600 seeded cut or flipped files (100 a case): PIL's bytes or PIL's
    error; never pixels that differ silently."""
    rng = np.random.default_rng(1600 + part)
    seen = collections.Counter()
    for t in range(100):
        data = bytearray(_fuzz_source((100 * part + t) % 41))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[_assert_as_pil(bytes(data), unported_ok=True)] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen
