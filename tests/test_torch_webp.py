"""Port parity: WebP textures (`scene/webp.py`, `csrc/webp_decoder.cpp`)
against PIL 12.1.0's `Image.open(f).convert("RGBA")`, which decodes with
libwebp 1.6.0's animation decoder.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises). The sweep goes wide
because a wrong table entry or rounding shows only in the contexts that
read it: lossless and lossy, quality 0 to 100, methods 0 to 6, sizes that
are not multiples of 16 (the cropped macroblock grid), RGBA with
transparent pixels at several alpha qualities (ALPH raw or lossless, with
its filters), grey images, few-colour images (colour indexing with pixel
bundling), noise and smooth pictures (every intra mode, the loop filters,
the fancy upsampler). Then animations (the first frame on its canvas),
VP8X files with ICCP / EXIF / XMP chunks, a hypothesis test that cuts and
flips bytes, the bake against JAX's atlas, the committed fixtures of
`tests/data/webp/` against their manifest (which `chip_smoke.py` holds
the card's host to), and the legacy city's lossless writer. Inputs are
made from numpy seeds."""
import functools
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from hypothesis import given
from hypothesis import strategies as st
from PIL import Image

from kajiya_tpu_torch.scene import webp
from test_torch_bmp import (FUZZ, assert_as_pil, assert_as_pil_or_unported,
                            assert_bake_matches_jax, pil_rgba, port_rgba)

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "webp")


def picture(rng, h, w, kind):
    y, x = np.mgrid[0:h, 0:w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    if kind == "few":
        pal = rng.integers(0, 256, (int(rng.integers(2, 20)), 4), np.uint8)
        return pal[rng.integers(0, len(pal), (h, w))]
    base = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y // 7) % 256,
                     255 - (x + y) % 256], -1)
    img = np.clip(base + rng.integers(-20, 20, (h, w, 4)), 0,
                  255).astype(np.uint8)
    if kind == "rgba":
        img[..., 3][img[..., 3] < 60] = 0
        return img
    if kind == "grey":
        return img[..., 0]
    return img[..., :3]


def encode(img, **kw):
    mode = {2: "L", 3: "RGB", 4: "RGBA"}[img.ndim if img.ndim == 2
                                         else img.shape[-1]]
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


SIZES = [(16, 16), (23, 37), (3, 5), (48, 64), (77, 100), (1, 1)]
KINDS = ["rgb", "rgba", "noise", "grey", "few"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", [0, 2, 4, 6])
def test_lossless(kind, method):
    rng = np.random.default_rng(method * 7 + len(kind))
    for h, w in SIZES:
        assert_as_pil(encode(picture(rng, h, w, kind), lossless=True,
                             method=method), must_decode=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("quality", [0, 10, 30, 50, 75, 90, 100])
def test_lossy(kind, quality):
    rng = np.random.default_rng(quality * 11 + len(kind))
    for i, (h, w) in enumerate(SIZES):
        assert_as_pil(encode(picture(rng, h, w, kind), quality=quality,
                             method=(quality + i) % 7), must_decode=True)


@pytest.mark.parametrize("alpha_quality", [0, 20, 50, 80, 100])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossy_alpha(alpha_quality, method):
    """ALPH: raw at alpha quality 100 with method 0, lossless otherwise,
    with the filters libwebp picks (none, horizontal, vertical,
    gradient)."""
    rng = np.random.default_rng(alpha_quality + method)
    for h, w in SIZES[:5]:
        img = picture(rng, h, w, "rgba")
        assert_as_pil(encode(img, quality=40, alpha_quality=alpha_quality,
                             method=method), must_decode=True)


@pytest.mark.parametrize("case", ["lossless", "lossy", "mixed", "kmax1",
                                  "minimize"])
def test_animation_first_frame(case):
    """The first frame of an animation on its zeroed canvas, as libwebp's
    animation decoder gives it to PIL."""
    rng = np.random.default_rng(len(case))
    frames = [Image.fromarray(picture(rng, 40, 60, "rgba"), "RGBA")
              for _ in range(3)]
    kw = {"lossless": dict(lossless=True), "lossy": dict(quality=50),
          "mixed": dict(allow_mixed=True),
          "kmax1": dict(lossless=True, kmax=1),
          "minimize": dict(quality=50, minimize_size=True)}[case]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, **kw)
    assert_as_pil(buf.getvalue(), must_decode=True)


@pytest.mark.parametrize("chunks", ["icc", "exif", "xmp", "all"])
def test_metadata_chunks(chunks):
    rng = np.random.default_rng(len(chunks))
    kw = {}
    if chunks in ("icc", "all"):
        kw["icc_profile"] = rng.integers(0, 256, 131, np.uint8).tobytes()
    if chunks in ("exif", "all"):
        kw["exif"] = b"Exif\0\0" + rng.integers(0, 256, 40,
                                                  np.uint8).tobytes()
    if chunks in ("xmp", "all"):
        kw["xmp"] = b"<x:xmpmeta/>"
    for lossless in (False, True):
        assert_as_pil(encode(picture(rng, 21, 30, "rgba"),
                             lossless=lossless, **kw), must_decode=True)


@functools.lru_cache(maxsize=None)
def _fuzz_base():
    rng = np.random.default_rng(21)
    img = picture(rng, 33, 45, "rgba")
    frames = [Image.fromarray(picture(rng, 20, 24, "rgba"), "RGBA")
              for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   quality=60)
    return [encode(img, quality=70), encode(img, lossless=True),
            encode(img, quality=70, alpha_quality=60),
            encode(img[..., :3], quality=20, method=6), buf.getvalue()]



@FUZZ
@given(st.data())
def test_corrupt_streams_as_pil(data):
    """Cut or flipped bytes anywhere (RIFF and chunk headers, the VP8
    partitions, the VP8L prefix codes, ALPH): PIL's bytes, or an error
    where libwebp refuses."""
    # the base files are made on first use: PIL writing at import would
    # register its plugins in another order than the other test modules see
    src = bytearray(_fuzz_base()[data.draw(st.integers(0, 4))])
    if data.draw(st.booleans()):
        src = src[:data.draw(st.integers(0, len(src)))]
    else:
        for _ in range(data.draw(st.integers(1, 4))):
            i = data.draw(st.integers(0, len(src) - 1))
            src[i] ^= 1 << data.draw(st.integers(0, 7))
    assert_as_pil_or_unported(bytes(src))


def _gradient(w=64, h=64):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(7 * x) % 256, (5 * y) % 256, (3 * (x + y)) % 256],
                    -1).astype(np.uint8)


def test_lossy_first_token_byte_ff():
    """A lossy file whose token partition starts with 0xFF: the bool
    decoder's value outgrows its range at once. libwebp loads 56 bits at a
    time while 8 bytes remain, so its 64-bit value drops other high bits
    than a byte-wise reader's; the first macroblock then reads less than the
    whole partition, and the frame decodes (a byte-wise reader ran past the
    end and raised). Its coefficients leave the 16-bit range in which the
    SSE2 transform equals libwebp's C one."""
    data = bytearray(encode(_gradient(), quality=70))
    assert len(data) == 412
    first = struct.unpack_from("<I", data, 20)[0] & 0xFFFFFF
    assert 20 + 10 + (first >> 5) == 135    # the token partition's start
    data[135] = 0xFF
    assert_as_pil(bytes(data), must_decode=True)


@pytest.mark.parametrize("seed", range(8))
def test_lossy_partitions_flipped(seed):
    """Seeded single flipped or set bytes in the lossy partitions of
    several pictures and qualities: PIL's bytes, or an error where libwebp
    refuses (out-of-range coefficients go through the wrapping transform)."""
    rng = np.random.default_rng(900 + seed)
    kinds = ("smooth", "noise", "rgba")
    for k in range(30):
        img = picture(np.random.default_rng(k), int(rng.integers(8, 70)),
                      int(rng.integers(8, 70)), kinds[k % 3])
        src = bytearray(encode(img, quality=int(rng.integers(5, 100))))
        start = src.index(b"VP8 ") + 18     # past the frame tag and sizes
        i = int(rng.integers(start, len(src)))
        src[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 else \
            src[i] ^ (1 << int(rng.integers(0, 8)))
        assert_as_pil(bytes(src))


def test_bake_matches_jax():
    rng = np.random.default_rng(22)
    img = picture(rng, 70, 90, "rgba")
    assert_bake_matches_jax([encode(img, quality=80),
                             encode(img, lossless=True),
                             encode(img[..., :3], quality=30)])


def test_fixtures_match_manifest():
    """The committed fixtures decode, in PIL and in the port, to the RGBA
    digests of `manifest.json` (which `chip_smoke.py` checks on the card's
    host, where there is no PIL)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == {"lossy.webp", "lossy_alpha.webp",
                             "lossless.webp", "animated.webp"}
    total = 0
    for name, rec in manifest.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        assert len(data) == rec["bytes"]
        for rgba in (pil_rgba(data), webp.decode_webp(data)):
            assert list(rgba.shape) == rec["shape"]
            assert max(rgba.shape[:2]) <= 512
            assert hashlib.sha256(rgba.tobytes()).hexdigest() == \
                rec["rgba_sha256"], name
    assert total < 200_000


def test_writer_decodes_to_its_texels():
    """`webp.encode_vp8l` (the legacy city's emissive map): PIL and the
    port both decode it to the texels it reports."""
    rng = np.random.default_rng(23)
    for shape in [(1, 1), (37, 29), (64, 64)]:
        img = rng.integers(0, 256, shape + (3,), np.uint8)
        data, want = webp.encode_vp8l(img)
        np.testing.assert_array_equal(pil_rgba(data), want)
        np.testing.assert_array_equal(port_rgba(data), want)
