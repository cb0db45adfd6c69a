"""Port parity: PBM / PGM / PPM / PFM textures (`scene/ppm.py`) against PIL
12.1.0's `Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). Inputs from
numpy seeds: files PIL writes (P4, P5, P6, 16-bit P5, Pf), and hand-built
ones for what PIL does not write: the plain formats P1-P3 with comments
inside and between tokens and blocks, every maxval class (255, 65535 for
grey, others through PIL's `PpmDecoder`: a P5 above 255 becomes mode I and
is clipped, a P6 is scaled), Pf of either byte order, PIL's own P0CMYK,
PyP, PyRGBA and PyCMYK. The refusal and white cases, a 300-file
cut-and-flip sweep and the bake against JAX's."""
import collections
import io

import numpy as np
import pytest
from PIL import Image

from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            pil_saved, port_rgba, sweep_outcome)


def pil_mode_saved(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PPM")
    return buf.getvalue()


def raw_file(magic: bytes, w: int, h: int, maxval, samples: np.ndarray,
             sep: bytes = b" ") -> bytes:
    head = magic + sep + b"%d%s%d" % (w, sep, h)
    if maxval is not None:
        head += sep + (maxval if isinstance(maxval, bytes) else
                       b"%d" % maxval)
    return head + b"\n" + samples.tobytes()


def plain_file(magic: bytes, w: int, h: int, maxval, values,
               comments: bool = False) -> bytes:
    head = [magic, b"%d" % w, b"%d" % h] + \
        ([b"%d" % maxval] if maxval is not None else [])
    body = [b"%d" % v for v in values]
    if comments:
        head.insert(1, b"# a comment\r")
        body = [t + (b" #x\n" if i % 7 == 3 else b"\n" if i % 5 == 0
                     else b" ") for i, t in enumerate(body)]
        return b"\n".join(head) + b"\n" + b"".join(body)
    return b" ".join(head) + b"\n" + b" ".join(body)


@pytest.mark.parametrize("mode", ["1", "L", "RGB"])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 20)])
def test_pil_written(mode, size):
    rng = np.random.default_rng(sum(map(ord, mode)) + size[0])
    img = rng.integers(0, 256, size + (4,), np.uint8)
    assert_as_pil(pil_saved(img, "PPM", mode), must_decode=True)


@pytest.mark.parametrize("kind", ["I16", "F", "F-neg"])
def test_pil_written_wide(kind):
    """A 16-bit PGM (maxval 65535, mode I, clipped at 255 by `convert`) and
    PFM (floats bottom-up, truncated and clipped)."""
    rng = np.random.default_rng(len(kind))
    if kind == "I16":
        data = pil_mode_saved(rng.integers(0, 700, (9, 13)).astype(np.int32))
    else:
        f = (rng.random((9, 13)) * 400 - 50).astype(np.float32)
        data = pil_mode_saved(f)
        if kind == "F-neg":     # the little-endian form: a negative scale
            head, _, body = data.partition(b"\n1.0\n")
            data = head + b"\n-1.0\n" + np.frombuffer(
                body, ">f4").astype("<f4").tobytes()
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("magic,maxval", [
    (b"P5", 1), (b"P5", 17), (b"P5", 255), (b"P5", 256), (b"P5", 1000),
    (b"P5", 65535), (b"P6", 100), (b"P6", 255), (b"P6", 300),
    (b"P6", 65535), (b"P0CMYK", 255), (b"P0CMYK", 7), (b"PyRGBA", 255),
    (b"PyCMYK", 255), (b"PyP", 255), (b"PyP", 9)])
def test_binary_maxvals(magic, maxval):
    """Raw where the maxval is 255 (or 65535 for grey), else PIL's
    `PpmDecoder` (round half to even, clipped where samples pass maxval)."""
    bands = {b"P5": 1, b"P6": 3, b"PyP": 1}.get(magic, 4)
    rng = np.random.default_rng(maxval)
    w, h = 11, 6
    v = rng.integers(0, min(maxval, 65535) * 5 // 4 + 1, w * h * bands)
    samples = v.astype(">u2") if maxval > 255 else \
        np.minimum(v, 255).astype(np.uint8)
    assert_as_pil(raw_file(magic, w, h, maxval, samples), must_decode=True)


@pytest.mark.parametrize("magic,maxval", [
    (b"P1", None), (b"P2", 255), (b"P2", 15), (b"P2", 1000), (b"P2", 65535),
    (b"P3", 255), (b"P3", 7), (b"P3", 4000)])
@pytest.mark.parametrize("comments", [False, True])
def test_plain(magic, maxval, comments):
    bands = 3 if magic == b"P3" else 1
    rng = np.random.default_rng(len(magic) + (maxval or 0))
    w, h = 9, 7
    values = rng.integers(0, (maxval or 1) + 1, w * h * bands)
    assert_as_pil(plain_file(magic, w, h, maxval, values, comments),
                  must_decode=True)


def test_plain_bitonal_without_spaces():
    """P1 tokens are one byte each: whitespace between them is optional."""
    rng = np.random.default_rng(3)
    bits = bytes(b"01"[int(b)] for b in rng.integers(0, 2, 40))
    assert_as_pil(b"P1\n8 5\n" + bits[:17] + b"\n# note\n" + bits[17:],
                  must_decode=True)


def test_plain_across_blocks():
    """A plain file longer than PIL's 1 MiB read block: a token and a
    comment cut by the block's end."""
    rng = np.random.default_rng(4)
    w, h = 300, 240
    vals = rng.integers(0, 65536, w * h * 3)
    body = bytearray(b" ".join(b"%d" % v for v in vals))
    cut = (1 << 20) - 20
    body[cut:cut] = b"\n# a comment across the block's end\n"
    assert_as_pil(b"P3 %d %d 65535\n" % (w, h) + bytes(body),
                  must_decode=True)


@pytest.mark.parametrize("case", [
    "bad-magic", "zero-size", "negative-size", "eof-in-header",
    "long-token", "bad-token", "maxval-zero", "maxval-65536", "scale-zero",
    "scale-inf", "short-raw", "short-plain", "plain-over-maxval",
    "plain-negative", "plain-bad-bit", "plain-long-data-token", "short-pf"])
def test_refused_and_white_as_pil(case):
    data = {
        "bad-magic": b"P7 2 2 255\n\0\0\0\0",
        "zero-size": b"P5 0 2 255\n",
        "negative-size": b"P5 -3 2 255\n" + b"\0" * 6,
        "eof-in-header": b"P6 2",
        "long-token": b"P5 123456789012 2 255\n",
        "bad-token": b"P5 2x 2 255\n\0\0\0\0",
        "maxval-zero": b"P5 2 2 0\n\0\0\0\0",
        "maxval-65536": b"P5 2 2 65536\n" + b"\0" * 8,
        "scale-zero": b"Pf 1 1 0.0\n\0\0\0\0",
        "scale-inf": b"Pf 1 1 inf\n\0\0\0\0",
        "short-raw": b"P6 2 2 255\n" + b"\1" * 11,
        "short-plain": b"P2 2 2 255 1 2 3",
        "plain-over-maxval": b"P2 2 1 10 3 11",
        "plain-negative": b"P2 2 1 10 3 -1",
        "plain-bad-bit": b"P1 2 1 0 2",
        "plain-long-data-token": b"P2 2 1 255 00000000001 3",
        "short-pf": b"Pf 2 1 -1.0\n" + b"\0" * 7,
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


@pytest.mark.parametrize("data", [
    b"P2 2 1 255 1 2 junk after the image", b"P5\t2\x0b1\x0c9\r\x05\x09",
    b"P6 1 1 +255\n\1\2\3", b"P2 2 1 1_0 1_0 0", b"P3 1 1 255 1 2 3 4 5",
    b"P1 3 1 1#c\n0 1"], ids=["trailing", "whitespace", "plus", "underscore",
                              "extra", "comment-in-token"])
def test_odd_tokens_as_pil(data):
    assert_as_pil(data)


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    kind = k % 8
    if kind < 3:
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        return pil_saved(img, "PPM", ("1", "L", "RGB")[kind])
    if kind == 3:
        return pil_mode_saved(rng.integers(0, 70000, (h, w)).astype(
            np.int32))
    if kind == 4:
        return pil_mode_saved(rng.random((h, w)).astype(np.float32) * 300)
    if kind == 5:
        return raw_file(b"P6", w, h, 1000, rng.integers(
            0, 1001, w * h * 3).astype(">u2"))
    magic, maxval = ((b"P2", 300), (b"P3", 255))[kind - 6]
    bands = 3 if magic == b"P3" else 1
    return plain_file(magic, w, h, maxval, rng.integers(
        0, maxval + 1, w * h * bands), comments=k % 3 == 0)


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by part
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part) over every kind above:
    PIL's bytes, PIL's error, or NotImplementedError where an unported
    plugin accepts the bytes first; never pixels that differ."""
    rng = np.random.default_rng(1900 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, min(len(data), 40)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (30, 50, 4), np.uint8)
    assert_bake_matches_jax([
        pil_saved(img, "PPM", "RGB"), pil_saved(img, "PPM", "L"),
        pil_mode_saved(rng.integers(0, 300, (20, 24)).astype(np.int32)),
        plain_file(b"P3", 7, 5, 1000, rng.integers(0, 1001, 105), True),
        raw_file(b"P6", 12, 9, 4095, rng.integers(0, 4096, 324).astype(
            ">u2"))])
