"""Port parity: SGI textures (`scene/sgi.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). Inputs from
numpy seeds: files PIL writes (uncompressed L, RGB, RGBA), and hand-built
ones for what PIL does not write: 16-bit uncompressed (`SGI16Decoder`),
RLE at 8 and 16 bits with runs and literals of random lengths, rows that
share data, a row that leaves samples unwritten (PIL's row buffer keeps the
previous row's there) and a row without its terminator (PIL stops with no
error). PIL's ValueError for a mode outside its table is white, with no
other plugin tried. The refusal and white cases, a 300-file cut-and-flip
sweep, the writer of the studio city's normal maps and the bake against
JAX's."""
import collections
import struct

import numpy as np
import pytest

from kajiya_tpu_torch.scene import sgi
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            pil_saved, port_rgba, sweep_outcome)


def header(w, h, z, bpc=1, rle=False, dimension=None):
    if dimension is None:
        dimension = 2 if z == 1 else 3
    head = bytearray(512)
    struct.pack_into(">HBBHHHH", head, 0, 474, int(rle), bpc, dimension, w,
                     h, z)
    return bytes(head)


def rle_row(samples: np.ndarray, rng, bpc: int) -> bytes:
    """One channel row as random runs and literals of 1 to 127 samples,
    then the terminator."""
    out, i, n = bytearray(), 0, len(samples)
    put = (lambda v: bytes([v])) if bpc == 1 else \
        (lambda v: struct.pack(">H", v))
    while i < n:
        k = int(min(n - i, rng.integers(1, 128)))
        run = rng.random() < 0.5 and (samples[i:i + k] == samples[i]).all()
        if run:
            out += put(k) + put(int(samples[i]))
        else:
            out += put(0x80 | k) + b"".join(put(int(v))
                                            for v in samples[i:i + k])
        i += k
    return bytes(out + put(0))


def rle_file(px: np.ndarray, rng, bpc: int = 1, rows=None) -> bytes:
    """(h, w, z) samples -> an RLE SGI; `rows` overrides a row's bytes (or
    bytes and stated length) by (channel, file row)."""
    h, w, z = px.shape
    body, starts, lengths = b"", [], []
    table = 512 + 8 * z * h
    cache = {}
    for c in range(z):
        for y in range(h):
            data = (rows or {}).get((c, y))
            if data is None:
                data = rle_row(px[h - 1 - y, :, c], rng, bpc)
            data, length = data if isinstance(data, tuple) else \
                (data, len(data))
            if data in cache:             # rows that share their bytes
                starts.append(cache[data])
            else:
                cache[data] = table + len(body)
                starts.append(table + len(body))
                body += data
            lengths.append(length)
    return header(w, h, z, bpc, rle=True) + \
        np.array(starts + lengths, ">u4").tobytes() + body


def runs_image(rng, h, w, z, top=256):
    return np.repeat(rng.integers(0, top, (h, (w + 1) // 2, z)), 2,
                     axis=1)[:, :w]


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 20)])
def test_pil_written(mode, size):
    rng = np.random.default_rng(sum(map(ord, mode)) + size[0])
    img = rng.integers(0, 256, size + (4,), np.uint8)
    assert_as_pil(pil_saved(img, "SGI", mode), must_decode=True)


@pytest.mark.parametrize("z", [1, 3, 4])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("rle", [False, True])
def test_depths_channels_compression(z, bpc, rle):
    rng = np.random.default_rng(z * 10 + bpc + 2 * rle)
    h, w = 13, 21
    px = runs_image(rng, h, w, z, 256 ** bpc)
    if rle:
        data = rle_file(px, rng, bpc)
    else:
        planes = np.moveaxis(px[::-1], -1, 0)
        data = header(w, h, z, bpc) + planes.astype(
            ">u2" if bpc == 2 else np.uint8).tobytes()
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("dimension", [1, 2])
def test_grey_dimensions(dimension):
    rng = np.random.default_rng(dimension)
    px = rng.integers(0, 256, (6, 9, 1))
    data = header(9, 6, 1, dimension=dimension) + px[::-1].astype(
        np.uint8).tobytes()
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", ["short-row", "unterminated", "empty-row"])
@pytest.mark.parametrize("bpc", [1, 2])
def test_rle_row_quirks(case, bpc):
    """A row that writes fewer samples than the width keeps the previous
    row's in the rest; a row whose bytes end without a terminator stops
    the decode there, with no error; a row of just the terminator."""
    rng = np.random.default_rng(len(case) + bpc)
    h, w = 7, 10
    px = rng.integers(0, 256 ** bpc, (h, w, 3))
    put = (lambda v: bytes([v])) if bpc == 1 else \
        (lambda v: struct.pack(">H", v))
    # "unterminated": a length of 2 counts two chunks, and the second is
    # not the terminator
    row = {"short-row": put(0x83) + put(1) + put(2) + put(3) + put(0),
           "unterminated": (put(0x81) + put(5) + put(0x81) + put(6), 2),
           "empty-row": put(0)}[case]
    data = rle_file(px, rng, bpc, rows={(1, 3): row})
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", [
    "bad-mode", "dimension-3-grey", "compression-2", "short-raw",
    "short-raw16", "zero-size", "short-header", "rle-offset-small",
    "rle-past-end", "rle-overrun", "rle-tables-short"])
def test_refused_and_white_as_pil(case):
    rng = np.random.default_rng(9)
    px = runs_image(rng, 5, 6, 3)
    good = rle_file(px, rng)
    tab = 512

    def patch(data, pos, fmt, value):
        data = bytearray(data)
        struct.pack_into(fmt, data, pos, value)
        return bytes(data)

    data = {
        "bad-mode": header(4, 4, 2) + b"\0" * 32,
        "dimension-3-grey": header(4, 4, 1, dimension=3) + b"\0" * 16,
        "compression-2": patch(header(2, 2, 1), 2, ">B", 2) + b"\0" * 4,
        "short-raw": header(4, 4, 3) + b"\0" * 47,
        "short-raw16": header(4, 4, 1, bpc=2) + b"\0" * 31,
        "zero-size": header(0, 4, 1) + b"\0" * 8,
        "short-header": header(4, 4, 1)[:11],
        "rle-offset-small": patch(good, tab, ">I", 100),
        "rle-past-end": patch(good, tab + 4, ">I", len(good) - 2),
        "rle-overrun": rle_file(px, rng, rows={(0, 0): b"\x7f\x05\x00"}),
        "rle-tables-short": good[:512 + 8 * 15 - 1],
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


def test_writer_decodes_to_its_texels():
    """`sgi.encode_sgi_rle` (the studio city's normal maps): PIL and the
    port both decode it to the texels it reports."""
    rng = np.random.default_rng(8)
    for shape in ((23, 64, 3), (9, 200, 4), (5, 1, 1), (12, 17)):
        img = (rng.integers(0, 256, shape) // 64 * 64).astype(np.uint8)
        data, want = sgi.encode_sgi_rle(img)
        np.testing.assert_array_equal(port_rgba(data), want)
        np.testing.assert_array_equal(pil_rgba(data), want)


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    kind = k % 6
    if kind < 2:
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        return pil_saved(img, "SGI", ("L", "RGBA")[kind])
    z = (1, 3, 4, 3)[kind - 2]
    bpc = 2 if kind == 5 else 1
    return rle_file(runs_image(rng, h, w, z, 256 ** bpc), rng, bpc)


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by part
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part): PIL's bytes, PIL's
    error, or NotImplementedError where an unported plugin accepts the
    bytes first; never pixels that differ."""
    rng = np.random.default_rng(2000 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data))) if rng.random() < 0.5 \
                    else int(rng.integers(0, min(len(data), 12)))
                if 12 <= i < 512 and rng.random() < 0.8:
                    i = 512 + i % max(1, len(data) - 512)
                i = min(i, len(data) - 1)
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(15)
    img = rng.integers(0, 256, (30, 50, 4), np.uint8)
    assert_bake_matches_jax([
        pil_saved(img, "SGI", "RGB"), pil_saved(img, "SGI", "RGBA"),
        rle_file(runs_image(rng, 20, 24, 3), rng),
        rle_file(runs_image(rng, 9, 31, 4, 65536), rng, 2),
        sgi.encode_sgi_rle(img[..., :3])[0]])
