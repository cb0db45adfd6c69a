"""Port parity: FTEX textures (`scene/ftex.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). PIL writes
no FTEX, so the writer here makes every input from numpy seeds: raw RGB
and DXT1 (through PIL's `bcn` decoder, which the port shares with its DDS
reader), sizes that are no multiple of 4, a mip of more data than the
image needs, a negative mip length (PIL reads to the end), a format entry
that points anywhere in the file. PIL's failed `assert` on a format count
other than 1, its ValueError for an unknown format and its failed seek to
a negative offset are white in both bakes. A 300-file cut-and-flip sweep
and the bake against JAX's."""
import collections
import struct

import numpy as np
import pytest

from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            port_rgba, sweep_outcome)


def ftex_file(w, h, payload: bytes, fmt=1, format_count=1, where=None,
              size=None, gap=b"") -> bytes:
    """An FTEX of one format; `where` the offset of its mip (default right
    after the format entry, and `gap`), `size` the mip length it states."""
    head = b"FTEX" + struct.pack("<i2i2i", 1, w, h, 1, format_count)
    if where is None:
        where = len(head) + 8 + len(gap)
    head += struct.pack("<2i", fmt, where) + gap
    return head + struct.pack("<i", len(payload) if size is None else size) \
        + payload


def dxt1(rng, w, h):
    n = ((w + 3) // 4) * ((h + 3) // 4)
    blocks = rng.integers(0, 256, (n, 8), np.uint8)
    blocks[::2, [0, 1, 2, 3]] = blocks[::2, [2, 3, 0, 1]]
    return blocks.tobytes()


@pytest.mark.parametrize("fmt", [0, 1])
@pytest.mark.parametrize("size", [(1, 1), (4, 4), (7, 13), (32, 20)])
def test_formats(fmt, size):
    rng = np.random.default_rng(fmt * 100 + size[0])
    h, w = size
    payload = dxt1(rng, w, h) if fmt == 0 else \
        rng.integers(0, 256, w * h * 3, np.uint8).tobytes()
    assert_as_pil(ftex_file(w, h, payload, fmt), must_decode=True)


@pytest.mark.parametrize("case", ["extra-data", "negative-length", "gap",
                                  "mip-before-entry"])
def test_layout(case):
    rng = np.random.default_rng(len(case))
    w, h = 9, 6
    payload = rng.integers(0, 256, w * h * 3 + 17, np.uint8).tobytes()
    data = {
        "extra-data": ftex_file(w, h, payload),
        "negative-length": ftex_file(w, h, payload, size=-5),
        "gap": ftex_file(w, h, payload, gap=b"\0" * 11),
        "mip-before-entry": ftex_file(w, h, payload, where=8)
        + struct.pack("<i", 300) + payload,
    }[case]
    assert_as_pil(data)


@pytest.mark.parametrize("case", [
    "format-count-2", "format-count-0", "format-2", "negative-offset",
    "short-raw", "short-dxt1", "zero-size", "negative-size",
    "short-header", "short-mip-length", "offset-past-end"])
def test_refused_and_white_as_pil(case):
    rng = np.random.default_rng(12)
    w, h = 8, 8
    raw = rng.integers(0, 256, w * h * 3, np.uint8).tobytes()
    data = {
        "format-count-2": ftex_file(w, h, raw, format_count=2),
        "format-count-0": ftex_file(w, h, raw, format_count=0),
        "format-2": ftex_file(w, h, raw, fmt=2),
        "negative-offset": ftex_file(w, h, raw, where=-4),
        "short-raw": ftex_file(w, h, raw[:-1]),
        "short-dxt1": ftex_file(w, h, dxt1(rng, w, h)[:-1], fmt=0),
        "zero-size": ftex_file(0, h, raw),
        "negative-size": ftex_file(-8, h, raw),
        "short-header": ftex_file(w, h, raw)[:22],
        "short-mip-length": ftex_file(w, h, raw)[:34],
        "offset-past-end": ftex_file(w, h, raw, where=10_000),
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    if k % 2:
        return ftex_file(w, h, dxt1(rng, w, h), 0)
    return ftex_file(w, h, rng.integers(0, 256, w * h * 3,
                                        np.uint8).tobytes())


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by part
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part): PIL's bytes, PIL's
    error, or NotImplementedError where an unported plugin accepts the
    bytes first; never pixels that differ."""
    rng = np.random.default_rng(2400 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data))) if rng.random() < 0.5 \
                    else int(rng.integers(0, 36))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(19)
    assert_bake_matches_jax([
        ftex_file(24, 16, dxt1(rng, 24, 16), 0),
        ftex_file(30, 21, rng.integers(0, 256, 30 * 21 * 3,
                                       np.uint8).tobytes())])
