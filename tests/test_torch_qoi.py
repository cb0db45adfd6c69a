"""Port parity: QOI textures (`scene/qoi.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). Inputs from
numpy seeds: files PIL writes (RGB, RGBA), and hand-built op streams for
what PIL's writer does not emit: an index op on an unset entry (PIL gives
(0, 0, 0, 0) and stores it at entry 0), a run first (PIL's index does not
take run pixels), every op at the data's end, a channel count other than 3
or 4 (RGBA). The refusal and white cases, a 300-file cut-and-flip sweep,
the writer of the studio city's emissive map and the bake against JAX's."""
import collections
import struct

import numpy as np
import pytest

from kajiya_tpu_torch.scene import qoi
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            pil_saved, port_rgba, sweep_outcome)


def qoi_file(w, h, ops: bytes, channels=4, end=True) -> bytes:
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops + \
        (b"\0" * 7 + b"\1" if end else b"")


def random_ops(rng, n):
    """`n` random ops of every kind (an index op may name an unset entry)."""
    out = bytearray()
    for _ in range(n):
        k = rng.integers(0, 6)
        if k == 0:
            out += bytes([int(rng.integers(0, 64))])
        elif k == 1:
            out += bytes([0x40 | int(rng.integers(0, 64))])
        elif k == 2:
            out += bytes([0x80 | int(rng.integers(0, 64)),
                          int(rng.integers(0, 256))])
        elif k == 3:
            out += bytes([0xC0 | int(rng.integers(0, 62))])
        elif k == 4:
            out += b"\xfe" + rng.integers(0, 256, 3, np.uint8).tobytes()
        else:
            out += b"\xff" + rng.integers(0, 256, 4, np.uint8).tobytes()
    return bytes(out)


def smooth(rng, h, w, c):
    """An image of runs, small steps and repeats, so every op kind shows in
    PIL's encoding."""
    base = rng.integers(0, 256, (h, 1, c))
    steps = rng.integers(-3, 4, (h, w, c)) * (rng.random((h, w, 1)) < 0.4)
    img = (base + np.cumsum(steps, 1)) % 256
    img[:, w // 2:] = img[:, :w - w // 2][:, ::-1]
    return img.astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 20), (2, 64)])
def test_pil_written(mode, size):
    rng = np.random.default_rng(sum(map(ord, mode)) + size[0])
    img = smooth(rng, *size, 4)
    assert_as_pil(pil_saved(img, "QOI", mode), must_decode=True)


@pytest.mark.parametrize("channels", [3, 4, 0, 7])
@pytest.mark.parametrize("seed", range(4))
def test_random_op_streams(channels, seed):
    """Random streams of every op: the index as PIL keeps it (runs leave
    it alone; an unset entry reads (0, 0, 0, 0))."""
    rng = np.random.default_rng(100 * channels + seed)
    w, h = 13, 9
    assert_as_pil(qoi_file(w, h, random_ops(rng, w * h), channels),
                  must_decode=True)


@pytest.mark.parametrize("case", ["run-first-then-index", "unset-index",
                                  "run-past-end", "no-end-marker"])
def test_index_and_run_quirks(case):
    ops = {
        # PIL's run does not store (0, 0, 0, 255) at its hash (53)
        "run-first-then-index": b"\xc2" + bytes([53]) + b"\xfe\1\2\3"
        + bytes([53]),
        # an unset entry gives (0, 0, 0, 0), stored at entry 0
        "unset-index": bytes([17, 0]) + b"\xff\x09\x08\x07\x06"
        + bytes([17, 0]),
        "run-past-end": b"\xfe\5\6\7" + b"\xfd",
        "no-end-marker": b"\xfe\5\6\7" + b"\xc5",
    }[case]
    assert_as_pil(qoi_file(3, 2, ops, end=case != "no-end-marker"),
                  must_decode=True)


@pytest.mark.parametrize("case", [
    "ends-before-op", "ends-in-rgb", "ends-in-rgba", "ends-in-luma",
    "zero-width", "short-header", "no-channels"])
def test_refused_and_white_as_pil(case):
    data = {
        "ends-before-op": qoi_file(4, 4, b"\xfe\1\2\3", end=False),
        "ends-in-rgb": qoi_file(1, 1, b"\xfe\1\2", end=False),
        "ends-in-rgba": qoi_file(1, 1, b"\xff\1\2\3", end=False),
        "ends-in-luma": qoi_file(1, 1, b"\xa0", end=False),
        "zero-width": qoi_file(0, 4, b""),
        "short-header": b"qoif\0\0\0\4\0\0",
        "no-channels": b"qoif\0\0\0\4\0\0\0\4",
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


def test_writer_decodes_to_its_texels():
    """`qoi.encode_qoi` (the studio city's emissive map): PIL and the port
    both decode it to the texels it reports, and runs of more than 62
    pixels, index hits and every difference op are all in it."""
    rng = np.random.default_rng(8)
    for shape in ((23, 64, 3), (9, 200, 4), (1, 1, 3), (40, 40, 4)):
        img = smooth(rng, *shape)
        img[:3, :] = img[0, 0]                    # a long run
        data, want = qoi.encode_qoi(img)
        np.testing.assert_array_equal(port_rgba(data), want)
        np.testing.assert_array_equal(pil_rgba(data), want)


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    kind = k % 4
    if kind < 2:
        return pil_saved(smooth(rng, h, w, 4), "QOI", ("RGB", "RGBA")[kind])
    if kind == 2:
        return qoi.encode_qoi(smooth(rng, h, w, 3))[0]
    return qoi_file(w, h, random_ops(rng, w * h), 4)


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by part
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part): PIL's bytes, PIL's
    error, or NotImplementedError where an unported plugin accepts the
    bytes first; never pixels that differ."""
    rng = np.random.default_rng(2100 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(16)
    assert_bake_matches_jax([
        pil_saved(smooth(rng, 30, 50, 4), "QOI", "RGB"),
        pil_saved(smooth(rng, 20, 17, 4), "QOI", "RGBA"),
        qoi_file(13, 9, random_ops(rng, 117), 4),
        qoi.encode_qoi(smooth(rng, 24, 24, 3))[0]])
