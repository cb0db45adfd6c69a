"""Port parity: BLP textures (`scene/blp.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). Inputs from
numpy seeds: palette files PIL writes (BLP1 and BLP2, with and without
transparency), and hand-built ones for what PIL does not write: BLP2 DXT1
(with and without alpha, 3- and 4-colour blocks), DXT3 and DXT5 (also for
an RGB image, whose 4-byte pixels PIL's raw decoder reads as 3-byte ones),
sizes that are no multiple of 4, BLP1 JPEG (its shared header split at any
byte, a gap before the first mip, alpha on, a size that differs from the
JPEG's, a CMYK JPEG, whose colour space PIL sets to CMYK) and BLP1
palette files. PIL's
BLPFormatError (a NotImplementedError) for a compression or encoding it
has no decoder for, BLP2's raw BGRA among them, turns white in both bakes;
the port never raises NotImplementedError for it. A 300-file cut-and-flip
sweep and the bake against JAX's."""
import collections
import io
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            pil_saved, port_rgba, sweep_outcome)


def tables(offset0: int, length0: int) -> bytes:
    return struct.pack("<16I", offset0, *[0] * 15) + \
        struct.pack("<16I", length0, *[0] * 15)


def blp2_file(w, h, body, encoding=2, alpha=8, alpha_encoding=0,
              compression=1, palette=None) -> bytes:
    head = b"BLP2" + struct.pack("<iBBBBII", compression, encoding, alpha,
                                 alpha_encoding, 0, w, h)
    if palette is None:
        palette = bytes(1024)
    off = 20 + 128 + len(palette)
    return head + tables(off, len(body)) + palette + body


def blp1_jpeg(w, h, jpeg: bytes, split: int, alpha=0, gap=b"") -> bytes:
    """A BLP1 whose JPEG's first `split` bytes are the shared header."""
    head = b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
    shared, body = jpeg[:split], jpeg[split:]
    off = 28 + 128 + 4 + len(shared) + len(gap)
    return head + tables(off, len(body)) + struct.pack("<I", len(shared)) + \
        shared + gap + body


def blp1_palette(w, h, idx: bytes, palette: bytes, alpha=0,
                 encoding=4) -> bytes:
    head = b"BLP1" + struct.pack("<iIIIii", 1, alpha, w, h, encoding, 0)
    return head + tables(0, len(idx)) + palette + idx


def dxt_blocks(rng, w, h, kind):
    """Random DXT1 / DXT3 / DXT5 blocks for a w x h image, with both DXT1
    colour orders."""
    n = ((w + 3) // 4) * ((h + 3) // 4)
    size = 8 if kind == 0 else 16
    blocks = rng.integers(0, 256, (n, size), np.uint8)
    if kind == 0:
        blocks[::2, [0, 1, 2, 3]] = blocks[::2, [2, 3, 0, 1]]
    return blocks.tobytes()


def jpeg_bytes(rng, h, w, mode="RGB"):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img = np.repeat(np.repeat(img[::4, ::4], 4, 0), 4, 1)[:h, :w]
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 20)])
def test_pil_written(version, alpha, size):
    rng = np.random.default_rng(len(version) + size[0] + alpha)
    img = rng.integers(0, 256, size + (4,), np.uint8)
    buf = io.BytesIO()
    im = Image.fromarray(img).convert("P")
    if alpha:
        im.info["transparency"] = 3
    im.save(buf, "BLP", blp_version=version)
    assert_as_pil(buf.getvalue(), must_decode=True)


@pytest.mark.parametrize("kind", [0, 1, 7])
@pytest.mark.parametrize("alpha", [0, 8])
@pytest.mark.parametrize("size", [(4, 4), (9, 13), (32, 8), (1, 6)])
def test_dxt(kind, alpha, size):
    """PIL's Python DXT decoders: 565 colours shifted, integer
    interpolation, DXT1's 3-colour blocks (black, alpha 0 where the image
    has alpha), DXT3 / DXT5 alpha; the stream of whole blocks read as the
    image's rows."""
    rng = np.random.default_rng(kind * 100 + alpha + size[0])
    h, w = size
    data = blp2_file(w, h, dxt_blocks(rng, w, h, kind), alpha=alpha,
                     alpha_encoding=kind)
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("alpha", [0, 8])
def test_blp2_palette(alpha):
    rng = np.random.default_rng(alpha)
    w, h = 10, 7
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    idx = rng.integers(0, 256, w * h + 5, np.uint8).tobytes()
    data = blp2_file(w, h, idx, encoding=1, alpha=alpha, palette=pal)
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("alpha", [0, 8])
@pytest.mark.parametrize("encoding", [4, 5])
def test_blp1_palette(alpha, encoding):
    rng = np.random.default_rng(alpha + encoding)
    w, h = 11, 6
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    idx = rng.integers(0, 256, w * h, np.uint8).tobytes()
    assert_as_pil(blp1_palette(w, h, idx, pal, alpha, encoding),
                  must_decode=True)


@pytest.mark.parametrize("case", ["rgb", "grey", "cmyk", "alpha", "split-0",
                                  "split-mid", "gap", "smaller", "odd"])
def test_blp1_jpeg(case):
    """The JPEG's RGB read as BGR; a shared header split anywhere; a gap
    PIL skips; a BLP size that differs from the JPEG's (its bytes read as
    they come); a CMYK JPEG."""
    rng = np.random.default_rng(len(case))
    h, w = (13, 21) if case == "odd" else (16, 24)
    mode = {"grey": "L", "cmyk": "CMYK"}.get(case, "RGB")
    jpeg = jpeg_bytes(rng, h, w, mode)
    split = {"split-0": 0, "split-mid": len(jpeg) // 2}.get(case, 200)
    bw, bh = (w - 5, h - 3) if case == "smaller" else (w, h)
    data = blp1_jpeg(bw, bh, jpeg, split, alpha=8 if case == "alpha" else 0,
                     gap=b"\0" * 7 if case == "gap" else b"")
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", [
    "blp2-raw-bgra", "blp2-compression-0", "blp2-alpha-encoding-5",
    "blp2-encoding-4", "blp1-compression-2", "blp1-encoding-3",
    "short-palette", "short-dxt", "short-indices", "blp1-bad-jpeg",
    "blp1-larger", "zero-size", "short-header", "short-tables"])
def test_refused_and_white_as_pil(case):
    """Each of PIL's errors (its BLPFormatError, a NotImplementedError,
    among them) is white in both bakes, never NotImplementedError in the
    port."""
    rng = np.random.default_rng(11)
    w, h = 8, 8
    blocks = dxt_blocks(rng, w, h, 0)
    jpeg = jpeg_bytes(rng, h, w)
    data = {
        "blp2-raw-bgra": blp2_file(w, h, bytes(4 * w * h), encoding=3),
        "blp2-compression-0": blp2_file(w, h, blocks, compression=0),
        "blp2-alpha-encoding-5": blp2_file(w, h, blocks, alpha_encoding=5),
        "blp2-encoding-4": blp2_file(w, h, blocks, encoding=4),
        "blp1-compression-2": blp1_palette(w, h, bytes(64), bytes(1024))[:4]
        + struct.pack("<i", 2) + blp1_palette(w, h, bytes(64),
                                              bytes(1024))[8:],
        "blp1-encoding-3": blp1_palette(w, h, bytes(64), bytes(1024),
                                        encoding=3),
        "short-palette": blp2_file(w, h, b"", encoding=1)[:148 + 1000],
        "short-dxt": blp2_file(w, h, blocks)[:-1],
        "short-indices": blp2_file(w, h, bytes(63), encoding=1),
        "blp1-bad-jpeg": blp1_jpeg(w, h, b"\xff\xd8\xff\xe0garbage", 2),
        "blp1-larger": blp1_jpeg(w + 1, h, jpeg, 100),
        "zero-size": blp2_file(0, 4, blocks),
        "short-header": blp2_file(w, h, blocks)[:15],
        "short-tables": blp2_file(w, h, blocks)[:100],
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    kind = k % 6
    if kind < 2:
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        return pil_saved(img, "BLP", "P", blp_version=("BLP1", "BLP2")[kind])
    if kind < 5:
        ae = (0, 1, 7)[kind - 2]
        return blp2_file(w, h, dxt_blocks(rng, w, h, ae), alpha=8 * (k % 2),
                         alpha_encoding=ae)
    return blp1_jpeg(w, h, jpeg_bytes(rng, h, w), int(rng.integers(0, 300)))


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by part: none since the JPEG
# decoder follows libjpeg's recoveries (5 of 300 before)
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part): PIL's bytes, PIL's
    error, or NotImplementedError where an unported plugin accepts the
    bytes first; never pixels that differ."""
    rng = np.random.default_rng(2300 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data))) if rng.random() < 0.5 \
                    else int(rng.integers(0, min(len(data), 160)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data), inner=("JPEG",))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(18)
    img = rng.integers(0, 256, (30, 50, 4), np.uint8)
    assert_bake_matches_jax([
        pil_saved(img, "BLP", "P", blp_version="BLP2"),
        blp2_file(20, 12, dxt_blocks(rng, 20, 12, 7), alpha=8,
                  alpha_encoding=7),
        blp2_file(16, 16, dxt_blocks(rng, 16, 16, 0), alpha=0),
        blp1_jpeg(24, 16, jpeg_bytes(rng, 16, 24), 150)])

