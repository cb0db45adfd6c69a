"""Port parity: PSD textures (`scene/psd.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). PIL writes
no PSD, so the writer here makes every input from numpy seeds: bitmap,
grey, duotone, multichannel, indexed (with and without its 768-byte colour
data), RGB (3 channels, 4 as RGBA, 5 as RGB), CMYK (read inverted), raw and
PackBits composites (PIL ignores the per-row byte counts: a run or literal
that passes its row's end is cut, 0x80 is a no-op), image resources and a
layer section of any content (PIL does not parse the layers to convert).
The refusal and white cases (16 bits: PIL's KeyError, a refusal; too few
channels: its OSError), LAB (through LittleCMS's transform), a 300-file
cut-and-flip sweep, the writer of the studio city's base colours and the
bake against JAX's."""
import collections
import struct

import numpy as np
import pytest

from kajiya_tpu_torch.scene import psd, textures
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            port_rgba, sweep_outcome, uri)


def packbits(row: bytes, rng=None) -> bytes:
    """PackBits of one row: runs of 2 to 128, literals of up to 128 (random
    splits with `rng`)."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        k = 128 if rng is None else int(rng.integers(1, 129))
        j = i
        while j < n and j - i < k and not (j + 1 < n and row[j + 1] == row[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def resource(rid: int, name: bytes, data: bytes) -> bytes:
    out = b"8BIM" + struct.pack(">HB", rid, len(name)) + name
    if not len(name) & 1:
        out += b"\0"
    out += struct.pack(">I", len(data)) + data
    return out + (b"\0" if len(data) & 1 else b"")


def psd_file(planes: np.ndarray, mode: int, bits: int = 8, comp: int = 1,
             channels=None, colour: bytes = b"", resources: bytes = b"",
             layers: bytes = b"", rng=None, rows=None) -> bytes:
    """(c, h, w) planes (bytes of packed bits for 1-bit) -> a PSD; `rows`
    replaces the PackBits body (a list of row strings, the counts stated
    as their lengths)."""
    c, h = planes.shape[:2]
    w = planes.shape[2] * 8 if bits == 1 else planes.shape[2]
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits,
                                 mode)
    head += struct.pack(">I", len(colour)) + colour
    head += struct.pack(">I", len(resources)) + resources
    head += struct.pack(">I", len(layers)) + layers
    if comp == 0:
        return head + struct.pack(">H", 0) + planes.astype(np.uint8).tobytes()
    if rows is None:
        rows = [packbits(planes[k, y].astype(np.uint8).tobytes(), rng)
                for k in range(c) for y in range(h)]
    return head + struct.pack(">H", comp) + np.array(
        [len(r) for r in rows], ">u2").tobytes() + b"".join(rows)


def runs(rng, c, h, w):
    return np.repeat(rng.integers(0, 256, (c, h, (w + 2) // 3)), 3,
                     axis=2)[..., :w].astype(np.uint8)


MODES = {"bitmap": (0, 1, 1), "grey": (1, 8, 1), "indexed": (2, 8, 1),
         "rgb": (3, 8, 3), "rgba": (3, 8, 4), "rgb5": (3, 8, 5),
         "cmyk": (4, 8, 4), "cmyk5": (4, 8, 5), "multichannel": (7, 8, 1),
         "duotone": (8, 8, 1), "bitmap-as-grey": (0, 8, 1)}


@pytest.mark.parametrize("name", sorted(MODES))
@pytest.mark.parametrize("comp", [0, 1])
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (20, 33)])
def test_modes(name, comp, size):
    mode, bits, c = MODES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + comp + size[0])
    h, w = size
    planes = runs(rng, c, h, (w + 7) // 8 if bits == 1 else w)
    colour = b""
    if name == "indexed":
        colour = rng.integers(0, 256, 768, np.uint8).tobytes()
    elif name == "duotone":
        colour = b"duotone spec"
    assert_as_pil(psd_file(planes, mode, bits, comp, colour=colour, rng=rng),
                  must_decode=True)


@pytest.mark.parametrize("case", ["no-colour-data", "short-colour-data"])
def test_indexed_without_palette(case):
    """An indexed PSD whose colour data is not 768 bytes has no palette:
    every index is black in PIL."""
    rng = np.random.default_rng(3)
    colour = b"" if case == "no-colour-data" else b"\1" * 700
    assert_as_pil(psd_file(runs(rng, 1, 6, 9), 2, colour=colour),
                  must_decode=True)


@pytest.mark.parametrize("case", ["resources", "layers", "garbage-layers",
                                  "odd-resource"])
def test_sections_skipped(case):
    rng = np.random.default_rng(4)
    planes = runs(rng, 3, 8, 10)
    kw = {"resources": dict(resources=resource(1039, b"", b"icc")
                            + resource(1005, b"ab", b"\0" * 16)),
          "layers": dict(layers=struct.pack(">I", 4) + b"\0\1\0\0"),
          "garbage-layers": dict(layers=struct.pack(">I", 40)
                                 + rng.integers(0, 256, 40,
                                                np.uint8).tobytes()),
          "odd-resource": dict(resources=resource(7, b"x", b"odd"))}[case]
    assert_as_pil(psd_file(planes, 3, **kw), must_decode=True)


@pytest.mark.parametrize("case", ["run-across-rows", "literal-across-rows",
                                  "nop", "counts-ignored"])
def test_packbits_quirks(case):
    """PIL's PackBits decodes each channel from its offset to the end: a
    run or literal that passes its row's end loses the rest, 0x80 is a
    no-op, and the byte counts only place the next channel."""
    rng = np.random.default_rng(len(case))
    w, h = 6, 4
    planes = runs(rng, 1, h, w)
    rows = [packbits(planes[0, y].tobytes()) for y in range(h)]
    if case == "run-across-rows":
        rows[1] = bytes([257 - 9, 77]) + rows[1]
    elif case == "literal-across-rows":
        rows[2] = bytes([7]) + bytes(range(8)) + rows[2]
    elif case == "nop":
        rows = [b"\x80" + r for r in rows]
    else:
        rows = [r + b"\x80\x80" for r in rows]
    assert_as_pil(psd_file(planes, 1, rows=rows), must_decode=True)


@pytest.mark.parametrize("case", [
    "16-bit", "32-bit", "not-enough-channels", "mode-5", "zero-width",
    "version-2", "short-header", "short-counts", "truncated-raw",
    "truncated-packbits", "compression-2", "short-resource"])
def test_refused_and_white_as_pil(case):
    rng = np.random.default_rng(6)
    planes = runs(rng, 3, 5, 8)
    good = psd_file(planes, 3)
    data = {
        "16-bit": psd_file(planes, 3, bits=16),
        "32-bit": psd_file(planes, 1, bits=32),
        "not-enough-channels": psd_file(planes[:2], 3),
        "mode-5": psd_file(planes, 5),
        "zero-width": psd_file(planes[:, :, :0], 3),
        "version-2": good[:4] + b"\0\2" + good[6:],
        "short-header": good[:20],
        "short-counts": good[:26 + 12 + 2 + 10],
        "truncated-raw": psd_file(planes, 3, comp=0)[:-3],
        "truncated-packbits": good[:-2],
        "compression-2": psd_file(planes, 3, comp=2),
        "short-resource": psd_file(planes, 3, resources=b"8BIM\0\1\5ab"),
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


def test_lab_raises_unported():
    """LAB (mode 9) reaches PIL's LittleCMS conversion, which the port now
    mirrors (`scene/lab.py`): PIL's bytes, raw and PackBits, with the
    planes copied as PIL copies them (alpha 0), and NotImplementedError no
    more (the name is the test's earlier one)."""
    rng = np.random.default_rng(7)
    for comp in (0, 1):
        data = psd_file(runs(rng, 3, 6, 8), 9, comp=comp)
        assert pil_rgba(data) is not None
        np.testing.assert_array_equal(textures._decode_image(uri(data)),
                                      pil_rgba(data))


def test_writer_decodes_to_its_texels():
    """`psd.encode_psd` (the studio city's base colours, 4 channels): PIL
    and the port both decode it to the texels it reports."""
    rng = np.random.default_rng(8)
    for shape in ((23, 64, 4), (9, 300, 3), (1, 1, 4)):
        img = (rng.integers(0, 256, shape) // 64 * 64).astype(np.uint8)
        if shape[2] == 4:
            img[..., 3] = 255
        data, want = psd.encode_psd(img)
        np.testing.assert_array_equal(port_rgba(data), want)
        np.testing.assert_array_equal(pil_rgba(data), want)


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    name = sorted(MODES)[k % len(MODES)]
    mode, bits, c = MODES[name]
    planes = runs(rng, c, h, (w + 7) // 8 if bits == 1 else w)
    colour = rng.integers(0, 256, 768, np.uint8).tobytes() \
        if name == "indexed" else b""
    return psd_file(planes, mode, bits, comp=k % 3 != 0, colour=colour,
                    resources=resource(1005, b"", b"\0" * 6) if k % 4 == 1
                    else b"", rng=rng)


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by
# part
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part): PIL's bytes, PIL's
    error, or NotImplementedError; never pixels that differ."""
    rng = np.random.default_rng(2200 + part)
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
    rng = np.random.default_rng(17)
    img = rng.integers(0, 256, (30, 50, 4), np.uint8)
    img[..., 3] = 255
    assert_bake_matches_jax([
        psd.encode_psd(img)[0], psd.encode_psd(img[..., :3])[0],
        psd_file(runs(rng, 4, 12, 20), 4, comp=0),
        psd_file(runs(rng, 1, 9, 14), 2,
                 colour=rng.integers(0, 256, 768, np.uint8).tobytes())])
