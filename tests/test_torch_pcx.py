"""Port parity: PCX and DCX textures (`scene/pcx.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises). Inputs from numpy
seeds: files PIL writes (1-bit, 8-bit grey and palette, 24-bit), and
hand-built ones for what PIL does not write: 1-bit images of 2 and 4
planes with the header's EGA palette, odd widths whose header stride
differs (PIL evens it and moves the planes), 8-bit files whose trailing
palette is the grey ramp, another palette or no palette, files shorter
than 769 bytes (a file on disk and a data URI differ there), DCX
directories. The refusal and white cases, a 300-file cut-and-flip sweep,
the writer of the studio city's metallic-roughness maps and the bake
against JAX's."""
import collections
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import pcx, textures
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            pil_saved, port_rgba, sweep_outcome)


def rle(row: bytes) -> bytes:
    """PCX RLE of one row, runs of up to 63 (a lone byte below 0xC0
    literal)."""
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 62:
            j += 1
        if j > i or row[i] >= 0xC0:
            out.append(0xC0 | (j - i + 1))
        out.append(row[i])
        i = j + 1
    return bytes(out)


def pcx_file(w, h, rows, version=5, bits=8, planes=1, stride=None,
             ega=b"", tail=b"", origin=(0, 0)):
    """A PCX of `rows` (h, planes * stride) uint8, RLE-coded row by row;
    `stride` the header's (default the even row length), `tail` what
    follows the image data (a palette)."""
    if stride is None:
        stride = rows.shape[1] // planes
    head = bytearray(128)
    x0, y0 = origin
    struct.pack_into("<BBBBHHHH", head, 0, 10, version, 1, bits, x0, y0,
                     x0 + w - 1, y0 + h - 1)
    head[16:16 + len(ega)] = ega
    head[65] = planes
    struct.pack_into("<H", head, 66, stride)
    body = b"".join(rle(bytes(r)) for r in rows)
    return bytes(head) + body + tail


def planes_rows(px, planes, stride):
    """(h, w) indices -> rows of `planes` bit planes of `stride` bytes."""
    h, w = px.shape
    rows = np.zeros((h, planes, stride), np.uint8)
    for k in range(planes):
        bits = np.packbits((px >> k) & 1, axis=1)
        rows[:, k, :bits.shape[1]] = bits
    return rows.reshape(h, planes * stride)


def palette_tail(pal):
    return b"\x0c" + np.asarray(pal, np.uint8).tobytes()


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 20), (16, 3)])
def test_pil_written(mode, size):
    rng = np.random.default_rng(sum(map(ord, mode)) + size[0])
    img = rng.integers(0, 256, size + (4,), np.uint8)
    # PIL cannot read back its own 24-bit PCX of width 1 (a stride of 1
    # and three planes trip its band move); both bakes turn it white
    assert_as_pil(pil_saved(img, "PCX", mode),
                  must_decode=(mode, size) != ("RGB", (1, 1)))


@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("w", [3, 8, 13, 16, 40])
@pytest.mark.parametrize("odd_header", [False, True])
def test_bit_planes(planes, w, odd_header):
    """1-bit images of 2 or 4 planes: the EGA palette of the header, the
    stride evened where the header's differs (and PIL's plane move when a
    row is longer than the width)."""
    rng = np.random.default_rng(planes * 100 + w)
    h = 9
    px = rng.integers(0, 1 << planes, (h, w)).astype(np.uint8)
    stride = (w + 7) // 8
    header_stride = stride + 1 if odd_header else stride
    if odd_header:
        stride += stride % 2
    rows = planes_rows(px, planes, stride)
    ega = rng.integers(0, 256, 48, np.uint8).tobytes()
    data = pcx_file(w, h, rows, version=2, bits=1, planes=planes,
                    stride=header_stride, ega=ega)
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("w", [1, 2, 7, 8, 9, 30])
def test_one_bit(w):
    rng = np.random.default_rng(w)
    px = rng.integers(0, 2, (6, w)).astype(np.uint8)
    stride = (w + 7) // 8
    data = pcx_file(w, 6, planes_rows(px, 1, stride), version=0, bits=1,
                    origin=(3, 4))
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", ["ramp", "palette", "no-marker",
                                  "short-palette", "odd-stride"])
def test_eight_bit_palette(case):
    """Version 5, 8 bits: grey where the 769 bytes at the end are the grey
    ramp or no palette, else a palette image."""
    rng = np.random.default_rng(len(case))
    w, h = (11, 37) if case == "odd-stride" else (24, 30)
    px = rng.integers(0, 256, (h, w)).astype(np.uint8)
    stride = w + (w & 1)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = px
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    tail = {"ramp": palette_tail(ramp),
            "palette": palette_tail(rng.integers(0, 256, (256, 3))),
            "no-marker": b"\x0b" + ramp.tobytes(),
            "short-palette": palette_tail(ramp)[:600],
            "odd-stride": palette_tail(rng.integers(0, 256, (256, 3)))}[case]
    data = pcx_file(w, h, rows, stride=w, tail=tail)
    assert_as_pil(data, must_decode=True)


def test_short_file_on_disk_and_in_memory(tmp_path):
    """An 8-bit PCX of fewer than 769 bytes: PIL's seek back from the end
    fails on a file (white) and stops at the start in memory (grey)."""
    rows = np.arange(16, dtype=np.uint8).reshape(4, 4)
    data = pcx_file(4, 4, rows)
    assert len(data) < 769
    assert_as_pil(data, must_decode=True)
    path = tmp_path / "small.pcx"
    path.write_bytes(data)
    with pytest.raises(OSError):
        Image.open(path).convert("RGBA")
    with pytest.raises(ValueError):
        textures._decode_image(str(path))
    big = pcx_file(4, 4, rows, tail=b"\0" * 800)
    path.write_bytes(big)
    np.testing.assert_array_equal(
        textures._decode_image(str(path)),
        np.asarray(Image.open(path).convert("RGBA")))


def _rgb(w, h, rng):
    stride = w + (w & 1)
    rows = np.zeros((h, 3, stride), np.uint8)
    rows[:, :, :w] = rng.integers(0, 256, (h, 3, w))
    return rows.reshape(h, 3 * stride), stride


@pytest.mark.parametrize("case", [
    "unknown-mode", "version-4-8bit", "overrun", "truncated", "bad-bbox",
    "short-header", "dcx-empty", "dcx-unknown-mode", "dcx-short"])
def test_refused_and_white_as_pil(case):
    """PIL's OSError for a mode it has no reader for, an RLE run that
    passes its row's end and data that ends first turn white; a bad size,
    a short header and an empty DCX directory are refusals (white here,
    where no other plugin accepts the bytes)."""
    rng = np.random.default_rng(5)
    rows, stride = _rgb(6, 5, rng)
    good = pcx_file(6, 5, rows, planes=3, stride=stride)
    data = {
        "unknown-mode": pcx_file(6, 5, rows, bits=4, planes=3,
                                 stride=stride),
        "version-4-8bit": pcx_file(6, 5, rows, version=4, planes=3,
                                   stride=stride),
        "overrun": good[:128] + b"\xff\x07" + good[128:],
        "truncated": good[:-5],
        "bad-bbox": good[:4] + b"\x10\0" + good[6:],
        "short-header": good[:60],
        "dcx-empty": struct.pack("<II", 0x3ADE68B1, 0) + good,
        "dcx-unknown-mode": struct.pack("<III", 0x3ADE68B1, 12, 0)
        + pcx_file(6, 5, rows, bits=4, planes=3, stride=stride),
        "dcx-short": struct.pack("<IH", 0x3ADE68B1, 8),
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None


@pytest.mark.parametrize("pages", [1, 3])
def test_dcx_first_page(pages):
    rng = np.random.default_rng(pages)
    files = []
    for _ in range(pages):
        rows, stride = _rgb(9, 7, rng)
        files.append(pcx_file(9, 7, rows, planes=3, stride=stride))
    offsets, pos = [], 4 + 4 * (pages + 1)
    for f in files:
        offsets.append(pos)
        pos += len(f)
    data = struct.pack(f"<I{pages + 1}I", 0x3ADE68B1, *offsets, 0) + \
        b"".join(files)
    assert_as_pil(data, must_decode=True)


def test_writer_decodes_to_its_texels():
    """`pcx.encode_pcx_rgb` (the studio city's metallic-roughness maps):
    PIL and the port both decode it to the texels it reports."""
    rng = np.random.default_rng(8)
    for w in (1, 64, 77):
        img = (rng.integers(0, 256, (23, w, 3)) // 64 * 64).astype(np.uint8)
        data, want = pcx.encode_pcx_rgb(img)
        np.testing.assert_array_equal(port_rgba(data), want)
        np.testing.assert_array_equal(pil_rgba(data), want)


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    img[:, ::3] = img[:, :1]                      # runs for the RLE
    kind = k % 6
    if kind < 4:
        return pil_saved(img, "PCX", ("1", "L", "P", "RGB")[kind])
    planes = 2 if kind == 4 else 4
    stride = (w + 7) // 8
    rows = planes_rows((img[..., 0] % (1 << planes)).astype(np.uint8),
                       planes, stride)
    data = pcx_file(w, h, rows, version=3, bits=1, planes=planes,
                    ega=img[0, :16, :3].tobytes())
    if k % 4 == 1:      # as a DCX page
        data = struct.pack("<III", 0x3ADE68B1, 12, 0) + data
    return data


# the sweep's files that raise NotImplementedError (a cut or flipped header
# that an unported plugin accepts first), by part
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped files (50 a part) over every mode above:
    PIL's bytes, PIL's error, or NotImplementedError where an unported
    plugin accepts the bytes first; never pixels that differ."""
    rng = np.random.default_rng(1800 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, min(len(data), 140)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (30, 50, 4), np.uint8)
    rows, stride = _rgb(21, 17, rng)
    assert_bake_matches_jax([
        pil_saved(img, "PCX", "RGB"), pil_saved(img, "PCX", "P"),
        pil_saved(img, "PCX", "L"),
        struct.pack("<III", 0x3ADE68B1, 12, 0)
        + pcx_file(21, 17, rows, planes=3, stride=stride),
        pcx.encode_pcx_rgb(img[..., :3])[0]])
