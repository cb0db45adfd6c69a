"""Port parity: FLI / FLC (`scene/fli.py`, with `csrc/raster_decoder.cpp`'s
`kt_fli`) and PhotoCD (`scene/pcd.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (test_torch_bmp.py's helpers). Inputs, made
from numpy seeds with the writers here and the port's (`fli.encode_flc`,
`pcd.encode_pcd`; PIL writes neither format): FLI and FLC files whose first
frame holds each chunk type PIL's decoder knows (BRUN, LC, SS2 with line
skips and the odd last byte, COPY, BLACK, COLOR_64, COLOR_256, PSTAMP) and
one it does not, prefix chunks, palettes split into packets, the header
checks, and short frames; PCD in each orientation and cut short. Each
format gets a 300-file cut-and-flip sweep, and PIL's `YCC;P` unpacker is
held to `raster.photoycc_to_rgb` on all 2^24 triplets."""
import collections
import functools
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import fli, identify, pcd, raster
from test_torch_bmp import assert_as_pil, pil_rgba, sweep_outcome
from test_torch_rare import cut_or_flip

Image.init()


# ----------------------------------------------------------------------------
# FLI / FLC writers
# ----------------------------------------------------------------------------

def chunk(kind: int, payload: bytes, size=None) -> bytes:
    payload += b"\0" * (len(payload) % 2)
    return struct.pack("<IH", 6 + len(payload) if size is None else size,
                       kind) + payload


def colour_chunk(pal: np.ndarray, kind: int = 4, packets=None) -> bytes:
    """COLOR_256 (4) or COLOR_64 (11): `packets` of (skip, count) over the
    palette entries, one packet of all 256 by default (count 0)."""
    packets = packets or [(0, 0)]
    body = struct.pack("<H", len(packets))
    i = 0
    for skip, count in packets:
        i += skip
        n = count or 256
        body += bytes([skip, count]) + pal[i:i + n].tobytes()
        i += n
    return chunk(kind, body)


def brun_lines(idx: np.ndarray) -> bytes:
    out = np.empty(idx.size * 2 + idx.shape[0] * 4 + 16, np.uint8)
    n = raster.library().kt_fli_brun_encode(
        np.ascontiguousarray(idx, np.uint8).ctypes.data, idx.shape[1],
        idx.shape[0], out.ctypes.data)
    return out[:n].tobytes()


def lc_lines(rng, idx: np.ndarray, first: int, count: int,
             skips: bool = False) -> bytes:
    """An LC chunk's payload: lines `first`.. of packets (a skip, then a
    run or literal) that write `idx` (where `skips`, some pixels
    skipped)."""
    w = idx.shape[1]
    body = struct.pack("<HH", first, count)
    for y in range(first, first + count):
        packets, x = [], 0
        while x < w:
            skip = int(rng.integers(0, 3)) if skips else 0
            if x + skip >= w:
                break
            x += skip
            n = int(rng.integers(1, min(20, w - x) + 1))
            if rng.random() < 0.5 and (idx[y, x:x + n] == idx[y, x]).all():
                packets.append(bytes([skip, 256 - n, idx[y, x]]))
            else:
                packets.append(bytes([skip, n]) + idx[y, x:x + n].tobytes())
            x += n
        body += bytes([len(packets)]) + b"".join(packets)
    return body


def ss2_lines(rng, idx: np.ndarray, skips: bool = False) -> bytes:
    """An SS2 chunk's payload: each line's word packets (runs and
    literals of pixel pairs), on odd widths the last-byte word, and where
    `skips` some lines skipped by a line-skip word."""
    h, w = idx.shape
    lines, body, y = 0, b"", 0
    while y < h:
        words = b""
        if skips and rng.random() < 0.2 and y + 2 < h:
            words += struct.pack("<H", 65536 - 2)
            y += 2
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(idx[y, w - 1]))
        packets, x = [], 0
        while x + 2 <= w - w % 2:
            n = int(rng.integers(1, (w - w % 2 - x) // 2 + 1))
            pair = idx[y, x:x + 2]
            if n > 1 and (idx[y, x:x + 2 * n].reshape(-1, 2) == pair).all():
                packets.append(bytes([0, 256 - n]) + pair.tobytes())
            else:
                packets.append(bytes([0, n]) + idx[y, x:x + 2 * n].tobytes())
            x += 2 * n
        body += words + struct.pack("<H", len(packets)) + b"".join(packets)
        lines += 1
        y += 1
    return struct.pack("<H", lines) + body


def fli_file(w: int, h: int, chunks, magic: int = 0xAF12, frames: int = 1,
             prefix: bytes = b"", frame_size=None) -> bytes:
    body = b"".join(chunks)
    size = 16 + len(body) if frame_size is None else frame_size
    frame = struct.pack("<IHH8x", size, 0xF1FA, len(chunks)) + body
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(prefix) + len(frame),
                     magic, frames, w, h, 8, 0, 5)
    return bytes(head) + prefix + frame


def fli_cases(rng):
    w, h = 21, 13
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    idx[3:7] = idx[3, 0]
    idx[:, 4:12] = 9
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    pal64 = (pal >> 2).astype(np.uint8)
    brun = chunk(15, brun_lines(idx))
    c256 = colour_chunk(pal)
    flc = fli.encode_flc(idx, pal)
    return {
        "writer": flc,
        "brun": fli_file(w, h, [c256, brun]),
        "brun-fli": fli_file(w, h, [c256, brun], magic=0xAF11),
        "brun-grey": fli_file(w, h, [brun]),
        "color64": fli_file(w, h, [colour_chunk(pal64, 11), brun]),
        "color64-high": fli_file(w, h, [colour_chunk(pal, 11), brun]),
        "colour-packets": fli_file(w, h, [colour_chunk(
            pal, packets=[(3, 10), (5, 20), (0, 1)]), brun]),
        "colour-second": fli_file(w, h, [chunk(18, b"\0" * 10), c256, brun]),
        "colour-past-256": fli_file(w, h, [colour_chunk(
            pal, packets=[(250, 10)]), brun]),
        "lc": fli_file(w, h, [c256, chunk(12, lc_lines(rng, idx, 0, h))]),
        "lc-skips": fli_file(w, h, [c256, chunk(12, lc_lines(
            rng, idx, 0, h, skips=True))]),
        "ss2-skips": fli_file(w, h, [c256, chunk(7, ss2_lines(
            rng, idx, skips=True))]),
        "lc-part": fli_file(w, h, [c256, brun, chunk(12, lc_lines(
            rng, idx[::-1].copy(), 2, 5))]),
        "ss2": fli_file(w, h, [c256, chunk(7, ss2_lines(rng, idx))]),
        "ss2-even": fli_file(w - 1, h, [c256, chunk(7, ss2_lines(
            rng, idx[:, :w - 1].copy()))]),
        "copy": fli_file(w, h, [c256, chunk(16, idx.tobytes())]),
        "copy-short": fli_file(w, h, [c256, chunk(16, idx.tobytes()[:-30])]),
        "black": fli_file(w, h, [c256, brun, chunk(13, b"\0" * 4)]),
        "black-short-last": fli_file(w, h, [c256, brun, chunk(13, b"")]),
        "pstamp": fli_file(w, h, [chunk(18, b"\0" * 40), c256, brun]),
        "unknown-chunk": fli_file(w, h, [c256, chunk(99, b"\0" * 8)]),
        "no-chunks": fli_file(w, h, []),
        "zero-advance": fli_file(w, h, [c256, chunk(18, b"\0" * 8, 0)]),
        "prefix": fli_file(w, h, [c256, brun], prefix=chunk(0xF100,
                                                            b"\0" * 10)),
        "no-frames": fli_file(w, h, [c256, brun], frames=0),
        "two-frames": fli_file(w, h, [c256, brun], frames=2),
        "odd-frame-size": fli_file(w, h, [c256, brun]) + b"\0",
        "frame-size-short": fli_file(w, h, [c256, brun], frame_size=12),
        "frame-size-long": fli_file(w, h, [c256, brun], frame_size=100000),
        "truncated": flc[:-40],
        "zero-width": fli_file(0, h, [c256, brun]),
        "bad-flags": flc[:14] + b"\1\0" + flc[16:],
        "reserved-set": flc[:50] + b"\1" + flc[51:],
        "short-header": flc[:100],
        "only-header": flc[:128],
    }


def pcd_cases(rng):
    y, x = np.mgrid[0:512, 0:768]
    img = np.stack([x * 255 // 767, y * 255 // 511,
                    (x + y) * 255 // 1278], -1).astype(np.uint8)
    img[100:200, 300:500] = rng.integers(0, 256, (100, 200, 3), np.uint8)
    base = pcd.encode_pcd(img)
    return {
        "0": base,
        "1": pcd.encode_pcd(np.rot90(img, 1), 1),
        "2": pcd.encode_pcd(img, 2),
        "3": pcd.encode_pcd(np.rot90(img, -1), 3),
        "flags-above": base[:2048 + 1538] + b"\xfd" + base[2048 + 1539:],
        "more-after": base + b"\0" * 4096,
        "cut-in-image": base[:-1000],
        "cut-before-image": base[:100000],
        "short-sector": base[:2048 + 1000],
        "no-magic": base[:2048] + b"PCX_" + base[2052:],
    }


CASES = {"FLI": fli_cases, "PCD": pcd_cases}


@functools.lru_cache(maxsize=None)
def _cases(fmt):
    return CASES[fmt](np.random.default_rng(sum(map(ord, fmt)) + 21))


@pytest.mark.parametrize("fmt,case", [(f, c) for f in CASES
                                      for c in _cases(f)])
def test_case_as_pil(fmt, case):
    assert_as_pil(_cases(fmt)[case])


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_each_format_decodes(fmt):
    decoded = [c for c, d in _cases(fmt).items() if pil_rgba(d) is not None]
    assert len(decoded) >= 4
    for c in decoded:
        assert identify.identify(_cases(fmt)[c]) == fmt, c


@pytest.mark.parametrize("case", ["brun", "lc", "ss2", "copy", "writer"])
def test_fli_chunks_give_the_frame(case):
    """Each chunk type that draws the whole frame gives the writer's
    palette indices through its palette."""
    rng = np.random.default_rng(sum(map(ord, "FLI")) + 21)
    w, h = 21, 13
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    idx[3:7] = idx[3, 0]
    idx[:, 4:12] = 9
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    got = pil_rgba(_cases("FLI")[case])
    np.testing.assert_array_equal(got[..., :3], pal[idx])


def test_pcd_orientations():
    """Orientation 1 and 3 turn the 768 x 512 base image to 512 x 768 (a
    transpose), 0 and 2 keep it; the writer's picture comes back near its
    texels (PhotoYCC's half-width chroma)."""
    shapes = {c: pil_rgba(_cases("PCD")[c]).shape for c in "0123"}
    assert shapes == {"0": (512, 768, 4), "1": (768, 512, 4),
                      "2": (512, 768, 4), "3": (768, 512, 4)}
    base = pil_rgba(_cases("PCD")["0"]).astype(int)
    for c, k in (("1", 1), ("3", -1)):
        turned = pil_rgba(_cases("PCD")[c]).astype(int)
        assert np.abs(turned - np.rot90(base, k)).mean() < 4


def test_photoycc_exhaustive():
    """PIL's `YCC;P` unpacker (PhotoCD's) against `raster.photoycc_to_rgb`
    on all 2^24 (Y, Cb, Cr) triplets, tolerance 0."""
    v = np.arange(1 << 24, dtype=np.uint32)
    y, cb, cr = ((v >> s & 255).astype(np.uint8) for s in (16, 8, 0))
    pil = np.asarray(Image.frombytes(
        "RGB", (4096, 4096), np.stack([y, cb, cr], -1).tobytes(), "raw",
        "YCC;P")).reshape(-1, 3)
    np.testing.assert_array_equal(raster.photoycc_to_rgb(y, cb, cr), pil)


def _fuzz_base(fmt, k):
    good = [d for d in _cases(fmt).values() if pil_rgba(d) is not None]
    return good[k % len(good)]


# each format's sweep files that raise NotImplementedError, a part. Of each
# 300 (PIL's bytes / white, of which a refusal of the plugin's `_open` /
# NotImplementedError): FLI 83 / 217, 162 / 0; PCD 209 / 91, 1 / 0
CUT_UNPORTED = {"FLI": 0, "PCD": 0}
# the bytes that draw half the flips: FLI's header and first chunks, PCD's
# header sector
_HEAD = {"FLI": 200, "PCD": 2048 + 1539}


@pytest.mark.parametrize("fmt", sorted(CASES))
@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(fmt, part):
    """300 seeded cut or flipped files of each format (50 a part): PIL's
    bytes, PIL's error, or NotImplementedError; never pixels that
    differ."""
    rng = np.random.default_rng(2800 + 10 * part + sorted(CASES).index(fmt))
    seen = collections.Counter()
    for t in range(50):
        data = cut_or_flip(rng, _fuzz_base(fmt, 50 * part + t), _HEAD[fmt])
        seen[sweep_outcome(data)] += 1
    assert seen["unported"] <= CUT_UNPORTED[fmt], seen
