"""Port parity: ICNS textures (`scene/icns.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py). Inputs:
files PIL writes (PNG members at every size up to the image's, from RGB,
RGBA, P and L images), and the port's writer for what PIL does not write:
the RLE members `is32` / `il32` / `ih32` / `it32` with and without their
masks, raw RGB members, a PNG member beside an RLE pair of its size, a
palette PNG with tRNS (which the icon drops), PNGs of a size another
listed size divides or none does, and the error cases (a mask without its
RGB member, a short mask, it32 without its zero header, an RLE channel
that overruns or ends early, an unknown member format, blocks shorter than
their header, no icon at all). A JPEG 2000 member raises
NotImplementedError where PIL decodes it. Then a 300-file cut-and-flip
sweep and the bake against JAX's; every input is made from a numpy
seed."""
import collections
import functools
import io
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import icns, textures
from kajiya_tpu_torch.scene.png import encode_png
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            sweep_outcome, uri)


def _img(rng, h, w, c=4):
    return (rng.integers(0, 256, (h, w, c)) // 16 * 16).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _pil_written(mode, size):
    """PIL's ICNS of a random image: PNG members of every size from 16 to
    1024 (PIL resizes the image to each)."""
    rng = np.random.default_rng(size)
    im = Image.fromarray(_img(rng, size, size), "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "ICNS")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L"])
@pytest.mark.parametrize("size", [32, 512])
def test_pil_written(mode, size):
    assert_as_pil(_pil_written(mode, size), must_decode=True)


RLE_SIZES = {b"is32": (16, b"s8mk"), b"il32": (32, b"l8mk"),
             b"ih32": (48, b"h8mk"), b"it32": (128, b"t8mk")}


@pytest.mark.parametrize("code", sorted(RLE_SIZES))
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("raw", [True, False])
def test_rgb_members(code, mask, raw):
    """Each RLE (or raw) RGB member, alone or with its mask."""
    n, mcode = RLE_SIZES[code]
    rng = np.random.default_rng(n + mask + 2 * raw)
    img = _img(rng, n, n)
    if raw:
        payload = img[..., :3].tobytes()
        payload = b"\0\0\0\0" + payload if code == b"it32" else payload
    else:
        payload = icns.rgb_member(img[..., :3], it32=code == b"it32")
    members = [(code, payload)]
    if mask:
        members.append((mcode, icns.mask_member(img[..., 3])))
    assert_as_pil(icns.encode_icns(members), must_decode=True)


def test_every_rle_size_picks_the_largest():
    rng = np.random.default_rng(1)
    members = []
    for code, (n, mcode) in RLE_SIZES.items():
        img = _img(rng, n, n)
        members += [(code, icns.rgb_member(img[..., :3], code == b"it32")),
                    (mcode, icns.mask_member(img[..., 3]))]
    data = icns.encode_icns(members[::-1])
    assert pil_rgba(data).shape == (128, 128, 4)
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", ["png-wins", "png-512-in-ic10",
                                  "png-300-in-ic10", "png-trns",
                                  "png-rgb"])
def test_png_members(case):
    rng = np.random.default_rng(len(case))
    img = _img(rng, 128, 128)
    rle = [(b"it32", icns.rgb_member(img[..., :3], it32=True)),
           (b"t8mk", icns.mask_member(img[..., 3]))]
    if case == "png-wins":
        members = rle + [(b"ic07", encode_png(_img(rng, 128, 128)))]
    elif case == "png-512-in-ic10":
        members = [(b"ic10", encode_png(_img(rng, 512, 512)))] + rle
    elif case == "png-300-in-ic10":
        members = [(b"ic10", encode_png(_img(rng, 300, 300)))] + rle
    elif case == "png-rgb":
        members = [(b"ic08", encode_png(_img(rng, 256, 256, 3)))]
    else:
        buf = io.BytesIO()
        im = Image.fromarray(_img(rng, 64, 64, 3)).convert("P")
        im.save(buf, "PNG", transparency=3)
        members = [(b"icp6", buf.getvalue())]
    data = icns.encode_icns(members)
    assert_as_pil(data, must_decode=case != "png-300-in-ic10")


def _j2k(rng):
    buf = io.BytesIO()
    Image.fromarray(_img(rng, 32, 32)).save(buf, "JPEG2000")
    return buf.getvalue()


def test_jpeg2000_member_raises_unported():
    """An `ic12` JPEG 2000 member (a JP2 file PIL writes). It raised
    NotImplementedError until JPEG 2000 was ported; it now decodes as PIL
    decodes it (`read_png_or_jpeg2000`: the member through
    `Jpeg2KImageFile`, converted to RGBA)."""
    rng = np.random.default_rng(4)
    data = icns.encode_icns([(b"ic12", _j2k(rng))])
    assert pil_rgba(data) is not None
    assert_as_pil(data, must_decode=True)


def _bad(case, rng):
    img = _img(rng, 16, 16)
    rgb = icns.rgb_member(img[..., :3])
    mask = icns.mask_member(img[..., 3])
    if case == "mask-only":
        return icns.encode_icns([(b"s8mk", mask)])
    if case == "short-mask":
        return icns.encode_icns([(b"is32", rgb), (b"s8mk", mask[:100])])
    if case == "it32-no-zeros":
        big = _img(rng, 128, 128)
        return icns.encode_icns([(b"it32", b"\1\0\0\0" + icns.rgb_member(
            big[..., :3]))])
    if case == "rle-overrun":
        return icns.encode_icns([(b"is32", bytes([0x80 + 127, 7]) * 3)])
    if case == "rle-short":
        return icns.encode_icns([(b"is32", rgb[:len(rgb) // 2])])
    if case == "unknown-member":
        return icns.encode_icns([(b"icp4", b"GIF89a" + bytes(40))])
    if case == "block-under-8":
        data = bytearray(icns.encode_icns([(b"is32", rgb)]))
        data[12:16] = struct.pack(">I", 3)
        return bytes(data)
    if case == "no-icon":
        return icns.encode_icns([(b"TOC ", b"\0" * 8)])
    if case == "filesize-long":
        data = bytearray(icns.encode_icns([(b"is32", rgb)]))
        data[4:8] = struct.pack(">I", len(data) + 40)
        return bytes(data)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["mask-only", "short-mask", "it32-no-zeros",
                                  "rle-overrun", "rle-short",
                                  "unknown-member", "block-under-8",
                                  "no-icon", "filesize-long"])
def test_broken_as_pil(case):
    assert_as_pil(_bad(case, np.random.default_rng(7)))


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    kind = k % 4 if k % 8 != 7 else 3
    if kind == 3 and k % 8 != 7:
        kind = 0
    if kind == 0:
        n = (16, 32, 48)[k % 3]
        code = {16: b"is32", 32: b"il32", 48: b"ih32"}[n]
        img = _img(rng, n, n)
        return icns.encode_icns([
            (code, icns.rgb_member(img[..., :3])),
            (RLE_SIZES[code][1], icns.mask_member(img[..., 3]))])
    if kind == 1:
        img = _img(rng, 128, 128)
        return icns.encode_icns([
            (b"it32", icns.rgb_member(img[..., :3], it32=True)),
            (b"t8mk", icns.mask_member(img[..., 3]))])
    if kind == 2:
        return icns.encode_icns([(b"icp4", encode_png(_img(rng, 16, 16)))])
    return _pil_written(("RGB", "RGBA")[k % 2], 32)


# the sweep's files that raise NotImplementedError (a flipped member
# signature that reads as JPEG 2000, say), by part. Of the 300: 115 PIL's
# bytes, 185 white (71 of them a refusal of ICNS's `_open`), none
# NotImplementedError
CUT_UNPORTED = (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped ICNS files (50 a part): PIL's bytes,
    PIL's error, or NotImplementedError; never pixels that differ."""
    rng = np.random.default_rng(2300 + part)
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                # the header and the member headers draw half the flips
                i = int(rng.integers(0, min(len(data), 48))) \
                    if rng.random() < 0.5 else int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data), inner=("ICNS", "PNG"))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(23)
    img = _img(rng, 128, 128)
    assert_bake_matches_jax([
        _pil_written("RGBA", 32),
        icns.encode_icns([(b"it32", icns.rgb_member(img[..., :3], True)),
                          (b"t8mk", icns.mask_member(img[..., 3]))])])
