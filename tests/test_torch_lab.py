"""Port parity: LAB images (`scene/lab.py`, `csrc/lab_transform.cpp`)
against PIL 12.1.0's `convert("RGBA")`, which converts LAB through
LittleCMS 2.17.

Tolerance: exact everywhere. The transform is held to PIL on every one of
the 2^24 LAB triplets, and its 33^3 table to the nodes of lcms's own
unoptimised transform (through the wheel's liblcms2, by ctypes; the port
carries no lcms and no table taken from it). Then the containers: LAB
TIFFs in every layout PIL reads (raw, LZW with differencing, deflate,
PackBits; strips, tiles, planar; both byte orders; an Orientation;
BigTIFF) and LAB PSDs (raw and PackBits, extra channels), each giving
PIL's bytes (a planar TIFF and a PSD copy a and b as PIL does, and leave
its alpha 0), a 300-file cut-and-flip sweep of both, and the bake against
JAX's. Inputs are made from numpy seeds."""
import collections
import ctypes
import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

import PIL
from kajiya_tpu_torch.scene import lab, textures
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            sweep_outcome, uri)
from test_torch_psd import psd_file, runs
from test_torch_tiff import _tiff


def test_every_triplet_as_pil():
    """All 2^24 (L, a, b) triplets, as PIL's "LAB" raw mode reads them
    (signed a and b), against PIL's `convert("RGBA")`: tolerance 0."""
    i = np.arange(1 << 24, dtype=np.uint32)
    raw = np.stack([i >> 16, i >> 8 & 255, i & 255], -1).astype(np.uint8)
    rows = raw.reshape(4096, 4096 * 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096),
                                      rows.tobytes()).convert("RGBA"))
    got = lab.to_rgba(lab.unpack_lab(rows, 4096))
    assert got.shape == want.shape
    bad = int((got != want).any(-1).sum())
    assert bad == 0, f"{bad} triplets differ"


def _lcms():
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                  "pillow.libs", "liblcms2-*.so*"))
    assert libs, "the PIL wheel's liblcms2"
    lib = ctypes.CDLL(libs[0])
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.cmsCreate_sRGBProfile.restype = vp
    lib.cmsCreateLab2Profile.restype = vp
    lib.cmsCreateLab2Profile.argtypes = [vp]
    lib.cmsCreateTransform.restype = vp
    lib.cmsCreateTransform.argtypes = [vp, u32, vp, u32, u32, u32]
    lib.cmsDoTransform.argtypes = [vp, vp, vp, u32]
    return lib


def test_nodes_as_lcms():
    """The table the port computes equals lcms 2.17's float pipeline
    evaluated at the grid's nodes (an unoptimised 16-bit transform: V4 Lab
    words in, sRGB words out)."""
    lib = _lcms()
    assert lib.cmsGetEncodedCMMversion() == 2170
    lab16 = 10 << 16 | 3 << 3 | 2           # TYPE_Lab_16
    rgb16 = 4 << 16 | 3 << 3 | 2            # TYPE_RGB_16
    xform = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), lab16,
                                   lib.cmsCreate_sRGBProfile(), rgb16, 0,
                                   0x0100)   # perceptual, NOOPTIMIZE
    q = np.floor(np.arange(lab.GRID) * 65535.0 / (lab.GRID - 1) + 0.5)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    src = np.ascontiguousarray(nodes, np.uint16)
    out = np.zeros_like(src)
    lib.cmsDoTransform(xform, src.ctypes.data, out.ctypes.data, len(src))
    np.testing.assert_array_equal(lab.nodes().reshape(-1, 3), out)


def _lab_samples(rng, h, w):
    v = rng.integers(0, 256, (h, w, 3))
    v[: h // 2, :, 1:] = rng.integers(0, 256, 2)      # a flat region
    return v.astype(np.uint8)


TIFF_LAYOUTS = {
    "raw": {},
    "raw-strips": dict(rows_per_strip=3),
    "raw-tiles": dict(tile=(16, 16)),
    "lzw-predictor": dict(compression=5, predictor=2),
    "lzw-tiles-be": dict(compression=5, tile=(16, 16), order=">"),
    "deflate": dict(compression=8, rows_per_strip=5),
    "packbits-be": dict(compression=32773, order=">"),
    "planar-raw": dict(planar=2),
    "planar-lzw": dict(planar=2, compression=5),
    "orientation-6": dict(orientation=6),
    "bigtiff": dict(bigtiff=True, compression=8),
}


@pytest.mark.parametrize("layout", sorted(TIFF_LAYOUTS))
def test_tiff_layouts_as_pil(layout):
    rng = np.random.default_rng(len(layout))
    data = _tiff(_lab_samples(rng, 21, 37), photometric=8,
                 **TIFF_LAYOUTS[layout])
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", ["alpha-sample", "16-bit", "one-sample"])
def test_tiff_outside_open_info_as_pil(case):
    """LAB layouts PIL's OPEN_INFO lacks (an alpha sample, 16 bits a
    sample, one sample): PIL refuses them, and so does the port."""
    rng = np.random.default_rng(5)
    if case == "alpha-sample":
        data = _tiff(rng.integers(0, 256, (6, 7, 4)).astype(np.uint8),
                     photometric=8, extra=[2])
    elif case == "16-bit":
        data = _tiff(rng.integers(0, 65536, (6, 7, 3)).astype(np.uint16),
                     16, photometric=8)
    else:
        data = _tiff(rng.integers(0, 256, (6, 7, 1)).astype(np.uint8),
                     photometric=8)
    assert pil_rgba(data) is None
    assert_as_pil(data)


def test_tiff_pil_written_as_pil():
    """A LAB image PIL itself saves, raw and compressed."""
    rng = np.random.default_rng(3)
    im = Image.frombytes("LAB", (29, 17), _lab_samples(rng, 17, 29).tobytes())
    for compression in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=compression)
        assert_as_pil(buf.getvalue(), must_decode=True)


@pytest.mark.parametrize("channels", [3, 4, 5])
@pytest.mark.parametrize("comp", [0, 1])
def test_psd_as_pil(channels, comp):
    """LAB PSDs of 3 planes and with extra ones (PIL reads the first
    three), raw and PackBits."""
    rng = np.random.default_rng(10 * channels + comp)
    data = psd_file(runs(rng, channels, 19, 33), 9, comp=comp)
    assert_as_pil(data, must_decode=True)


def _fuzz_base(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(2, 30, 2))
    if k % 3 == 0:
        return psd_file(runs(rng, 3 + k % 2, h, w), 9, comp=k % 2)
    layouts = sorted(TIFF_LAYOUTS)
    return _tiff(_lab_samples(rng, h, w), photometric=8,
                 **TIFF_LAYOUTS[layouts[k % len(layouts)]])


# the sweep's files that raise NotImplementedError (a TIFF directory or
# stream whose outcome in libtiff the port does not model), by part. Of the
# 300: 136 PIL's bytes, 155 white (85 of them a refusal of the TIFF or PSD
# plugin's `_open`), 9 NotImplementedError
CUT_UNPORTED = (1, 2, 2, 1, 1, 2)


@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(part):
    """300 seeded cut or flipped LAB TIFFs and PSDs (50 a part): PIL's
    bytes, PIL's error, or NotImplementedError; never pixels that
    differ."""
    rng = np.random.default_rng(1900 + part)
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
        seen[sweep_outcome(bytes(data), inner=("TIFF",))] += 1
    assert seen["unported"] <= CUT_UNPORTED[part], seen


def test_bake_matches_jax():
    rng = np.random.default_rng(19)
    assert_bake_matches_jax([
        _tiff(_lab_samples(rng, 30, 50), photometric=8, compression=5),
        psd_file(runs(rng, 3, 24, 40), 9)])
    assert pil_rgba(_tiff(_lab_samples(rng, 4, 4), photometric=8)) is not None
    assert textures._decode_image(uri(psd_file(runs(rng, 3, 4, 4), 9))
                                  )[..., 3].max() == 0
