"""Port parity for the rare formats as the bake meets them: the committed
fixtures of `tests/data/rare/` against their manifest (PIL's digests,
which `chip_smoke.py::rare_phase` holds the card's host to), PIL's YCbCr
-> RGB conversion against `raster.ycbcr_to_rgba` on all 2^24 triplets
(tolerance 0), the rare-format city's writer (`assets.write_city_assets(...,
formats="rare")`: FLC and PhotoCD base colours, IM normals, FITS
metallic-roughness, McIdas and SPIDER emissive maps) against PIL and its
own texels, and the bake of that city at the small frames' size
(`tcityrare4`: n = 4, 256^2 maps) against JAX's `build_texture_pages`,
byte for byte, with the scene's texture tables."""
import collections
import functools
import glob
import hashlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import assets, raster, textures
from test_torch_bmp import assert_bake_matches_jax

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "rare")
_MANIFEST_PATH = os.path.join(FIXTURES, "manifest.json")
MANIFEST = json.load(open(_MANIFEST_PATH)) if os.path.exists(
    _MANIFEST_PATH) else {}
FILES = sorted(n for n, r in MANIFEST.items() if not r.get("city_map"))


def test_manifest_lists_every_kind():
    kinds = collections.Counter(n.split("_")[0] for n in FILES)
    assert set(kinds) == {"im", "mcidas", "spider", "fits", "fli", "pcd"}
    assert kinds["im"] >= 28 and kinds["fli"] >= 9 and kinds["pcd"] == 4
    assert sum(MANIFEST[n]["bytes"] for n in FILES) < 4_000_000
    assert sorted(n for n in MANIFEST if n not in FILES) == [
        "city/b2_base.pcd"]


@pytest.mark.parametrize("name", FILES)
def test_fixture_matches_manifest(name):
    """Each fixture decodes, in PIL and in the port (from its path, as the
    bake reads it), to the RGBA digest of `manifest.json`."""
    rec = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == rec["bytes"]
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec["rgba_sha256"]
    got = textures._decode_image(path)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["rgba_sha256"]


def test_ycbcr_exhaustive():
    """PIL's `convert("RGBA")` of a YCbCr image against
    `raster.ycbcr_to_rgba` on all 2^24 (Y, Cb, Cr) triplets, tolerance 0."""
    v = np.arange(1 << 24, dtype=np.uint32)
    px = np.stack([(v >> s & 255).astype(np.uint8) for s in (16, 8, 0)], -1)
    pil = np.asarray(Image.frombytes("YCbCr", (4096, 4096), px.tobytes())
                     .convert("RGBA")).reshape(-1, 4)
    np.testing.assert_array_equal(raster.ycbcr_to_rgba(px[None])[0], pil)


@functools.lru_cache(maxsize=None)
def _city(map_size):
    root = tempfile.mkdtemp(prefix="rare_city_")
    kw = {} if map_size == 2048 else dict(map_size=map_size,
                                          emissive_size=map_size // 2)
    written = assets.write_city_assets(root, ground_size=(64, 128),
                                       formats="rare", **kw)
    return root, written


@pytest.mark.parametrize("map_size", [256, 2048])
def test_city_maps_as_pil(map_size):
    """The rare-format city's maps: every lossless map decodes, in PIL and
    in the port, to the texels its writer reports; the PhotoCD base colour
    to PIL's bytes, which at full size are the digest of the fixtures'
    manifest that `chip_smoke.py::format_phase` holds the card's host
    to."""
    root, written = _city(map_size)
    kinds = collections.Counter()
    for name, (_img, want) in sorted(written.items()):
        path = os.path.join(root, "meshes", name)
        pil = np.asarray(Image.open(path).convert("RGBA"))
        got = textures._decode_image(path)
        np.testing.assert_array_equal(got, pil, err_msg=name)
        kinds[os.path.splitext(name)[1]] += 1
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif map_size == 2048:
            rec = MANIFEST["city/" + name]
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                rec["rgba_sha256"]
    assert kinds == {".flc": 2, ".pcd": 1, ".im": 3, ".fits": 3, ".area": 1,
                     ".spi": 1}


@pytest.fixture(scope="module")
def rare_city(tmp_path_factory):
    """The small frames' rare-format city, as chip_smoke.py writes
    `tcityrare4`."""
    root = str(tmp_path_factory.mktemp("tcityrare4"))
    written = assets.write_city_assets(root, map_size=256, emissive_size=128,
                                       ground_size=(256, 512),
                                       formats="rare")
    return root, written, assets.write_city_ron(root, n=4)


def test_rare_city_bake_matches_jax(rare_city):
    root, _written, _ = rare_city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.*")))
    assert len(srcs) == 11
    with open(srcs[0], "rb") as f:
        assert f.read(6)[4:6] == b"\x12\xaf"    # an FLC
    atlas_t, sub_t = textures.bake_texture_pages(srcs)
    from kajiya_tpu.scene import textures as tex_j

    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()
    # the PhotoCD map stays 768 x 512 at any map size: bucket 1024
    assert sorted(set(sub_t[1:, 1].tolist())) == [128, 256, 1024]


def test_rare_city_texture_tables_match(rare_city):
    """The whole load (.ron -> glTF -> bake -> scene tables) of
    `tcityrare4` equals JAX's."""
    from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
    from kajiya_tpu.scene.scene import load_ron_scene as load_ron_j
    from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
    from kajiya_tpu_torch.scene.scene import load_ron_scene as load_ron_t

    ron = rare_city[2]
    gpu_j = build_gpu_j(load_ron_j(ron))
    gpu_t = build_gpu_t(load_ron_t(ron), device="cpu")
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(
            np.asarray(getattr(gpu_t, f).cpu()),
            np.asarray(getattr(gpu_j, f)), err_msg=f)


def test_bake_matches_jax():
    """One source of each new format through both bakes."""
    from test_torch_rare import _cases as cases
    from test_torch_rare_anim import _cases as anim

    sources = [cases("MCIDAS")["1-byte"], cases("SPIDER")["little"],
               cases("FITS")["gzip-8"], cases("IM")["YCC image"],
               cases("IM")["lut-colour-LA image"], cases("IM")["L*12 image"],
               anim("FLI")["ss2"], anim("PCD")["3"]]
    assert_bake_matches_jax(sources)
