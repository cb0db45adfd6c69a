"""Port parity, the mixed-format textured city (`scene/assets.py`,
`write_city_assets(..., formats="mixed")`): base colours as JPEG from the
port's encoder, normal maps as BC5 and metallic-roughness maps as BC7 DDS,
b1's emissive map a 16-bit PNG, the ground an 8-bit PNG data URI; and the
legacy-format city (`formats="legacy"`): base colours as 32-bit RLE TGA,
normal maps as 24-bit BMP, metallic-roughness maps as 256-colour GIF, the
emissive map a lossless WebP; and the TIFF-textured city
(`formats="tiff"`): LZW tiled base colours with horizontal differencing,
deflate planar normal maps, big-endian 16-bit PackBits metallic-roughness
maps, a raw emissive map with Orientation 6; and the studio city
(`formats="studio"`): 4-channel PackBits PSD base colours, RLE SGI normal
maps, 24-bit RLE PCX metallic-roughness maps, a QOI emissive map. JAX
decodes them with PIL, the port with its own decoders; the same checks
hold the four cities.

- The bake of the city's sources: atlas and slot table equal JAX's
  `build_texture_pages` byte for byte, no slot white.
- The whole load (.ron -> glTF -> bake -> scene tables) at n = 4 with
  128^2 maps: texture tables equal JAX's, and `hit_attributes` on the same
  seeded hits within ATTR_TOL = 1e-4 absolute, as
  test_torch_frame_textured.py holds the PNG city."""
import glob
import os

import numpy as np
import pytest
import torch

from kajiya_tpu.rt.trace import Hit as HitJ
from kajiya_tpu.scene import textures as tex_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.scene.scene import load_ron_scene as load_ron_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu.world import hit_attributes as attrs_j
from kajiya_tpu_torch.rt.trace import scene_trace_closest
from kajiya_tpu_torch.scene import assets
from kajiya_tpu_torch.scene import textures as tex_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
from kajiya_tpu_torch.scene.scene import load_ron_scene as load_ron_t
from kajiya_tpu_torch.world import build_trace_scene as build_ts_t
from kajiya_tpu_torch.world import hit_attributes as attrs_t
from test_torch_frame import _n
from test_torch_frame_textured import ATTR_TOL, N_RAYS, _rays


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcityfmt"))
    written = assets.write_city_assets(root, map_size=128, emissive_size=64,
                                       ground_size=(64, 256),
                                       formats="mixed")
    return root, written, assets.write_city_ron(root, n=4)


def test_files_are_mixed(city):
    root, written, _ = city
    names = sorted(os.listdir(os.path.join(root, "meshes")))
    kinds = {os.path.splitext(n)[1] for n in names}
    assert {".jpg", ".dds", ".png", ".gltf", ".glb"} <= kinds
    with open(os.path.join(root, "meshes", "b1_emissive.png"), "rb") as f:
        assert f.read()[24] == 16                 # IHDR bit depth
    assert len(written) == 10


def test_bake_matches_jax(city):
    root, written, _ = city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.*")))
    assert len(srcs) == 10
    atlas_t, sub_t = tex_t.bake_texture_pages(srcs)
    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()
    # the lossless maps decode to the texels written
    for name, (_img, want) in written.items():
        if want is not None:
            got = tex_t._decode_image(os.path.join(root, "meshes", name))
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def scenes(city):
    ron = city[2]
    ts_j, _ = build_ts_j(build_gpu_j(load_ron_j(ron)))
    ts_t, _ = build_ts_t(build_gpu_t(load_ron_t(ron), device="cpu"),
                         device="cpu")
    return ts_j, ts_t


def test_texture_tables_match(scenes):
    ts_j, ts_t = scenes
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(_n(getattr(ts_t.gpu, f)),
                                      np.asarray(getattr(ts_j.gpu, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cone", [False, True], ids=["static_mip", "cone"])
def test_hit_attributes_match(scenes, cone):
    _check_hit_attributes(scenes, cone)


def _check_hit_attributes(scenes, cone):
    ts_j, ts_t = scenes
    org, d = _rays((0.0, 8.0, 14.0), (0.0, 0.0, 0.0), N_RAYS, seed=3)
    hit_t = scene_trace_closest(ts_t, torch.from_numpy(org),
                                torch.from_numpy(d))
    mask = _n(hit_t.hit_mask)
    assert mask.mean() > 0.5
    hit_j = HitJ(*(np.asarray(_n(x)) for x in (hit_t.t, hit_t.tri, hit_t.u,
                                               hit_t.v)))
    cw = None
    if cone:
        rng = np.random.default_rng(4)
        cw = (rng.uniform(1e-4, 3e-2, N_RAYS)
              * np.where(mask, _n(hit_t.t), 1.0)).astype(np.float32)
    aj = attrs_j(ts_j, hit_j, d, cone_width=cw, with_prev_pos=True)
    at = attrs_t(ts_t, hit_t, torch.from_numpy(d),
                 cone_width=None if cw is None else torch.from_numpy(cw),
                 with_prev_pos=True)
    assert set(aj) == set(at)
    for k in aj:
        a, b = np.asarray(aj[k]), _n(at[k])
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b[mask], a[mask], rtol=0,
                                       atol=ATTR_TOL, err_msg=k)
    bc = _n(at["base_color"])[mask]
    assert bc.std(axis=0).max() > 0.01


# ----------------------------------------------------------------------------
# the legacy-format city
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy_city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcitylegacy"))
    written = assets.write_city_assets(root, map_size=128, emissive_size=64,
                                       ground_size=(64, 256),
                                       formats="legacy")
    return root, written, assets.write_city_ron(root, n=4)


def test_legacy_files(legacy_city):
    root, written, _ = legacy_city
    names = sorted(os.listdir(os.path.join(root, "meshes")))
    kinds = {os.path.splitext(n)[1] for n in names}
    assert {".tga", ".bmp", ".gif", ".webp", ".gltf", ".glb"} <= kinds
    assert len(written) == 10
    assert all(want is not None for _img, want in written.values())


def test_legacy_bake_matches_jax(legacy_city):
    root, written, _ = legacy_city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.*")))
    assert len(srcs) == 10
    atlas_t, sub_t = tex_t.bake_texture_pages(srcs)
    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()
    # every legacy map is lossless: it decodes to the texels written
    for name, (_img, want) in written.items():
        got = tex_t._decode_image(os.path.join(root, "meshes", name))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def legacy_scenes(legacy_city):
    ron = legacy_city[2]
    ts_j, _ = build_ts_j(build_gpu_j(load_ron_j(ron)))
    ts_t, _ = build_ts_t(build_gpu_t(load_ron_t(ron), device="cpu"),
                         device="cpu")
    return ts_j, ts_t


def test_legacy_texture_tables_match(legacy_scenes):
    ts_j, ts_t = legacy_scenes
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(_n(getattr(ts_t.gpu, f)),
                                      np.asarray(getattr(ts_j.gpu, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cone", [False, True], ids=["static_mip", "cone"])
def test_legacy_hit_attributes_match(legacy_scenes, cone):
    """The legacy city's hits at the PNG city's tolerance, ATTR_TOL."""
    _check_hit_attributes(legacy_scenes, cone)


# ----------------------------------------------------------------------------
# the TIFF-textured city
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiff_city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcitytiff"))
    written = assets.write_city_assets(root, map_size=128, emissive_size=64,
                                       ground_size=(64, 256), formats="tiff")
    return root, written, assets.write_city_ron(root, n=4)


def test_tiff_files(tiff_city):
    root, written, _ = tiff_city
    names = sorted(os.listdir(os.path.join(root, "meshes")))
    assert sum(n.endswith(".tif") for n in names) == 10
    assert len(written) == 10
    assert all(want is not None for _img, want in written.values())


def test_tiff_bake_matches_jax(tiff_city):
    root, written, _ = tiff_city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.*")))
    assert len(srcs) == 10
    atlas_t, sub_t = tex_t.bake_texture_pages(srcs)
    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()
    for name, (_img, want) in written.items():
        got = tex_t._decode_image(os.path.join(root, "meshes", name))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def tiff_scenes(tiff_city):
    ron = tiff_city[2]
    ts_j, _ = build_ts_j(build_gpu_j(load_ron_j(ron)))
    ts_t, _ = build_ts_t(build_gpu_t(load_ron_t(ron), device="cpu"),
                         device="cpu")
    return ts_j, ts_t


def test_tiff_texture_tables_match(tiff_scenes):
    ts_j, ts_t = tiff_scenes
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(_n(getattr(ts_t.gpu, f)),
                                      np.asarray(getattr(ts_j.gpu, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cone", [False, True], ids=["static_mip", "cone"])
def test_tiff_hit_attributes_match(tiff_scenes, cone):
    """The TIFF city's hits at the PNG city's tolerance, ATTR_TOL."""
    _check_hit_attributes(tiff_scenes, cone)



# ----------------------------------------------------------------------------
# the studio city
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def studio_city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcitystudio"))
    written = assets.write_city_assets(root, map_size=128, emissive_size=64,
                                       ground_size=(64, 256),
                                       formats="studio")
    return root, written, assets.write_city_ron(root, n=4)


def test_studio_files(studio_city):
    root, written, _ = studio_city
    names = sorted(os.listdir(os.path.join(root, "meshes")))
    kinds = {os.path.splitext(n)[1] for n in names}
    assert {".psd", ".rgb", ".pcx", ".qoi", ".gltf", ".glb"} <= kinds
    assert len(written) == 10
    assert all(want is not None for _img, want in written.values())


def test_studio_bake_matches_jax(studio_city):
    root, written, _ = studio_city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.*")))
    assert len(srcs) == 10
    atlas_t, sub_t = tex_t.bake_texture_pages(srcs)
    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()
    # every studio map is lossless: it decodes to the texels written
    for name, (_img, want) in written.items():
        got = tex_t._decode_image(os.path.join(root, "meshes", name))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def studio_scenes(studio_city):
    ron = studio_city[2]
    ts_j, _ = build_ts_j(build_gpu_j(load_ron_j(ron)))
    ts_t, _ = build_ts_t(build_gpu_t(load_ron_t(ron), device="cpu"),
                         device="cpu")
    return ts_j, ts_t


def test_studio_texture_tables_match(studio_scenes):
    ts_j, ts_t = studio_scenes
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(_n(getattr(ts_t.gpu, f)),
                                      np.asarray(getattr(ts_j.gpu, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cone", [False, True], ids=["static_mip", "cone"])
def test_studio_hit_attributes_match(studio_scenes, cone):
    """The studio city's hits at the PNG city's tolerance, ATTR_TOL."""
    _check_hit_attributes(studio_scenes, cone)
