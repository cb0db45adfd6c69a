"""Port parity, the textured path: the texture branch of `hit_attributes`
(four fetches, material modulation, tangent-space normal mapping, ray-cone
mips). One frame of the GI path on the textured cornell runs in
test_torch_frame_textured_gi.py, so the two land on different test workers.

- hit_attributes on seeded rays into the textured cornell and into a small
  textured asset city (`scene/assets.py`: base colour, metallic-roughness,
  normal and emissive maps, generated tangents; n = 4, 12,290 triangles, so
  the Morton permutation carries the texture tables), with and without
  `cone_width` and `no_normal_maps`, the same hits handed to both: every
  output within 1e-4 absolute. The scene tables are the port's own build
  (`build_gpu_scene` + `build_trace_scene`), held to JAX's exactly."""
import numpy as np
import pytest
import torch

from kajiya_tpu.rt.trace import Hit as HitJ
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.scene.scene import load_ron_scene as load_ron_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu.world import hit_attributes as attrs_j
from kajiya_tpu_torch.rt.trace import scene_trace_closest
from kajiya_tpu_torch.scene import assets
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
from kajiya_tpu_torch.scene.scene import load_ron_scene as load_ron_t
from kajiya_tpu_torch.world import build_trace_scene as build_ts_t
from kajiya_tpu_torch.world import hit_attributes as attrs_t
from test_torch_frame import _n

ATTR_TOL = 1e-4
N_RAYS = 6000


@pytest.fixture(scope="module")
def city_ron(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcity"))
    assets.write_city_assets(root, map_size=128, emissive_size=64,
                             ground_size=(64, 256))
    return assets.write_city_ron(root, n=4)


@pytest.fixture(scope="module", params=["cornell", "city"])
def scenes(request, city_ron):
    """(name, JAX trace scene, port trace scene, eye, target)."""
    if request.param == "cornell":
        sj, st = proc_j.textured_cornell_box(), proc_t.textured_cornell_box()
        eye, target = (0.0, 0.0, 2.4), (0.0, -0.6, 0.0)
    else:
        sj, st = load_ron_j(city_ron), load_ron_t(city_ron)
        eye, target = (0.0, 8.0, 14.0), (0.0, 0.0, 0.0)
    ts_j, _ = build_ts_j(build_gpu_j(sj))
    ts_t, _ = build_ts_t(build_gpu_t(st, device="cpu"), device="cpu")
    return request.param, ts_j, ts_t, eye, target


def test_texture_tables_match(scenes):
    """Atlas, slot table and material rows equal JAX's; the Morton sort of
    the clustered city keeps them and permutes the triangle tables alike."""
    _, ts_j, ts_t, *_ = scenes
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat", "tri_idx",
              "tri_inst"):
        np.testing.assert_array_equal(_n(getattr(ts_t.gpu, f)),
                                      np.asarray(getattr(ts_j.gpu, f)),
                                      err_msg=f)
    np.testing.assert_allclose(_n(ts_t.tri_attrs), np.asarray(ts_j.tri_attrs),
                               rtol=1e-6, atol=1e-5)


def _rays(eye, target, n, seed):
    rng = np.random.default_rng(seed)
    fwd = np.asarray(target, np.float32) - np.asarray(eye, np.float32)
    d = fwd / np.linalg.norm(fwd) + rng.normal(0, 0.2, (n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    org = np.broadcast_to(np.asarray(eye, np.float32), d.shape).copy()
    return org, d


@pytest.mark.parametrize("cone", [False, True], ids=["static_mip", "cone"])
@pytest.mark.parametrize("no_nm", [False, True], ids=["nmap", "no_nmap"])
def test_hit_attributes_match(scenes, cone, no_nm):
    name, ts_j, ts_t, eye, target = scenes
    org, d = _rays(eye, target, N_RAYS, seed=3)
    hit_t = scene_trace_closest(ts_t, torch.from_numpy(org),
                                torch.from_numpy(d))
    mask = _n(hit_t.hit_mask)
    assert mask.mean() > 0.5
    hit_j = HitJ(*(np.asarray(_n(x)) for x in (hit_t.t, hit_t.tri, hit_t.u,
                                               hit_t.v)))
    kw = dict(no_normal_maps=no_nm, with_prev_pos=True)
    cw = None
    if cone:
        rng = np.random.default_rng(4)
        cw = (rng.uniform(1e-4, 3e-2, N_RAYS)
              * np.where(mask, _n(hit_t.t), 1.0)).astype(np.float32)
    aj = attrs_j(ts_j, hit_j, d, cone_width=cw, **kw)
    at = attrs_t(ts_t, hit_t, torch.from_numpy(d),
                 cone_width=None if cw is None else torch.from_numpy(cw),
                 **kw)
    assert set(aj) == set(at)
    for k in aj:
        a, b = np.asarray(aj[k]), _n(at[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b[mask], a[mask], rtol=0,
                                       atol=ATTR_TOL, err_msg=f"{name} {k}")
    # the textures really modulate: the base colour varies inside one
    # textured material, and normal maps move normals off the vertex normal
    mats = _n(at["material"])[mask]
    bc = _n(at["base_color"])[mask]
    tex_mat = np.nonzero(_n(ts_t.gpu.mat_tex)[:, 0] > 0)[0]
    sel = np.isin(mats, tex_mat)
    assert sel.sum() > 50 and bc[sel].std(axis=0).max() > 0.01
    if name == "city":
        flat = attrs_t(ts_t, hit_t, torch.from_numpy(d), no_normal_maps=True)
        moved = np.abs(_n(flat["normal"]) - _n(at["normal"]))[mask].max()
        assert (moved > 1e-3) == (not no_nm)


def test_full_shading_off_skips_textures(scenes):
    """Secondary hits shaded with the face normal read no texture, as in
    JAX (`full_shading=False`)."""
    _, ts_j, ts_t, eye, target = scenes
    org, d = _rays(eye, target, 512, seed=5)
    hit_t = scene_trace_closest(ts_t, torch.from_numpy(org),
                                torch.from_numpy(d))
    hit_j = HitJ(*(np.asarray(_n(x)) for x in (hit_t.t, hit_t.tri, hit_t.u,
                                               hit_t.v)))
    aj = attrs_j(ts_j, hit_j, d, full_shading=False)
    at = attrs_t(ts_t, hit_t, torch.from_numpy(d), full_shading=False)
    mask = _n(hit_t.hit_mask)
    for k in aj:
        np.testing.assert_allclose(_n(at[k])[mask].astype(np.float64),
                                   np.asarray(aj[k])[mask], rtol=0,
                                   atol=ATTR_TOL, err_msg=k)
