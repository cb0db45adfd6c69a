"""Port parity, scene side: procedural scenes, GpuScene tables, the trace
scene (Woop tables, both cluster granularities, the Morton permutation, the
attribute tables) and raster primary visibility + gbuffer at 64x48 on
cornell and on a 12,290-triangle city (clusters and Morton order active)."""
import numpy as np
import pytest
import torch

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.renderers import gbuffer as gb_j
from kajiya_tpu.renderers import raster as raster_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.renderers import gbuffer as gb_t
from kajiya_tpu_torch.renderers import raster as raster_t
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
from kajiya_tpu_torch.world import build_trace_scene as build_ts_t

# Tolerances: integer tables and the Morton permutation are exact; float
# tables agree to 1e-6 relative (float32 inverses through different LAPACK
# paths); raster hits agree on >= 99.9% of triangle ids (coplanar ties)
# with t within 2e-5; gbuffer planes agree to 1e-5 where the ids agree.
W, H = 64, 48
SCENES = {
    "cornell": (lambda m: m.cornell_box(), (0.0, 0.0, 2.4), (0.0, 0.0, -1.0)),
    "city4": (lambda m: m.city(n=4, subdiv=8), (0.0, 8.0, 14.0),
              (0.0, -0.45, -1.0)),
}


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, name, rtol=1e-6):
    a, b = np.asarray(a), _n(b)
    assert a.shape == b.shape, name
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        scale = max(float(np.abs(a).max()), 1e-30) if a.size else 1.0
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=name)


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    make, eye, fwd = SCENES[request.param]
    gpu_j = build_gpu_j(make(proc_j))
    ts_j, _ = build_ts_j(gpu_j)
    gpu_t = build_gpu_t(make(proc_t), device="cpu")
    ts_t, _ = build_ts_t(gpu_t, device="cpu")
    vj = view_j(eye, fwd, fov_y_deg=55.0, width=W, height=H)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    return request.param, gpu_j, gpu_t, ts_j, ts_t, vj, vt


@pytest.fixture(scope="module")
def hits(scene):
    """Raster hits of both packages, computed once per scene."""
    _, _, _, ts_j, ts_t, vj, vt = scene
    return raster_j.raster_hit(ts_j, vj, W, H), raster_t.raster_hit(ts_t, vt,
                                                                     W, H)


def test_procedural_meshes_match():
    for make in (lambda m: m.cornell_box(), lambda m: m.city(n=3, subdiv=4),
                 lambda m: m.random_tri_soup(50, seed=3)):
        sj, st = make(proc_j), make(proc_t)
        assert len(sj.meshes) == len(st.meshes)
        for mj, mt in zip(sj.meshes, st.meshes):
            for f in ("positions", "normals", "uvs", "tangents", "indices",
                      "material_ids"):
                np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
        for ij, it in zip(sj.instances, st.instances):
            np.testing.assert_array_equal(it.transform(), ij.transform())


def test_gpu_scene_tables(scene):
    _, gpu_j, gpu_t, *_ = scene
    for name in gpu_t.__dataclass_fields__:
        if getattr(gpu_j, name) is None:     # the texture tables, untextured
            assert getattr(gpu_t, name) is None, name
            continue
        _close(getattr(gpu_j, name), getattr(gpu_t, name), name)
    assert gpu_t.tri_idx.dtype == torch.int32


def test_trace_scene_tables(scene):
    name, _, _, ts_j, ts_t, *_ = scene
    # the Morton permutation (city) is exact: the int tables match
    for f in ("tri_idx", "tri_mat", "tri_inst", "light_tri"):
        _close(getattr(ts_j.gpu, f), getattr(ts_t.gpu, f), f)
    for f in ("v0", "e1", "e2", "inst_rot", "light_v0", "light_e1",
              "light_e2", "light_area", "light_emission", "light_normal",
              "tri_attrs", "vert_attrs"):
        _close(getattr(ts_j, f), getattr(ts_t, f), f)
    # the port's dictionary also carries the tables its kernels read
    extra = {"coef_rows", "coef_rows24"} | ({"coef_blocks", "block_bounds"}
                             if name == "city4" else set())
    assert set(ts_t.woop) == set(ts_j.woop) | extra
    assert ("cmin64" in ts_t.woop) == (name == "city4")
    for k in ts_j.woop:
        _close(ts_j.woop[k], ts_t.woop[k], k)


def test_raster_hit(hits):
    hj, ht = hits
    tri_j, tri_t = np.asarray(hj.tri), _n(ht.tri)
    assert tri_t.dtype == np.int32
    np.testing.assert_array_equal(tri_j >= 0, tri_t >= 0)
    m = tri_j >= 0
    assert m.mean() > 0.3
    assert (tri_j[m] == tri_t[m]).mean() >= 0.999
    np.testing.assert_allclose(_n(ht.t)[m], np.asarray(hj.t)[m], rtol=2e-5,
                               atol=2e-5)


def test_raster_gbuffer(scene, hits):
    _, _, _, ts_j, ts_t, vj, vt = scene
    gj = gb_j.raster_gbuffer(ts_j, vj, W, H)
    gt = gb_t.raster_gbuffer(ts_t, vt, W, H)
    assert set(gj) == set(gt)
    same = (np.asarray(hits[0].tri) == _n(hits[1].tri)).reshape(H, W)
    assert same.mean() >= 0.999
    for k in gj:
        a, b = np.asarray(gj[k]), _n(gt[k])
        assert a.shape == b.shape, k
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b[same], a[same], atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_gbuffer_from_identical_hits(scene, hits):
    """With the JAX hits handed over, the attribute fetch and packing agree
    on every pixel."""
    _, _, _, ts_j, ts_t, vj, vt = scene
    from kajiya_tpu.core.camera import camera_rays
    from kajiya_tpu_torch.rt.trace import Hit

    hj = hits[0]
    _, d = camera_rays(vj, W, H)
    gj = gb_j.gbuffer_from_hit(ts_j, vj, hj, d.reshape(-1, 3), W, H)
    ht = Hit(*(torch.as_tensor(np.array(x)) for x in (hj.t, hj.tri, hj.u,
                                                       hj.v)))
    gt = gb_t.gbuffer_from_hit(ts_t, vt, ht,
                               torch.as_tensor(np.array(d).reshape(-1, 3)),
                               W, H)
    for k in gj:
        np.testing.assert_allclose(_n(gt[k]).astype(np.float32),
                                   np.asarray(gj[k]).astype(np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
