"""Port parity, the reflections: `brdf/ggx.py` (VNDF), `renderers/rtr.py`
and `renderers/lighting.py` of `kajiya_tpu_torch` against `kajiya_tpu` on
cornell at 64x48. Stage tests feed the port the JAX-made inputs of the
stage (gbuffer, reprojection, reflection trace, seeded reservoir planes), so
a decision that flips in one stage cannot hide a fault in the next."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.brdf import ggx as ggx_j
from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.renderers import gbuffer as gbuffer_j
from kajiya_tpu.renderers import lighting as lighting_j
from kajiya_tpu.renderers import reprojection as reproj_j
from kajiya_tpu.renderers import rtdgi as rtdgi_j
from kajiya_tpu.renderers import rtr as rtr_j
from kajiya_tpu.rt.trace import scene_trace_closest as trace_j
from kajiya_tpu.renderers import hit_lighting as hl_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.sky import env as sky_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.brdf import ggx as ggx_t
from kajiya_tpu_torch.renderers import lighting as lighting_t
from kajiya_tpu_torch.renderers import rtr as rtr_t
from kajiya_tpu_torch.sky import env as sky_t

W, H = 64, 48
FWD = (0.0, 0.0, -1.0)
STEP = (0.04, 0.013, 0.0)    # the GI tests' camera step (knife-edge note
                             # in test_torch_frame_gi.py)


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    """numpy / JAX array or (nested) dict of them -> CPU tensors; uint32 seed
    lattices become the port's int64 carriers."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return torch.as_tensor(a.astype(np.int64))
    return torch.as_tensor(np.array(a))


def assert_frac(got, ref, tol, frac, name, rtol=0.0):
    """|got - ref| <= tol + rtol * |ref| on at least `frac` of the
    elements."""
    got, ref = _n(got).astype(np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    ok = np.abs(got - ref) <= tol + rtol * np.abs(ref)
    assert ok.mean() >= frac, (name, ok.mean(), np.abs(got - ref).max())


def _view(k, prev=None):
    e = tuple(np.asarray((0.0, 0.0, 2.4)) + k * np.asarray(STEP))
    return view_j(e, FWD, fov_y_deg=55.0, width=W, height=H, prev=prev)


def seeded_reservoirs(seed, hh, hw, scale=1.0):
    """rtr_res_* planes: radiance, unit directions around +z, hit
    distances, and consistent reservoir weights."""
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(hh, hw, 3)) + np.array([0.0, 0.0, 1.5])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m = rs.integers(0, 6, (hh, hw)).astype(np.float32)
    p_hat = rs.uniform(0.05, 2.0, (hh, hw))
    w_sum = rs.uniform(0.0, 3.0, (hh, hw)) * (m > 0)
    return {
        "rtr_res_radiance": (rs.uniform(0, 2, (hh, hw, 3)) * scale),
        "rtr_res_dir": d,
        "rtr_res_t": rs.uniform(0.05, 3.0, (hh, hw)),
        "rtr_res_w_sum": w_sum,
        "rtr_res_M": m,
        "rtr_res_W": np.where(m > 0, w_sum / np.maximum(m * p_hat, 1e-8), 0),
        "rtr_res_p_hat": p_hat,
    }


def _f32(d):
    return {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}


@pytest.fixture(scope="module")
def stages():
    """JAX's inputs and outputs of every RTR stage at frame index 3."""
    ts_j, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    v0 = _view(0)
    v1 = _view(1, prev=v0)
    gb0 = gbuffer_j.raster_gbuffer(ts_j, v0, W, H)
    gb = gbuffer_j.raster_gbuffer(ts_j, v1, W, H)
    reproj = reproj_j.calculate_reprojection_map(gb, gb0["depth"], v1)
    sky_sh = sky_j.project_sh9(sky_j.build_sky_env(ts_j.gpu.sun_direction,
                                                   res=32))
    envs_j = (sky_j.sh9_radiance_fn(sky_sh), sky_j.sh9_irradiance_fn(sky_sh))
    sh_t = _t(sky_sh)
    envs_t = (sky_t.sh9_radiance_fn(sh_t), sky_t.sh9_irradiance_fn(sh_t))
    frame_idx = 3
    hh, hw = H // 2, W // 2

    org, wi, pdf, rng = rtr_j.reflection_rays(gb, frame_idx)
    half = rtr_j.trace_reflections(ts_j, gb, frame_idx, *envs_j,
                                   secondary_full_shading=True)
    cands = rtdgi_j.trace_candidates(ts_j, rtdgi_j.half_gbuffer(gb),
                                     frame_idx, *envs_j,
                                     secondary_full_shading=True)
    res_state = _f32(seeded_reservoirs(5, hh, hw))
    spec, ray_len, res_new = rtr_j.restir_reflections(
        res_state, half, gb, reproj, frame_idx, rtdgi_candidates=cands)

    org_v, d_v, ctx = rtr_j.validation_rays(res_state, gb)
    hit_v = trace_j(ts_j, org_v, d_v, t_min=1e-4)
    fresh = hl_j.hit_radiance(ts_j, hit_v, d_v, *envs_j, full_shading=True)
    # stored radiance that disagrees with the fresh trace on about half of
    # the lanes, so both branches of the validation run
    rs = np.random.default_rng(9)
    rad_q = np.asarray(fresh).reshape(ctx["qh"], ctx["qw"], 3) * np.where(
        rs.random((ctx["qh"], ctx["qw"], 1)) < 0.5, 1.0, 3.0)
    ctx = dict(ctx, rad_q=jnp.asarray(rad_q, jnp.float32))
    valid_state = rtr_j.apply_validation(res_state, ctx, hit_v.t, fresh)

    fp_planes = _f32(seeded_reservoirs(6, hh, hw))
    spec_h = jnp.asarray(np.random.default_rng(3).uniform(0, 1, (hh, hw, 3)),
                         jnp.float32)
    fp = rtr_j._resolve_footprint(fp_planes, spec_h,
                                  fp_planes["rtr_res_t"], gb, v1)
    full = rtr_j._resolve_full(spec_h, fp_planes["rtr_res_t"], gb)
    spec_l = lighting_j.sample_lights_specular(ts_j, gb, frame_idx)
    return types.SimpleNamespace(
        ts_j=ts_j, ts_t=ts_t, gb=gb, reproj=reproj, envs_j=envs_j,
        envs_t=envs_t, frame_idx=frame_idx, org=org, wi=wi, pdf=pdf, rng=rng,
        half=half, cands=cands, res_state=res_state, spec=spec,
        ray_len=ray_len, res_new=res_new, org_v=org_v, d_v=d_v, ctx=ctx,
        hit_v=hit_v, fresh=fresh, valid_state=valid_state,
        fp_planes=fp_planes, spec_h=spec_h, fp=fp, full=full, spec_l=spec_l,
        view_t=convert.view_from_numpy(convert.to_numpy_dict(v1),
                                       device="cpu"))


@pytest.mark.parametrize("rough", [0.0, 0.05, 0.4, 1.0])
def test_vndf_sample_and_pdf(rough):
    """sample_vndf and pdf_vndf on seeded normals, view directions and
    uniforms: within 1e-6 on >= 99.8% of the lanes and within 1e-4 on all.
    sin / cos of the disk angle differ by an ulp between the two libraries
    on ~5% of the lanes, and where u1 -> 1 the sample lies on the disk's rim,
    where pz = sqrt(1 - p1^2 - p2^2) turns that ulp into ~1e-5. The pdf:
    relative 1e-5 on >= 99% of the lanes and 0.25 on all: near the peak of
    a glossy lobe 1 - n.h is a few ulps of float32, so the ulp by which the
    two libraries' n.h may differ moves D by up to ~10% (roughness 0.05)."""
    rs = np.random.default_rng(int(rough * 100))
    n = rs.normal(size=(4096, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wo = rs.normal(size=(4096, 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    u1, u2 = rs.random(4096), rs.random(4096)
    r = np.full(4096, rough)
    args = [x.astype(np.float32) for x in (r, n, wo, u1, u2)]
    wi_j = ggx_j.sample_vndf(*map(jnp.asarray, args))
    wi_t = ggx_t.sample_vndf(*map(torch.as_tensor, args))
    err = np.abs(_n(wi_t) - np.asarray(wi_j)).max(-1)
    assert (err <= 1e-6).mean() >= 0.995 and err.max() <= 1e-4, err.max()
    pdf_args = [args[0], args[1], args[2], np.array(wi_j)]
    pj = ggx_j.pdf_vndf(*map(jnp.asarray, pdf_args))
    pt = ggx_t.pdf_vndf(*map(torch.as_tensor, pdf_args))
    rel = np.abs(_n(pt) - np.asarray(pj)) / np.asarray(pj)
    assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 0.25, rel.max()


def test_reflection_rays(stages):
    """The seed lattice exactly; origins, directions and pdfs within 1e-6
    (pdfs relative: mirror lobes reach ~1e5)."""
    s = stages
    org, wi, pdf, rng = rtr_t.reflection_rays(_t(s.gb), s.frame_idx)
    np.testing.assert_array_equal(_n(rng).astype(np.uint32),
                                  np.asarray(s.rng))
    np.testing.assert_allclose(_n(org), np.asarray(s.org), atol=1e-6)
    np.testing.assert_allclose(_n(wi), np.asarray(s.wi), atol=1e-6)
    np.testing.assert_allclose(_n(pdf), np.asarray(s.pdf), rtol=1e-5,
                               atol=1e-6)


def test_trace_reflections(stages):
    """The standalone trace: radiance within 1e-5 on >= 99.5% of lanes."""
    s = stages
    half = rtr_t.trace_reflections(s.ts_t, _t(s.gb), s.frame_idx, *s.envs_t,
                                   secondary_full_shading=True)
    assert set(half) == set(s.half)
    np.testing.assert_array_equal(_n(half["valid"]),
                                  np.asarray(s.half["valid"]))
    assert_frac(half["radiance"], s.half["radiance"], 1e-5, 0.995, "radiance")
    assert_frac(half["ray_t"], s.half["ray_t"], 1e-5, 0.995, "ray_t")


def test_restir_reflections(stages):
    """From JAX's reflection trace, GI candidates and seeded reservoirs:
    estimate, ray length and every reservoir plane within 1e-5 (weights
    relative)."""
    s = stages
    spec, ray_len, res = rtr_t.restir_reflections(
        _t(s.res_state), _t(s.half), _t(s.gb), _t(s.reproj), s.frame_idx,
        rtdgi_candidates=_t(s.cands))
    np.testing.assert_allclose(_n(spec), np.asarray(s.spec), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_n(ray_len), np.asarray(s.ray_len), rtol=1e-5,
                               atol=1e-5)
    assert set(res) == set(s.res_new)
    for k in res:
        np.testing.assert_allclose(_n(res[k]), np.asarray(s.res_new[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(_n(res["rtr_res_M"]).max()) > 1.0


def test_validation_rays_and_apply(stages):
    """Rays within 1e-6 with equal `live` masks; the validated planes within
    1e-5 from JAX's re-trace."""
    s = stages
    org, d, ctx = rtr_t.validation_rays(_t(s.res_state), _t(s.gb))
    np.testing.assert_allclose(_n(org), np.asarray(s.org_v), atol=1e-6)
    np.testing.assert_allclose(_n(d), np.asarray(s.d_v), atol=1e-6)
    np.testing.assert_array_equal(_n(ctx["live"]), np.asarray(s.ctx["live"]))
    assert (ctx["qh"], ctx["qw"]) == (s.ctx["qh"], s.ctx["qw"])
    ctx_j = {k: (v if isinstance(v, int) else _t(v))
             for k, v in s.ctx.items()}
    new = rtr_t.apply_validation(_t(s.res_state), ctx_j, _t(s.hit_v.t),
                                 _t(s.fresh))
    assert set(new) == set(s.valid_state)
    changed = 0
    for k in new:
        np.testing.assert_allclose(_n(new[k]), np.asarray(s.valid_state[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        changed += int((np.asarray(s.valid_state[k])
                        != np.asarray(s.res_state[k])).sum())
    assert changed > 0


def test_resolve_footprint_and_full(stages):
    """The 13-tap lobe resolve and the joint-bilateral resolve from seeded
    reservoir planes: within 1e-5."""
    s = stages
    spec, t = rtr_t._resolve_footprint(_t(s.fp_planes), _t(s.spec_h),
                                       _t(s.fp_planes["rtr_res_t"]),
                                       _t(s.gb), s.view_t)
    np.testing.assert_allclose(_n(spec), np.asarray(s.fp[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_n(t), np.asarray(s.fp[1]), rtol=1e-5,
                               atol=1e-5)
    assert float(_n(spec).max()) > 0.0
    spec2, t2 = rtr_t._resolve_full(_t(s.spec_h),
                                    _t(s.fp_planes["rtr_res_t"]), _t(s.gb))
    np.testing.assert_allclose(_n(spec2), np.asarray(s.full[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_n(t2), np.asarray(s.full[1]), rtol=1e-5,
                               atol=1e-5)


def test_sample_lights_specular(stages):
    """Mesh-light specular on cornell: within 1e-4 (>= 99.5% of lanes; a
    shadow ray grazing an edge may resolve differently), and not zero."""
    s = stages
    spec = lighting_t.sample_lights_specular(s.ts_t, _t(s.gb), s.frame_idx)
    assert_frac(spec, s.spec_l, 1e-4, 0.995, "spec")
    assert float(np.asarray(s.spec_l).max()) > 1e-3


N_FRAMES = 4


@pytest.fixture(scope="module")
def pipeline_runs():
    """Four frames of the standalone rtr_pipeline (own trace, every-third-
    frame validation, mesh-light specular, the GI candidates joining rough
    lobes) in both packages, each threading its own reflection state, from
    JAX's gbuffers and reprojection maps."""
    ts_j, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    sky_sh = sky_j.project_sh9(sky_j.build_sky_env(ts_j.gpu.sun_direction,
                                                   res=32))
    envs_j = (sky_j.sh9_radiance_fn(sky_sh), sky_j.sh9_irradiance_fn(sky_sh))
    sh_t = _t(sky_sh)
    envs_t = (sky_t.sh9_radiance_fn(sh_t), sky_t.sh9_irradiance_fn(sh_t))
    sj = rtr_j.init_state(H, W)
    st = rtr_t.init_state(H, W)
    prev_depth = jnp.zeros((H, W), jnp.float32)
    v, out = None, []
    for f in range(N_FRAMES):
        v = _view(f, prev=v)
        gb = gbuffer_j.raster_gbuffer(ts_j, v, W, H)
        reproj = reproj_j.calculate_reprojection_map(gb, prev_depth, v)
        prev_depth = gb["depth"]
        cands = rtdgi_j.trace_candidates(ts_j, rtdgi_j.half_gbuffer(gb), f,
                                         *envs_j, secondary_full_shading=True)
        kw = dict(mesh_light_specular=True, secondary_full_shading=True)
        oj, sj = rtr_j.rtr_pipeline(ts_j, gb, v, f, sj, reproj, *envs_j,
                                    rtdgi_candidates=cands, **kw)
        vt = convert.view_from_numpy(convert.to_numpy_dict(v), device="cpu")
        ot, st = rtr_t.rtr_pipeline(ts_t, _t(gb), vt, f, st, _t(reproj),
                                    *envs_t, rtdgi_candidates=_t(cands), **kw)
        out.append((oj, sj, ot, st))
    return out


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_rtr_pipeline(pipeline_runs, frame):
    """Reflections and every state plane within 1e-3 on >= 99% of pixels;
    the ray length within 1e-3 + 1e-4 relative (sky reflections carry
    1e8, where a float32 ulp is 8)."""
    oj, sj, ot, st = pipeline_runs[frame]
    assert_frac(ot, oj, 1e-3, 0.99, "reflections")
    assert set(sj) == set(st)
    for k in sj:
        assert_frac(st[k], sj[k], 1e-3, 0.99, k,
                    rtol=1e-4 if k == "rtr_ray_len" else 0.0)
    assert float(_n(ot).min()) >= 0.0 and float(_n(ot).mean()) > 1e-3
