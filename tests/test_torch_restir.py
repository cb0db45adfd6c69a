"""Port parity, the diffuse-GI passes one by one on cornell at 64x48. The JAX
package renders one warm-up frame, then its passes run by hand for the next
frame (frame index 3: a validation frame with live reservoirs). Every stage
of the port is fed the JAX-made inputs of that stage, so a decision that
flips in one pass cannot hide a fault in the next."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core import rng as rng_j
from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.ops import tileshift_pallas as ts_j
from kajiya_tpu.renderers import gbuffer as gbuffer_j
from kajiya_tpu.renderers import hit_lighting as hl_j
from kajiya_tpu.renderers import reprojection as reproj_j
from kajiya_tpu.renderers import restir_gi as restir_j
from kajiya_tpu.renderers import rtdgi as rtdgi_j
from kajiya_tpu.renderers import ssgi as ssgi_j
from kajiya_tpu.rt.trace import scene_trace_closest as trace_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.sky import env as sky_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.renderers import hit_lighting as hl_t
from kajiya_tpu_torch.renderers import restir_gi as restir_t
from kajiya_tpu_torch.renderers import rtdgi as rtdgi_t
from kajiya_tpu_torch.renderers import ssgi as ssgi_t
from kajiya_tpu_torch.rt.trace import Hit as HitT
from kajiya_tpu_torch.sky import env as sky_t

W, H = 64, 48
GI = dict(width=W, height=H, primary="raster", sun_soft_shadows=True,
          use_ssao=True, use_rtdgi=True, use_restir_gi=True,
          secondary_full_shading=True, use_rtr=False, use_ircache=False,
          use_taa=False, use_motion_blur=False)


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


def _hit_t(h):
    return HitT(t=_t(h.t), tri=_t(h.tri), u=_t(h.u), v=_t(h.v))


def assert_frac(got, ref, tol, frac, name):
    """|got - ref| <= tol on at least `frac` of the elements."""
    got, ref = _n(got).astype(np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    ok = np.abs(got - ref) <= tol
    assert ok.mean() >= frac, (name, ok.mean(), np.abs(got - ref).max())


@pytest.fixture(scope="module")
def stages():
    """JAX's inputs and outputs of every GI pass of one frame."""
    ts_jx, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    ts_tx = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_jx),
                                           device="cpu")
    cfg = CfgJ(**GI)
    fwd = (0.0, 0.0, -1.0)
    v0 = view_j((0.0, 0.0, 2.4), fwd, fov_y_deg=55.0, width=W, height=H)
    v1 = view_j((0.04, 0.013, 2.4), fwd, fov_y_deg=55.0, width=W, height=H,
                prev=v0)
    # warm-up frame at frame index 2 (no validation): live reservoirs,
    # prev_lit and prev_depth for the frame under test
    s0 = dict(init_j(cfg), frame_idx=jnp.asarray(2, jnp.int32))
    state, _ = render_j(ts_jx, s0, v0, cfg)
    frame_idx = state["frame_idx"]
    assert int(frame_idx) == 3

    sun_dir = ts_jx.gpu.sun_direction
    sky_sh = sky_j.project_sh9(sky_j.build_sky_env(sun_dir, res=32))
    envs_j = (sky_j.sh9_radiance_fn(sky_sh), sky_j.sh9_irradiance_fn(sky_sh))
    sh_t = _t(sky_sh)
    envs_t = (sky_t.sh9_radiance_fn(sh_t), sky_t.sh9_irradiance_fn(sh_t))

    gb = gbuffer_j.raster_gbuffer(ts_jx, v1, W, H)
    reproj = reproj_j.calculate_reprojection_map(gb, state["prev_depth"], v1)
    ssao_state = {"ssao_history": state["ssao_history"]}
    ao, ssao_new = ssgi_j.ssao_pipeline(gb, v1, frame_idx, ssao_state, reproj)
    gb_h = rtdgi_j.half_gbuffer(gb)
    restir_state = {k: v for k, v in state.items()
                    if k.startswith("gi_res_")}
    shade_kw = dict(prev_lit=state["prev_lit"],
                    prev_depth=state["prev_depth"], view=v1,
                    full_shading=True)

    org_v, d_v, ctx = restir_j.validation_rays(restir_state, gb_h)
    hit_v = trace_j(ts_jx, org_v, d_v, t_min=1e-4, sort=True)
    fresh = hl_j.hit_radiance(ts_jx, hit_v, d_v, *envs_j, **shade_kw)
    valid_state, invalidity = restir_j.apply_validation(
        restir_state, ctx, hit_v.t, fresh)

    org_c, wi_c, rng_c = rtdgi_j.candidate_rays(gb_h, frame_idx)
    hit_c = trace_j(ts_jx, org_c, wi_c, t_min=1e-4, sort=True)
    rad_c, aux_c = hl_j.hit_radiance(ts_jx, hit_c, wi_c, *envs_j, rng=rng_c,
                                     return_aux=True, **shade_kw)
    cands = rtdgi_j.finish_candidates(gb_h, org_c, wi_c, hit_c.hit_mask,
                                      hit_c.t, rad_c, aux_c)
    res, next_state = restir_j.restir_diffuse(
        valid_state, cands, gb_h, reproj, frame_idx,
        ssao_h=None, view=v1)
    full = restir_j.resolve(res, gb)
    full_split = restir_j.resolve(res, gb, candidates=cands, ssao=ao)
    hist = {"rtdgi_history": state["rtdgi_history"],
            "rtdgi_hist_len": state["rtdgi_hist_len"]}
    dgi, hist_new, restir_new, _ = rtdgi_j.rtdgi_pipeline(
        ts_jx, gb, v1, frame_idx, hist, reproj, *envs_j, ssao=ao,
        prev_lit=state["prev_lit"], prev_depth=state["prev_depth"],
        use_restir=True, restir_state=valid_state,
        secondary_full_shading=True, candidates=cands,
        invalidity=invalidity, validated=True)
    return types.SimpleNamespace(
        ts_j=ts_jx, ts_t=ts_tx, frame_idx=int(frame_idx),
        view_t=convert.view_from_numpy(convert.to_numpy_dict(v1),
                                       device="cpu"),
        envs_j=envs_j, shade_kw_j=shade_kw, envs_t=envs_t, state=state,
        gb=gb, reproj=reproj, ao=ao,
        ssao_state=ssao_state, ssao_new=ssao_new, gb_h=gb_h,
        restir_state=restir_state, org_v=org_v, d_v=d_v, ctx=ctx,
        hit_v=hit_v, fresh=fresh, valid_state=valid_state,
        invalidity=invalidity, org_c=org_c, wi_c=wi_c, rng_c=rng_c,
        hit_c=hit_c, rad_c=rad_c, aux_c=aux_c, cands=cands, res=res,
        next_state=next_state, full=full, full_split=full_split, hist=hist,
        dgi=dgi, hist_new=hist_new, restir_new=restir_new)


def _shade_kw_t(s):
    return dict(prev_lit=_t(s.state["prev_lit"]),
                prev_depth=_t(s.state["prev_depth"]), view=s.view_t,
                full_shading=True)


def test_warm_state_is_live(stages):
    s = stages
    assert float(np.asarray(s.restir_state["gi_res_M"]).max()) >= 1.0
    assert bool(np.asarray(s.ctx["live"]).any())
    assert float(np.asarray(s.invalidity).max()) > 0.0
    assert bool(np.asarray(s.cands["valid"]).any())


def test_ssao_pipeline(stages):
    """1e-6 absolute on the AO and its history."""
    s = stages
    ao, new = ssgi_t.ssao_pipeline(_t(s.gb), s.view_t, s.frame_idx,
                                   _t(s.ssao_state), _t(s.reproj))
    np.testing.assert_allclose(_n(ao), np.asarray(s.ao), atol=1e-6)
    np.testing.assert_allclose(_n(new["ssao_history"]),
                               np.asarray(s.ssao_new["ssao_history"]),
                               atol=1e-6)


def test_candidate_rays(stages):
    """Origins and directions to 1e-6, the seed lattice exactly."""
    s = stages
    org, wi, rng = rtdgi_t.candidate_rays(_t(s.gb_h), s.frame_idx)
    np.testing.assert_allclose(_n(org), np.asarray(s.org_c), atol=1e-6)
    np.testing.assert_allclose(_n(wi), np.asarray(s.wi_c), atol=1e-6)
    np.testing.assert_array_equal(_n(rng).astype(np.uint32),
                                  np.asarray(s.rng_c))


@pytest.mark.parametrize("batch", ["candidates", "validation"])
def test_hit_radiance(stages, batch):
    """From JAX's hits: 1e-5 absolute on >= 99.5% of the rays (a shadow ray
    that grazes an edge may resolve differently), aux to 1e-5."""
    s = stages
    if batch == "candidates":
        rad, aux = hl_t.hit_radiance(
            s.ts_t, _hit_t(s.hit_c), _t(s.wi_c), *s.envs_t, rng=_t(s.rng_c),
            return_aux=True, **_shade_kw_t(s))
        assert_frac(rad, s.rad_c, 1e-5, 0.995, "radiance")
        for k in ("hit_pos", "hit_geo_normal"):
            assert_frac(aux[k], s.aux_c[k], 1e-5, 0.995, k)
        assert float(rad.max()) > 1.0       # the emissive quad is seen
    else:
        fresh = hl_t.hit_radiance(s.ts_t, _hit_t(s.hit_v), _t(s.d_v),
                                  *s.envs_t, **_shade_kw_t(s))
        assert_frac(fresh, s.fresh, 1e-5, 0.995, "fresh")


def test_hit_radiance_refuses_unported_lookups(stages):
    """No lookup is refused any more: the world radiance cache's lookup
    replaces the shade of hits beyond `wrc_min_t`. From JAX's candidate
    hits, with a direction-dependent stand-in lookup and wrc_min_t = 1 (the
    box is ~2 units deep, so both branches occur): 1e-5 on >= 99.5% of the
    rays, as test_hit_radiance, and the far hits carry the lookup's value."""
    s = stages

    def wrc_j(p, d):
        return 0.25 + 0.5 * jnp.abs(d) + 0.0 * p

    def wrc_t(p, d):
        return 0.25 + 0.5 * torch.abs(d) + 0.0 * p

    ref = hl_j.hit_radiance(s.ts_j, s.hit_c, s.wi_c, *s.envs_j,
                            wrc_lookup=wrc_j, wrc_min_t=1.0,
                            **s.shade_kw_j)
    got = hl_t.hit_radiance(s.ts_t, _hit_t(s.hit_c), _t(s.wi_c), *s.envs_t,
                            wrc_lookup=wrc_t, wrc_min_t=1.0,
                            **_shade_kw_t(s))
    assert_frac(got, ref, 1e-5, 0.995, "radiance with wrc")
    far = np.asarray(s.hit_c.hit_mask) & (np.asarray(s.hit_c.t) > 1.0)
    assert far.any() and (~far).any()
    np.testing.assert_allclose(
        _n(got)[far], 0.25 + 0.5 * np.abs(np.asarray(s.wi_c))[far],
        atol=1e-6)


def test_finish_candidates(stages):
    s = stages
    c = rtdgi_t.finish_candidates(
        _t(s.gb_h), _t(s.org_c), _t(s.wi_c), _t(s.hit_c.hit_mask),
        _t(s.hit_c.t), _t(s.rad_c), _t(s.aux_c))
    assert set(c) == set(s.cands)
    np.testing.assert_array_equal(_n(c["valid"]), np.asarray(s.cands["valid"]))
    for k in ("radiance", "ray_dir", "ray_t", "hit_normal"):
        np.testing.assert_allclose(_n(c[k]), np.asarray(s.cands[k]),
                                   atol=1e-6, err_msg=k)
    # sky misses park their virtual hit 1e4 away: relative tolerance
    np.testing.assert_allclose(_n(c["hit_pos"]),
                               np.asarray(s.cands["hit_pos"]), rtol=1e-6,
                               atol=1e-6)


def test_validation_rays_and_apply(stages):
    """Rays to 1e-6 with equal `live` masks; the validated reservoir planes
    and the invalidity to 1e-5."""
    s = stages
    org, d, ctx = restir_t.validation_rays(_t(s.restir_state), _t(s.gb_h))
    np.testing.assert_allclose(_n(org), np.asarray(s.org_v), atol=1e-6)
    np.testing.assert_allclose(_n(d), np.asarray(s.d_v), atol=1e-6)
    np.testing.assert_array_equal(_n(ctx["live"]), np.asarray(s.ctx["live"]))
    np.testing.assert_allclose(_n(ctx["t_old"]), np.asarray(s.ctx["t_old"]),
                               rtol=1e-6, atol=1e-6)
    assert (ctx["qh"], ctx["qw"]) == (s.ctx["qh"], s.ctx["qw"])
    ctx_j = {k: (v if isinstance(v, int) else _t(v))
             for k, v in s.ctx.items()}
    new, inv = restir_t.apply_validation(_t(s.restir_state), ctx_j,
                                         _t(s.hit_v.t), _t(s.fresh))
    np.testing.assert_allclose(_n(inv), np.asarray(s.invalidity), atol=1e-5)
    assert set(new) == set(s.valid_state)
    for k in new:
        np.testing.assert_allclose(_n(new[k]), np.asarray(s.valid_state[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("pass_idx", [0, 1])
@pytest.mark.parametrize("size", [(24, 32), (540, 960)])
def test_spatial_tap_offsets_exact(pass_idx, size):
    """The per-tile tap offsets equal the JAX pass's exactly: one differing
    offset would move a whole (8, 128) tile's tap by a pixel."""
    hh, hw = size
    radius, n_taps = ((12.0, 7), (6.0, 4))[pass_idx]
    assert restir_t.SPATIAL_PASSES[pass_idx] == (radius, n_taps)
    for frame_idx in (0, 3, 100):
        nty, ntx = ts_j.tile_grid(hh, hw)
        trow = jnp.arange(nty * ntx, dtype=jnp.uint32)
        t_rng = rng_j.pixel_rng(trow % jnp.uint32(ntx),
                                trow // jnp.uint32(ntx),
                                jnp.uint32(frame_idx), stream=47 + pass_idx)
        u_ang, _ = rng_j.rand_u01(t_rng)
        ks = jnp.arange(1, n_taps + 1, dtype=jnp.float32)
        ang = (ks[:, None] + u_ang[None, :]) * 2.39996323
        r = jnp.sqrt(ks / n_taps)[:, None] * radius
        dy_j = jnp.round(jnp.sin(ang) * r).astype(jnp.int32)
        dx_j = jnp.round(jnp.cos(ang) * r).astype(jnp.int32)
        dy, dx = restir_t.spatial_offsets(hh, hw, frame_idx, pass_idx,
                                            device="cpu")
        assert dy.dtype == torch.int32 and dx.dtype == torch.int32
        bad = np.argwhere((_n(dy) != np.asarray(dy_j))
                          | (_n(dx) != np.asarray(dx_j)))
        assert bad.size == 0, f"(tap, tile) pairs that differ: {bad[:8]}"


def test_restir_diffuse(stages):
    """From JAX's validated state and candidates: the reservoirs after the
    temporal pass (the next frame's state) and after both spatial passes
    hold the same sample on >= 99% of the lanes (payload within 1e-5), with
    M within 1e-4 and the weights within 1e-4 relative on those lanes."""
    s = stages
    res, nxt = restir_t.restir_diffuse(
        _t(s.valid_state), _t(s.cands), _t(s.gb_h), _t(s.reproj),
        s.frame_idx, ssao_h=None, view=s.view_t)
    for name, got, ref in (("spatial", restir_t._unpack(res),
                            restir_j._unpack(s.res)),
                           ("temporal", nxt, s.next_state)):
        same = np.ones((H // 2, W // 2), bool)
        for k in ("gi_res_payload_radiance", "gi_res_payload_hitn"):
            same &= (np.abs(_n(got[k]) - np.asarray(ref[k])) <= 1e-5).all(-1)
        hit_ref = np.asarray(ref["gi_res_payload_hit"])
        same &= (np.abs(_n(got["gi_res_payload_hit"]) - hit_ref)
                 <= 1e-5 * np.maximum(1.0, np.abs(hit_ref))).all(-1)
        assert same.mean() >= 0.99, (name, same.mean())
        m_got, m_ref = _n(got["gi_res_M"]), np.asarray(ref["gi_res_M"])
        assert np.abs(m_got - m_ref)[same].max() <= 1e-4, name
        for k in ("gi_res_w_sum", "gi_res_W", "gi_res_p_hat"):
            np.testing.assert_allclose(_n(got[k])[same],
                                       np.asarray(ref[k])[same], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}/{k}")
    assert float(_n(res["M"]).max()) > float(_n(nxt["gi_res_M"]).max())


@pytest.mark.parametrize("split", [False, True])
def test_resolve(stages, split):
    """From JAX's reservoirs: 1e-5 absolute on >= 99.5% of pixels, with and
    without the near / far split."""
    s = stages
    kw = dict(candidates=_t(s.cands), ssao=_t(s.ao)) if split else {}
    full = restir_t.resolve(_t(s.res), _t(s.gb), **kw)
    ref = s.full_split if split else s.full
    assert_frac(full, ref, 1e-5, 0.995, "resolve")
    assert float(full.mean()) > 1e-3


def test_rtdgi_pipeline(stages):
    """Temporal + spatial reservoirs, resolve, temporal filter and variance
    clamp from JAX's candidates and invalidity: 1e-4 absolute on >= 99% of
    pixels, history length to 1e-4."""
    s = stages
    dgi, hist_new, restir_new, cands = rtdgi_t.rtdgi_pipeline(
        s.ts_t, _t(s.gb), s.view_t, s.frame_idx, _t(s.hist), _t(s.reproj),
        *s.envs_t, ssao=_t(s.ao), prev_lit=_t(s.state["prev_lit"]),
        prev_depth=_t(s.state["prev_depth"]), use_restir=True,
        restir_state=_t(s.valid_state), secondary_full_shading=True,
        candidates=_t(s.cands), invalidity=_t(s.invalidity), validated=True)
    assert_frac(dgi, s.dgi, 1e-4, 0.99, "diffuse_gi")
    assert_frac(hist_new["rtdgi_history"], s.hist_new["rtdgi_history"], 1e-4,
                0.99, "history")
    np.testing.assert_allclose(_n(hist_new["rtdgi_hist_len"]),
                               np.asarray(s.hist_new["rtdgi_hist_len"]),
                               atol=1e-4)
    assert set(restir_new) == set(s.restir_new)
    assert_frac(restir_new["gi_res_M"], s.restir_new["gi_res_M"], 1e-4, 0.99,
                "M")


def test_standalone_trace_and_validate(stages):
    """The non-batched entry points (`trace_candidates`,
    `validate_reservoirs`) against the JAX ones: 1e-5 on >= 99.5%."""
    s = stages
    # the JAX side is the fixture's batched result: same rays, same shading
    kw = dict(prev_lit=_t(s.state["prev_lit"]),
              prev_depth=_t(s.state["prev_depth"]), view=s.view_t)
    c = rtdgi_t.trace_candidates(s.ts_t, _t(s.gb_h), s.frame_idx, *s.envs_t,
                                 secondary_full_shading=True, **kw)
    assert_frac(c["radiance"], s.cands["radiance"], 1e-5, 0.995, "radiance")
    assert_frac(c["ray_t"], s.cands["ray_t"], 2e-5, 0.995, "ray_t")
    new, inv = restir_t.validate_reservoirs(
        s.ts_t, _t(s.restir_state), _t(s.gb_h), *s.envs_t, s.frame_idx,
        secondary_full_shading=True, **kw)
    assert_frac(inv, s.invalidity, 1e-5, 0.995, "invalidity")
    assert_frac(new["gi_res_M"], s.valid_state["gi_res_M"], 1e-5, 0.995, "M")
