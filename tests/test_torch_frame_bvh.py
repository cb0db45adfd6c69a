"""Port parity on the BVH route (scenes above `brute_max_tris` triangles,
forced here with brute_max_tris=0) on cornell: the trace scene built by both
packages, carried over by `convert` and traced by both walks; the reference
path tracer per path and over four progressive frames (JAX's compiled, as
test_torch_reference_pt.py runs it), refit every frame through `levels`;
`Renderer`'s refit after a move. The default frame on this route runs in
test_torch_frame_bvh_default.py (cornell) and test_torch_frame_bvh_city.py
(city(n=2)), so the files land on different workers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core import camera as cam_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_reference_state as init_ref_j
from kajiya_tpu.frame import render_frame_reference as render_ref_j
from kajiya_tpu.rt import trace as trace_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.core import camera as cam_t
from kajiya_tpu_torch.frame import RenderConfig as CfgT
from kajiya_tpu_torch.frame import Renderer
from kajiya_tpu_torch.frame import init_reference_state as init_ref_t
from kajiya_tpu_torch.frame import render_frame_reference as render_ref_t
from kajiya_tpu_torch.renderers import reference as ref_t
from kajiya_tpu_torch.rt import trace as trace_t
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
from kajiya_tpu_torch.world import build_trace_scene as build_ts_t
from test_torch_frame import W, H, _n
from test_torch_frame_default import CORNELL
from test_torch_reference_pt import (assert_paths_agree, primary_rays, seeds,
                                     trace_both)

BVH = dict(brute_max_tris=0)


def bvh_scenes(make):
    """JAX's BVH-route trace scene and levels, and both carried over."""
    ts_j, lv_j = build_ts_j(build_gpu_j(make()), **BVH)
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    lv_t = convert.levels_from_numpy(convert.to_numpy_dict(lv_j),
                                     device="cpu")
    return ts_j, lv_j, ts_t, lv_t


@pytest.fixture(scope="module")
def cornell():
    return bvh_scenes(CORNELL[0])


def test_build_trace_scene_takes_the_bvh_route(cornell):
    """The port's own BVH-route build equals JAX's: no Woop tables, the same
    BVH bytes and refit schedule, the same triangle and attribute tables."""
    ts_j, lv_j, ts_c, lv_c = cornell
    ts_t, lv_t = build_ts_t(build_gpu_t(proc_t.cornell_box(), device="cpu"),
                            device="cpu", **BVH)
    assert ts_j.woop is None and ts_t.woop is None and ts_c.woop is None
    assert lv_t["use_brute"] is False and lv_j["use_brute"] is False
    for f in ("node_min", "node_max", "node_first", "node_count",
              "node_skip", "tri_order"):
        a = np.asarray(getattr(ts_j.bvh, f))
        for b in (getattr(ts_t.bvh, f), getattr(ts_c.bvh, f)):
            assert b.numpy().dtype == a.dtype and b.numpy().tobytes() == \
                a.tobytes(), f
    for lv in (lv_t, lv_c):
        assert len(lv["levels"]) == len(lv_j["levels"])
        for a, b in zip(lv_j["levels"], lv["levels"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y.numpy(), x)
    for f in ("v0", "e1", "e2", "tri_attrs", "vert_attrs", "light_v0",
              "light_area", "light_emission"):
        np.testing.assert_array_equal(getattr(ts_t, f).numpy(),
                                      np.asarray(getattr(ts_j, f)), err_msg=f)
    # the Woop route builds no BVH
    ts_w, lv_w = build_ts_t(build_gpu_t(proc_t.cornell_box(), device="cpu"),
                            device="cpu")
    assert ts_w.bvh is None and ts_w.woop is not None and lv_w["use_brute"]


def test_carried_over_scene_traces_the_same_hits(cornell):
    """A JAX BVH-route TraceScene carried over by `convert` traces JAX's
    hits: camera rays (closest), and shadow rays from seeded points inside
    the box to seeded points on the light quad, limited to their length
    (any-hit; the boxes occlude some)."""
    ts_j, _, ts_t, _ = cornell
    org, d = (np.array(x) for x in primary_rays(*CORNELL[1:3]))
    hj = trace_j.scene_trace_closest(ts_j, jnp.asarray(org), jnp.asarray(d))
    ht = trace_t.scene_trace_closest(ts_t, torch.as_tensor(org),
                                     torch.as_tensor(d))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    assert ht.hit_mask.all()
    for f in ("t", "u", "v"):
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f).numpy()
        assert np.all(np.abs(a - b) <= 1e-5 * np.maximum(1.0, np.abs(a))), f
    rng = np.random.default_rng(7)
    sorg = rng.uniform(-0.95, 0.95, (2048, 3)).astype(np.float32)
    light = np.stack([rng.uniform(-0.2, 0.2, 2048),
                      np.full(2048, 0.99), rng.uniform(-0.2, 0.2, 2048)],
                     -1).astype(np.float32)
    to_light = light - sorg
    dist = np.linalg.norm(to_light, axis=-1)
    sdir = (to_light / dist[:, None]).astype(np.float32)
    tmax = (dist - 1e-3).astype(np.float32)
    oj = trace_j.scene_trace_shadow(ts_j, jnp.asarray(sorg),
                                    jnp.asarray(sdir), t_max=jnp.asarray(tmax))
    ot = trace_t.scene_trace_shadow(ts_t, torch.as_tensor(sorg),
                                    torch.as_tensor(sdir),
                                    t_max=torch.as_tensor(tmax))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert ot.any() and not ot.all()


def test_path_trace_per_path_on_the_bvh_route(cornell):
    """5 bounces, one path a pixel, 1e-4 per path."""
    ts_j, _, ts_t, _ = cornell
    org, d = (np.array(x) for x in primary_rays(*CORNELL[1:3]))
    rj, rt = trace_both(ts_j, ts_t, org, d, seeds(W * H, 3), num_bounces=5)
    assert_paths_agree(rj, rt, "cornell+bvh/5")


def test_dead_lanes_skip_changes_nothing_on_the_bvh_route(cornell,
                                                         monkeypatch):
    """Ended paths ride along with t_max = 0 (as the card's wavefronts
    do); tracing every lane instead gives the same bits."""
    _, _, ts_t, _ = cornell
    org, d = (torch.tensor(x) for x in primary_rays(*CORNELL[1:3]))
    seed = torch.as_tensor(seeds(W * H, 11).astype(np.int64))
    skip = ref_t.path_trace(ts_t, org, d, seed, num_bounces=16)
    monkeypatch.setattr(ref_t, "_live_tmax", lambda live, t_max: t_max)
    every = ref_t.path_trace(ts_t, org, d, seed, num_bounces=16)
    assert torch.equal(skip, every)


def test_render_frame_reference_on_the_bvh_route(cornell):
    """Four progressive frames, 16 bounces, refit every frame: the sample
    count exactly, the accumulator at 1e-4 per path, the exposure within
    1e-5 and `final` within 1e-3 on >= 99% of the pixels."""
    ts_j, lv_j, ts_t, lv_t = cornell
    cfg_j, cfg_t = CfgJ(width=W, height=H), CfgT(width=W, height=H)
    vj = cam_j.make_view_constants(*CORNELL[1:3], fov_y_deg=55.0, width=W,
                                   height=H)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    sj, st = init_ref_j(cfg_j), init_ref_t(cfg_t, device="cpu")
    step_j = jax.jit(lambda s: render_ref_j(ts_j, s, vj, cfg_j, levels=lv_j))
    for _ in range(4):
        sj, oj = step_j(sj)
        st, ot = render_ref_t(ts_t, st, vt, cfg_t, levels=lv_t)
    assert float(st["refpt_samples"]) == float(sj["refpt_samples"]) == 4.0
    assert_paths_agree(np.asarray(sj["refpt_accum"]).reshape(-1, 3),
                       _n(st["refpt_accum"]).reshape(-1, 3), "accum")
    np.testing.assert_allclose(_n(st["smoothed_ev"]),
                               np.asarray(sj["smoothed_ev"]), atol=1e-5)
    fd = np.abs(_n(ot["final"]) - np.asarray(oj["final"]))
    assert (fd <= 1e-3).mean() >= 0.99, (fd <= 1e-3).mean()


def test_renderer_refits_after_a_move():
    """`Renderer` on the BVH route keeps the refit schedule: after
    `set_transforms` the next draw refits the BVH, whose root then holds
    the moved geometry, and the frame sees the box where it moved."""
    cfg = CfgT(width=32, height=24, use_rtdgi=False, use_rtr=False,
               use_ssao=False, use_taa=False, use_ircache=False,
               use_motion_blur=False)
    r = Renderer(proc_t.cornell_box(), cfg, device="cpu")
    r.ts, r.levels = build_ts_t(r.gpu, device="cpu", **BVH)
    assert r.ts.woop is None and r.levels["use_brute"] is False
    vt = cam_t.make_view_constants((0.0, 0.0, 2.4), (0.0, 0.0, -1.0),
                                   width=32, height=24, device="cpu")
    hit0 = r.draw(vt)["gbuffer"]["hit"]
    xf = r.ts.gpu.xforms.clone()
    xf[:, 0, 3] += 50.0
    r.set_transforms(xf)
    hit1 = r.draw(vt)["gbuffer"]["hit"]
    assert bool(hit0.all()) and not bool(hit1.any())
    assert float(r.ts.bvh.node_min[0, 0]) >= 48.0
