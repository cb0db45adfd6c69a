"""Port parity, the whole slice: three raster + sun-shadow frames at 64x48
with a camera move, on cornell (the city runs in test_torch_frame_city.py,
so the two land on different test workers), rendered by
`kajiya_tpu.frame.render_frame` and `kajiya_tpu_torch.frame.render_frame`
from the same trace scene, views and initial state; plus the carry-over
check (the port started from JAX's frame-2 state renders JAX's frame 3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.core.camera import make_view_constants as view_t
from kajiya_tpu_torch.frame import RenderConfig as CfgT
from kajiya_tpu_torch.frame import Renderer, check_supported
from kajiya_tpu_torch.frame import init_frame_state as init_t
from kajiya_tpu_torch.frame import render_frame as render_t
from kajiya_tpu_torch.scene import procedural as proc_t

# Tolerance: per pixel <= 1e-3 absolute on >= 99% of pixels, mean absolute
# difference <= 1e-4. Hits that tie at triangle edges can resolve to the
# neighbour triangle, and the a-trous shadow filter spreads such a pixel over
# its neighbourhood; everything else is float32 rounding of the same math.
PIX_TOL, PIX_FRAC, MEAN_TOL = 1e-3, 0.99, 1e-4
W, H = 64, 48
SLICE = dict(width=W, height=H, primary="raster", sun_soft_shadows=True,
             use_rtdgi=False, use_rtr=False, use_ssao=False, use_taa=False,
             use_ircache=False, use_motion_blur=False)
SCENES = {
    "cornell": (lambda: proc_j.cornell_box(), (0.0, 0.0, 2.4),
                (0.0, 0.0, -1.0), (0.04, 0.02, 0.0)),
}


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def views_for(eye, fwd, step):
    views, prev = [], None
    for k in range(3):
        e = tuple(np.asarray(eye) + k * np.asarray(step))
        prev = view_j(e, fwd, fov_y_deg=55.0, width=W, height=H, prev=prev)
        views.append(prev)
    return views


def assert_close(a, b, name):
    a, b = np.asarray(a, np.float32), _n(b).astype(np.float32)
    assert a.shape == b.shape, name
    assert np.isfinite(b).all(), name
    d = np.abs(a - b)
    assert (d <= PIX_TOL).mean() >= PIX_FRAC, (name, (d <= PIX_TOL).mean())
    assert d.mean() <= MEAN_TOL, (name, d.mean())


def assert_state(sj, st):
    assert set(sj) == set(st)
    for k in sj:
        a = np.asarray(sj[k])
        assert tuple(st[k].shape) == a.shape, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(_n(st[k]), a, err_msg=k)
        else:
            assert_close(a.reshape(-1, 1) if a.ndim == 0 else a,
                          st[k].reshape(-1, 1) if a.ndim == 0 else st[k], k)


def run_slice(make, eye, fwd, step):
    """Three frames through both renderers from the same starting point."""
    ts_j, _ = build_ts_j(build_gpu_j(make()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    views = views_for(eye, fwd, step)
    cfg_j, cfg_t = CfgJ(**SLICE), CfgT(**SLICE)
    # eager, as the function is written: jit lets XLA fuse the bf16 glare
    # chain and the brute intersector's products, which moves a few edge
    # pixels of JAX's own output far beyond the tolerance below
    def frame_j(s, v):
        return render_j(ts_j, s, v, cfg_j)

    sj = init_j(cfg_j)
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(sj),
                                        device="cpu")
    out = []
    for v in views:
        sj_prev = sj
        sj, oj = frame_j(sj, v)
        vt = convert.view_from_numpy(convert.to_numpy_dict(v), device="cpu")
        st, ot = render_t(ts_t, st, vt, cfg_t)
        out.append(dict(sj_prev=sj_prev, sj=sj, oj=oj, st=st, ot=ot, vt=vt))
    return ts_t, cfg_t, out


@pytest.fixture(scope="module", params=sorted(SCENES))
def runs(request):
    return run_slice(*SCENES[request.param])


def check_frame(runs, frame):
    _, _, out = runs
    r = out[frame]
    for k in ("final", "lit", "shadow"):
        assert_close(r["oj"][k], r["ot"][k], k)
    assert_state(r["sj"], r["st"])
    assert 0.0 <= float(r["ot"]["final"].min())
    assert float(r["ot"]["final"].max()) <= 1.0


def check_carry_over(runs):
    """Start the port from JAX's frame-2 state and match JAX's frame 3."""
    ts_t, cfg_t, out = runs
    r = out[2]
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(r["sj_prev"]),
                                        device="cpu")
    st3, ot3 = render_t(ts_t, st, r["vt"], cfg_t)
    for k in ("final", "lit", "shadow"):
        assert_close(r["oj"][k], ot3[k], k)
    assert_state(r["sj"], st3)


def test_init_frame_state_keys_and_shapes():
    for kw in (SLICE, dict(width=W, height=H)):
        sj = init_j(CfgJ(**kw))
        st = init_t(CfgT(**kw), device="cpu")
        assert list(sj) == list(st)
        for k in sj:
            assert tuple(st[k].shape) == np.asarray(sj[k]).shape, k
            np.testing.assert_array_equal(_n(st[k]), np.asarray(sj[k]))


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_slice_frames_match(runs, frame):
    check_frame(runs, frame)


def test_state_carry_over(runs):
    check_carry_over(runs)


def test_renderer_draw_and_unported_flags():
    cfg = CfgT(**SLICE)
    r = Renderer(proc_t.cornell_box(), cfg, device="cpu")

    v = view_t((0.0, 0.0, 2.4), (0.0, 0.0, -1.0), width=W, height=H,
               jitter=r.jitter(enabled=False), device="cpu")
    out = r.draw(v)
    assert out["final"].shape == (H, W, 3)
    assert torch.isfinite(out["final"]).all()
    assert int(r.state["frame_idx"]) == 1
    # every option is ported now: nothing is refused, and the last four
    # render (their parity: test_torch_frame_options*.py)
    for flag in ("use_ssao", "use_rtdgi", "use_taa", "use_ircache", "use_rtr",
                 "use_motion_blur", "use_wrc", "use_dof"):
        check_supported(CfgT(**{**SLICE, flag: True}))
    check_supported(CfgT(**{**SLICE, "primary": "trace"}))
    check_supported(CfgT(**SLICE), ibl_env=object())
    cfg2 = CfgT(**{**SLICE, "use_wrc": True, "use_dof": True,
                   "primary": "trace"})
    st2, out2 = render_t(r.ts, init_t(cfg2, device="cpu"), v, cfg2,
                         ibl_env=torch.full((16, 16, 3), 0.5))
    assert torch.isfinite(out2["final"]).all()
    assert "wrc_atlas" in st2


def test_renderer_set_transforms_matches_jax_refresh():
    """A moved instance: the port's trace scene after set_transforms + draw
    equals JAX's refresh_trace_scene under the same transforms (1e-6)."""
    from kajiya_tpu.world import refresh_trace_scene as refresh_j

    r = Renderer(proc_t.cornell_box(), CfgT(**SLICE), device="cpu")
    ts_j, levels_j = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    c, s = np.cos(0.2), np.sin(0.2)
    xf = np.array([[[c, 0.0, s, 0.1], [0.0, 1.0, 0.0, -0.05],
                    [-s, 0.0, c, 0.2]]], np.float32)
    r.set_transforms(xf)
    v = view_t((0.0, 0.0, 2.4), (0.0, 0.0, -1.0), width=W, height=H,
               device="cpu")
    out = r.draw(v)
    assert torch.isfinite(out["final"]).all()
    ts_j.gpu.xforms_prev = ts_j.gpu.xforms
    ts_j.gpu.xforms = jnp.asarray(xf)
    ref = refresh_j(ts_j.gpu, ts_j.bvh, levels_j)
    for f in ("v0", "e1", "e2", "inst_rot", "tri_attrs"):
        np.testing.assert_allclose(_n(getattr(r.ts, f)),
                                   np.asarray(getattr(ref, f)), atol=1e-6,
                                   err_msg=f)
    for k in ("a_o", "a_d"):
        a = np.asarray(ref.woop[k])
        np.testing.assert_allclose(_n(r.ts.woop[k]), a, rtol=1e-6,
                                   atol=1e-6 * np.abs(a).max(), err_msg=k)


def test_renderer_last_good_frame(monkeypatch):
    """A failing first frame raises (a kernel launch error included); after
    a good frame a failure leaves the state alone and returns the last good
    outputs."""
    import kajiya_tpu_torch.frame as frame_t

    r = Renderer(proc_t.cornell_box(), CfgT(**SLICE), device="cpu")
    v = view_t((0.0, 0.0, 2.4), (0.0, 0.0, -1.0), width=W, height=H,
               device="cpu")

    def boom(*_a, **_k):
        raise RuntimeError("woop_brute: CUDA launch failed with error 7")

    real = frame_t.render_frame
    monkeypatch.setattr(frame_t, "render_frame", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        r.draw(v)
    monkeypatch.setattr(frame_t, "render_frame", real)
    good = r.draw(v)
    state = r.state
    monkeypatch.setattr(frame_t, "render_frame", boom)
    assert r.draw(v) is good
    assert r.state is state
    assert int(r.state["frame_idx"]) == 1
