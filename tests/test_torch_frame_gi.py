"""Port parity, the diffuse-GI slice as a whole on cornell (brute kernel
path, emissive-triangle NEE): four frames at 64x48 with a camera move through
`kajiya_tpu.frame.render_frame` and `kajiya_tpu_torch.frame.render_frame`
with SSAO, RTDGI and ReSTIR GI on, from the same trace scene, views and
initial state. Frames 0 and 3 take the reservoir-validation branch. Plus the
carry-over check (the port started from JAX's frame-3 input state renders
JAX's frame 3) and one frame of the non-ReSTIR branch.

The clustered scene runs in test_torch_frame_gi_city.py, so the two land on
different test workers."""
import numpy as np
import pytest

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.frame import RenderConfig as CfgT
from kajiya_tpu_torch.frame import check_supported
from kajiya_tpu_torch.frame import init_frame_state as init_t
from kajiya_tpu_torch.frame import render_frame as render_t
from test_torch_frame import H, W, _n, assert_close, assert_state

# Tolerance: that of the raster + shadow slice (test_torch_frame.py): per
# pixel <= 1e-3 absolute on >= 99% of pixels and mean absolute difference
# <= 1e-4, on the outputs and on every state plane, the reservoir planes
# included. The port keeps the JAX source's operation order, so reservoir
# decisions (u * w_sum < w, the geometry and occlusion gates) come out equal
# on these views and the planes differ by float32 rounding only. A single
# flipped decision would move a lane's whole payload and show as a failure
# here, not as noise under a loose bound.
#
# The camera step avoids one knife edge of the inputs: with a y step of 0.02
# the top pixel row reprojects to prev_v = 0 +- 1 ulp on frame 3, and
# `in_bounds` (prev_v >= 0) then differs between the two float32 pipelines on
# a handful of pixels of that row.
GI = dict(width=W, height=H, primary="raster", sun_soft_shadows=True,
          use_ssao=True, use_rtdgi=True, use_restir_gi=True,
          secondary_full_shading=True, use_rtr=False, use_ircache=False,
          use_taa=False, use_motion_blur=False)
N_FRAMES = 4
OUTPUTS = ("final", "lit", "diffuse_gi", "ssao", "shadow")
CORNELL = (lambda: proc_j.cornell_box(), (0.0, 0.0, 2.4), (0.0, 0.0, -1.0),
           (0.04, 0.013, 0.0))


def gi_views(eye, fwd, step, n=N_FRAMES):
    views, prev = [], None
    for k in range(n):
        e = tuple(np.asarray(eye) + k * np.asarray(step))
        prev = view_j(e, fwd, fov_y_deg=55.0, width=W, height=H, prev=prev)
        views.append(prev)
    return views


def run_gi(make, eye, fwd, step, cfg=GI, n=N_FRAMES):
    """`n` frames through both renderers from the same starting point. The
    JAX frame runs eagerly, as the function is written (see
    test_torch_frame.py)."""
    ts_j, _ = build_ts_j(build_gpu_j(make()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    cfg_j, cfg_t = CfgJ(**cfg), CfgT(**cfg)
    sj = init_j(cfg_j)
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(sj),
                                        device="cpu")
    out = []
    for v in gi_views(eye, fwd, step, n):
        sj_prev = sj
        sj, oj = render_j(ts_j, sj, v, cfg_j)
        vt = convert.view_from_numpy(convert.to_numpy_dict(v), device="cpu")
        st, ot = render_t(ts_t, st, vt, cfg_t)
        out.append(dict(sj_prev=sj_prev, sj=sj, oj=oj, st=st, ot=ot, vt=vt))
    return ts_t, cfg_t, out


def check_gi_frame(runs, frame):
    _, _, out = runs
    r = out[frame]
    assert int(r["sj_prev"]["frame_idx"]) == frame
    for k in OUTPUTS:
        assert_close(r["oj"][k], r["ot"][k], k)
    assert_state(r["sj"], r["st"])
    gi = _n(r["ot"]["diffuse_gi"])
    assert gi.shape == (H, W, 3) and gi.min() >= 0.0 and gi.mean() > 1e-3
    assert 0.0 <= float(r["ot"]["ssao"].min())
    assert float(r["ot"]["ssao"].max()) <= 1.0
    assert float(r["st"]["gi_res_M"].max()) >= 1.0


def check_gi_carry_over(runs, frame=3):
    """Start the port from the state JAX took into `frame` (a validation
    frame, with live reservoirs) and match JAX's frame."""
    ts_t, cfg_t, out = runs
    r = out[frame]
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(r["sj_prev"]),
                                        device="cpu")
    assert int(st["frame_idx"]) == frame
    assert float(st["gi_res_M"].max()) > 1.0
    st2, ot2 = render_t(ts_t, st, r["vt"], cfg_t)
    for k in OUTPUTS:
        assert_close(r["oj"][k], ot2[k], k)
    assert_state(r["sj"], st2)


@pytest.fixture(scope="module")
def runs():
    return run_gi(*CORNELL)


def test_gi_init_frame_state_matches():
    sj = init_j(CfgJ(**GI))
    st = init_t(CfgT(**GI), device="cpu")
    assert list(sj) == list(st)
    for k in sj:
        a = np.asarray(sj[k])
        assert tuple(st[k].shape) == a.shape, k
        assert str(st[k].dtype).split(".")[-1] == str(a.dtype), k
        np.testing.assert_array_equal(_n(st[k]), a)
    # and the planes go across from numpy with their dtypes
    back = convert.frame_state_from_numpy(convert.to_numpy_dict(sj),
                                          device="cpu")
    for k in sj:
        assert back[k].dtype == st[k].dtype, k


def test_gi_config_is_supported():
    check_supported(CfgT(**GI))
    check_supported(CfgT(**{**GI, "use_restir_gi": False}))
    check_supported(CfgT(**{**GI, "width": 1920, "height": 1080}))


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_gi_frames_match(runs, frame):
    check_gi_frame(runs, frame)


def test_gi_state_carry_over(runs):
    check_gi_carry_over(runs)


def test_gi_without_restir_matches(runs):
    """`use_restir_gi=False`: blurred candidates, edge-aware upsample and the
    temporal filter, two frames."""
    cfg = {**GI, "use_restir_gi": False}
    _, _, out = run_gi(*CORNELL, cfg=cfg, n=2)
    for r in out:
        for k in OUTPUTS:
            assert_close(r["oj"][k], r["ot"][k], k)
        assert_state(r["sj"], r["st"])
        assert not any(k.startswith("gi_res_") for k in r["st"])
