"""Port parity, the default frame on cornell on the BVH route (forced with
brute_max_tris=0) at 64x48 through `kajiya_tpu.frame.render_frame` and
`kajiya_tpu_torch.frame.render_frame`, both given `levels`, so each refits
its BVH every frame; the trace scene is JAX's, carried over by `convert`
(test_torch_frame_bvh.py holds the port's own build to it). Four frames (0
and 3 take the validation branches) and the carry-over check into frame 3,
at test_torch_frame_default.py's tolerance. The city runs in
test_torch_frame_bvh_city.py.

The JAX frame runs eagerly, as the function is written (ROADMAP section 3):
compiled, it differs from its own eager run by more than those bounds
(`rtr_ray_len` on cornell, `diffuse_gi` on the city). Its first eager frame
compiles each operation, in each of the two files' worker processes."""
import pytest

from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.frame import render_frame as render_t
from test_torch_frame_default import (CORNELL, N_FRAMES, check_carry_over,
                                      check_frame, configs, views)


def run_default_bvh(make, eye, fwd, step, lights, n=N_FRAMES):
    """`n` default frames of both packages on the BVH route from the same
    trace scene, views and initial state, each package refitting its own
    BVH through `levels` every frame."""
    ts_j, lv_j = build_ts_j(build_gpu_j(make()), brute_max_tris=0)
    assert ts_j.woop is None
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    lv_t = convert.levels_from_numpy(convert.to_numpy_dict(lv_j),
                                     device="cpu")
    assert ts_t.woop is None and ts_t.bvh is not None
    cfg_j, cfg_t = configs(lights)
    sj = init_j(cfg_j)
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(sj),
                                        device="cpu")
    out = []
    for v in views(eye, fwd, step, n):
        sj_prev = sj
        sj, oj = render_j(ts_j, sj, v, cfg_j, levels=lv_j)
        vt = convert.view_from_numpy(convert.to_numpy_dict(v), device="cpu")
        st, ot = render_t(ts_t, st, vt, cfg_t, levels=lv_t)
        out.append(dict(sj_prev=sj_prev, sj=sj, oj=oj, st=st, ot=ot, vt=vt))
    return ts_t, cfg_t, out


@pytest.fixture(scope="module")
def runs():
    return run_default_bvh(*CORNELL)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_bvh_default_frame(runs, frame):
    check_frame(runs, frame)


def test_bvh_default_carry_over(runs):
    check_carry_over(runs)
