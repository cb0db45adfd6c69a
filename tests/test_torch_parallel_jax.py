"""The port's sharded frames against JAX's single-device frame: four gloo
ranks (parallel.launch.spawn, as in test_torch_parallel.py) render the
"raster" and "gi" configurations at 64x128 on the cornell trace scene JAX
built, two frames each, from JAX's views; the gathered outputs and state
are held against `kajiya_tpu.frame.render_frame`, run eagerly as the frame
parity tests run it. The sample-sharded path tracer is held against JAX's
`path_trace` (compiled, as tests/test_parallel.py runs it).

JAX's own contract (tests/test_parallel.py) is sharded == single device, and
test_torch_parallel.py holds the sharded port frame bit for bit to the
port's single-device frame; this file closes the loop to the reference.

Tolerance: the frame parity tests' (test_torch_frame.py: per pixel 1e-3 on
>= 99% of pixels, mean absolute difference 1e-4, on every output and state
plane, integer planes exact), and for the path tracer test_parallel.py's
1e-4 on every path, relative to max(1, |value|) as
test_torch_reference_pt.py states it (the emitter seen directly is 20, and
its float32 ulp is 2e-6: a few bright paths differ by 4.5e-4 absolute)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core.camera import camera_rays as rays_j
from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.renderers.reference import path_trace as path_trace_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from test_torch_frame import assert_close, assert_state
from test_torch_parallel import (EYE, FWD, GI, H, N_FRAMES, OUTPUTS,
                                 PT_BOUNCES, RASTER, STEP, W, sharded_runs)

CASES = (("gi", GI, H), ("raster", RASTER, H))


def jax_views(h, n=N_FRAMES):
    views, prev = [], None
    for k in range(n):
        e = tuple(np.asarray(EYE) + k * np.asarray(STEP))
        prev = view_j(e, FWD, fov_y_deg=55.0, width=W, height=h, prev=prev)
        views.append(prev)
    return views


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_jax")
    ts_j, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    scene_path = str(tmp / "scene.pt")
    torch.save(convert.to_numpy_dict(ts_j), scene_path)
    views = {name: jax_views(h) for name, _cfg, h in CASES}
    ranks = sharded_runs(
        str(tmp), scene_path=scene_path, cases=CASES, log=None,
        multihost=None, pt="gi",
        views={k: [convert.to_numpy_dict(v) for v in vs]
               for k, vs in views.items()})
    ref = {}
    for name, cfg, h in CASES:
        cfg_j = CfgJ(**{**cfg, "height": h})
        sj = init_j(cfg_j)
        frames = []
        for v in views[name]:
            sj, oj = render_j(ts_j, sj, v, cfg_j)
            frames.append((sj, oj))
        ref[name] = frames
    org, d = rays_j(views["gi"][0], W, H)
    seed = jnp.arange(W * H, dtype=jnp.uint32)
    ref["pt"] = np.asarray(jax.jit(lambda: path_trace_j(
        ts_j, org.reshape(-1, 3), d.reshape(-1, 3), seed,
        num_bounces=PT_BOUNCES))())
    return ranks, ref


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_sharded_frame_matches_jax_single_device(runs, case, frame):
    ranks, ref = runs
    sj, oj = ref[case][frame]
    got = ranks[case][frame]
    for k in OUTPUTS:
        a, b = oj[k], got["out"][k]
        if np.ndim(a) == 0:
            a, b = np.reshape(a, (1, 1)), b.reshape(1, 1)
        assert_close(a, b, k)
    assert_state(sj, got["state"])


def test_shard_rays_pt_matches_jax_path_trace(runs):
    ranks, ref = runs
    got = ranks["pt"].numpy()
    err = np.abs(got - ref["pt"]) / np.maximum(1.0, np.abs(ref["pt"]))
    assert err.max() <= 1e-4, err.max()
    assert got.shape == (W * H, 3) and got.sum() > 0.0
