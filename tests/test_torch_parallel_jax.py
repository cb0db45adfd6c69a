"""The port's sharded frames against JAX's single-device frame: four gloo
ranks (parallel.launch.spawn, as in test_torch_parallel.py) render, at
64x128 on the cornell trace scene JAX built and from JAX's views, the
"raster" and "gi" configurations (two frames each), the default frame of
test_torch_parallel.py (the small cache, mesh-light specular as `Renderer`
turns it on for cornell; three jittered frames: a validation frame, then
TAA, RTR's temporal reuse and motion blur on history) and JAX's own
sharding configuration (tests/test_parallel.py: the defaults with
`max_trace_steps=256` and motion blur off, the full-size cache; one frame),
the options frame of test_torch_parallel.py (the default frame with the
traced g-buffer, the small world radiance cache and depth of field; two
jittered frames) and its temporal super-resolution (rendered at 64x72,
output at 96x108; three jittered frames);
the gathered outputs and state are held against
`kajiya_tpu.frame.render_frame`, run eagerly as the frame parity tests run
it. The sample-sharded path tracer is held against JAX's `path_trace`
(compiled, as tests/test_parallel.py runs it).

JAX's own contract (tests/test_parallel.py) is sharded == single device, and
test_torch_parallel.py holds the sharded port frame bit for bit to the
port's single-device frame; this file closes the loop to the reference.

Tolerance: the frame parity tests' (test_torch_frame.py: per pixel 1e-3 on
>= 99% of pixels, mean absolute difference 1e-4, on every output and state
plane, integer planes exact); for the configurations with TAA and RTR,
that of the single-device default frame (test_torch_frame_default.py: the
same, with the TAA output and history held to 1e-3 relative to
max(1, |value|), and `rtr_ray_len`, which carries 1e8 for sky reflections,
to 1e-3 + 1e-4 relative on >= 99%; the options and super-resolution
frames, which run TAA and RTR, are held to it too: the options' own planes,
the traced g-buffer, the radiance cache's atlas and the DoF image, to
test_torch_frame.py's bound, which test_torch_frame_options_frame.py holds
the single-device options frame to), and for the path tracer
test_parallel.py's
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
from kajiya_tpu.frame import jitter_for_frame as jitter_j
from kajiya_tpu.renderers.ircache import IrcacheConfig as IrcJ
from kajiya_tpu.renderers.wrc import WrcConfig as WrcJ
from kajiya_tpu.renderers.reference import path_trace as path_trace_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from test_torch_frame import assert_close, assert_state
from test_torch_frame_default import assert_default_state, assert_plane
from test_torch_parallel import (DEFAULT, EYE, FWD, GI, H, H_SUPERRES,
                                 N_FRAMES, OPTIONS, OUTPUTS, PT_BOUNCES,
                                 RASTER, SMALL_IRCACHE, STEP, SUPERRES, W, WRC,
                                 sharded_runs)

# tests/test_parallel.py's configuration (JAX's own sharding test)
JAX_SHARDING = dict(width=W, height=H, max_trace_steps=256,
                    use_motion_blur=False)
CASES = (("gi", GI, H), ("raster", RASTER, H), ("default", DEFAULT, H),
         ("jax_sharding", JAX_SHARDING, H), ("options", OPTIONS, H),
         ("superres", SUPERRES, H_SUPERRES))
# frames and jitter of each case
FRAMES = {"gi": (N_FRAMES, False), "raster": (N_FRAMES, False),
          "default": (3, True), "jax_sharding": (1, False),
          "options": (2, True), "superres": (3, True)}
WITH_TAA = ("default", "jax_sharding", "options", "superres")


def jax_views(h, n=N_FRAMES, jitter=False):
    views, prev = [], None
    for k in range(n):
        e = tuple(np.asarray(EYE) + k * np.asarray(STEP))
        prev = view_j(e, FWD, fov_y_deg=55.0, width=W, height=h,
                      jitter=jitter_j(k, jitter), prev=prev)
        views.append(prev)
    return views


def jax_cfg(cfg, h):
    kw = {**cfg, "height": h}
    if "ircache" in kw:
        kw["ircache"] = IrcJ(**SMALL_IRCACHE)
    if "wrc" in kw:
        kw["wrc"] = WrcJ(**WRC)
    return CfgJ(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_jax")
    ts_j, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    scene_path = str(tmp / "scene.pt")
    torch.save(convert.to_numpy_dict(ts_j), scene_path)
    views = {name: jax_views(h, *FRAMES[name]) for name, _cfg, h in CASES}
    ranks = sharded_runs(
        str(tmp), scene_path=scene_path, cases=CASES, log=None,
        multihost=None, pt="gi",
        views={k: [convert.to_numpy_dict(v) for v in vs]
               for k, vs in views.items()})
    ref = {}
    for name, cfg, h in CASES:
        cfg_j = jax_cfg(cfg, h)
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


@pytest.mark.parametrize("case,frame", [(c[0], k) for c in CASES
                                        for k in range(FRAMES[c[0]][0])])
def test_sharded_frame_matches_jax_single_device(runs, case, frame):
    ranks, ref = runs
    sj, oj = ref[case][frame]
    got = ranks[case][frame]
    for k in OUTPUTS:
        a, b = oj[k], got["out"][k]
        if np.ndim(a) == 0:
            a, b = np.reshape(a, (1, 1)), b.reshape(1, 1)
        if case in WITH_TAA:
            assert_plane(a, b, k, {})
        else:
            assert_close(a, b, k)
    if case in WITH_TAA:
        assert_default_state(sj, got["state"])
        assert int(got["state"]["ircache_valid"].sum()) > 0
    else:
        assert_state(sj, got["state"])
    if case == "options":
        for k in ("depth", "normal", "albedo", "pos"):
            assert_close(oj["gbuffer"][k], got["out"]["gbuffer"][k], k)
        assert float(got["state"]["wrc_atlas"].max()) > 0.0
    if case == "superres":
        assert tuple(got["out"]["final"].shape) == (108, 96, 3)


def test_shard_rays_pt_matches_jax_path_trace(runs):
    ranks, ref = runs
    got = ranks["pt"].numpy()
    err = np.abs(got - ref["pt"]) / np.maximum(1.0, np.abs(ref["pt"]))
    assert err.max() <= 1e-4, err.max()
    assert got.shape == (W * H, 3) and got.sum() > 0.0
