"""Port parity, the temporal output chain: `renderers/taa.py`,
`renderers/motion_blur.py` and the frame's pre-exposure split of
`kajiya_tpu_torch` against `kajiya_tpu` at 64x48 on cornell gbuffers with a
moving, jittered camera. Each package threads its own TAA state; inputs
(gbuffers, reprojection maps, seeded lit images) are JAX-made."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import jitter_for_frame as jitter_j
from kajiya_tpu.renderers import gbuffer as gbuffer_j
from kajiya_tpu.renderers import motion_blur as mb_j
from kajiya_tpu.renderers import post as post_j
from kajiya_tpu.renderers import reprojection as reproj_j
from kajiya_tpu.renderers import taa as taa_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch.frame import jitter_for_frame as jitter_t
from kajiya_tpu_torch.frame import pre_exposure
from kajiya_tpu_torch.renderers import motion_blur as mb_t
from kajiya_tpu_torch.renderers import post as post_t
from kajiya_tpu_torch.renderers import taa as taa_t

W, H = 64, 48
N_FRAMES = 4
# Tolerance: 1e-4 absolute on >= 99.5% of the elements, 1e-2 on all. Frame
# 0 agrees within 2e-6 everywhere. Where the neighbourhood is flat the
# variances ex2 - ex^2 (input filter, unjitter) cancel to a few ulps, and
# their square roots, which set the clamp box, turn one ulp of difference
# between the two libraries' sums into ~3e-4; the clamps and the threaded
# history carry that to a few pixels (< 0.2%) beyond 1e-4 from frame 1 on.
TOL, FRAC, MAX_TOL = 1e-4, 0.995, 1e-2
# the exposures (EV) the pre-exposure split chases, frame by frame
EVS = (0.0, 1.5, -0.7, 2.2)


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.as_tensor(np.array(np.asarray(x)))


def assert_close(got, ref, name, tol=TOL, frac=FRAC, max_tol=MAX_TOL):
    got, ref = _n(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all(), name
    d = np.abs(got - ref)
    assert (d <= tol).mean() >= frac and d.max() <= max_tol, (
        name, (d <= tol).mean(), d.max())


@pytest.fixture(scope="module")
def frames():
    """Per frame: JAX gbuffer, reprojection map, jitter and a seeded lit
    image (albedo x noise over a sky gradient)."""
    ts, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    rs = np.random.default_rng(4)
    out, v, prev_depth = [], None, jnp.zeros((H, W), jnp.float32)
    for k in range(N_FRAMES):
        jit = np.asarray(jitter_j(k))
        np.testing.assert_array_equal(_n(jitter_t(k)), jit)
        e = (0.03 * k, 0.011 * k, 2.4)
        v = view_j(e, (0.0, 0.0, -1.0), fov_y_deg=55.0, width=W, height=H,
                   jitter=jit, prev=v)
        gb = gbuffer_j.raster_gbuffer(ts, v, W, H)
        reproj = reproj_j.calculate_reprojection_map(gb, prev_depth, v)
        prev_depth = gb["depth"]
        noise = rs.uniform(0.5, 1.5, (H, W, 1)).astype(np.float32)
        sky = np.linspace(0.2, 2.0, H, dtype=np.float32)[:, None, None]
        lit = np.where(np.asarray(gb["hit"])[..., None],
                       np.asarray(gb["albedo"]) * noise * 3.0,
                       sky * np.ones((1, W, 3), np.float32))
        out.append(dict(gb=gb, reproj=reproj, jitter=jit, lit=lit))
    return out


@pytest.fixture(scope="module", params=[1.0, 1.5, 2.0])
def taa_runs(request, frames):
    """TAA over the 4 frames in both packages at temporal_upsampling 1.0,
    1.5 (96x72 out of 64x48: the factor of a 1280x720 render shown at
    1920x1080, where output rows fall between render rows) and 2.0 (output
    2x the render res); the last two take the super-res unjitter."""
    scale = request.param
    oh, ow = int(round(H * scale)), int(round(W * scale))
    sj = taa_j.init_state(oh, ow)
    st = taa_t.init_state(oh, ow)
    out = []
    for f in frames:
        aj, sj = taa_j.taa(jnp.asarray(f["lit"]), sj, f["reproj"],
                           f["gb"]["depth"], jnp.asarray(f["jitter"]), oh, ow)
        at, st = taa_t.taa(torch.as_tensor(f["lit"]), st, _t(f["reproj"]),
                           _t(f["gb"]["depth"]), torch.as_tensor(f["jitter"]),
                           oh, ow)
        out.append((aj, sj, at, st))
    return scale, out


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_taa_frames(taa_runs, frame):
    """Output and every TAA state plane at the module's tolerance."""
    scale, out = taa_runs
    aj, sj, at, st = out[frame]
    assert tuple(at.shape) == (int(H * scale), int(W * scale), 3)
    assert_close(at, aj, "taa")
    assert set(sj) == set(st)
    for k in sj:
        assert_close(st[k], sj[k], k)
    assert float(np.asarray(sj["taa_coverage"]).max()) > 1.0 or frame == 0


@pytest.mark.parametrize("upsampled", [False, True])
def test_motion_blur(frames, upsampled):
    """Motion blur of the last frame's lit image by its velocity, within
    1e-4 everywhere; `upsampled` runs it at 2x with the velocity and depth
    upsampled as the frame does under temporal upsampling."""
    f = frames[-1]
    color = np.asarray(f["lit"])
    vel = np.asarray(f["gb"]["velocity"]) * 40.0    # a few pixels of motion
    depth = np.asarray(f["gb"]["depth"])
    if upsampled:
        from kajiya_tpu.core import img as im_j
        from kajiya_tpu_torch.core import img as im_t

        vel_j = im_j.upsample_bilinear(jnp.asarray(vel), 2 * H, 2 * W)
        vel_t = im_t.upsample_bilinear(torch.as_tensor(vel), 2 * H, 2 * W)
        assert_close(vel_t, vel_j, "velocity", tol=1e-6, frac=1.0)
        depth_j = im_j.upsample_bilinear(jnp.asarray(depth), 2 * H, 2 * W)
        depth_t = im_t.upsample_bilinear(torch.as_tensor(depth), 2 * H, 2 * W)
        color = np.repeat(np.repeat(color, 2, 0), 2, 1)
    else:
        vel_j, vel_t = jnp.asarray(vel), torch.as_tensor(vel)
        depth_j, depth_t = jnp.asarray(depth), torch.as_tensor(depth)
    a = mb_j.motion_blur(jnp.asarray(color), vel_j, depth_j,
                         frame_fraction=0.5)
    b = mb_t.motion_blur(torch.as_tensor(color), vel_t, depth_t,
                         frame_fraction=0.5)
    assert_close(b, a, "motion_blur", frac=1.0)
    assert np.abs(np.asarray(a) - color).max() > 1e-2     # it did blur


def test_pre_exposure_sequence(frames):
    """The pre-exposure split over 4 frames of changing exposure: pre_mult
    and pre_delta (the JAX frame's lines, `kajiya_tpu/frame.py:481-487`),
    TAA on the pre-exposed image with its history rescaled, and the post
    output at exposure / pre_mult, at the module's tolerance."""
    pj = jnp.asarray(1.0, jnp.float32)
    pt = torch.tensor(1.0)
    sj, st = taa_j.init_state(H, W), taa_t.init_state(H, W)
    for f, ev in zip(frames, EVS):
        ev_j = jnp.asarray(ev, jnp.float32)
        pre_prev = pj
        pj = pre_prev * 0.9 + jnp.exp2(ev_j) * 0.1
        dj = pj / jnp.maximum(pre_prev, 1e-20)
        pt, dt = pre_exposure(pt, torch.tensor(ev, dtype=torch.float32),
                              True)
        np.testing.assert_allclose(float(pt), float(pj), rtol=1e-6)
        np.testing.assert_allclose(float(dt), float(dj), rtol=1e-6)
        lit_j, lit_t = jnp.asarray(f["lit"]), torch.as_tensor(f["lit"])
        aj, sj = taa_j.taa(lit_j * pj, sj, f["reproj"], f["gb"]["depth"],
                           jnp.asarray(f["jitter"]), H, W, pre_delta=dj)
        at, st = taa_t.taa(lit_t * pt, st, _t(f["reproj"]),
                           _t(f["gb"]["depth"]), torch.as_tensor(f["jitter"]),
                           H, W, pre_delta=dt)
        assert_close(at, aj, "taa")
        exposure = 2.0 ** (-ev)
        assert_close(post_t.post_combine(at, exposure / pt),
                     post_j.post_combine(aj, exposure / pj), "final")
    # without TAA nothing runs pre-exposed
    p1, d1 = pre_exposure(torch.tensor(3.0), torch.tensor(1.0), False)
    assert float(p1) == 1.0 and abs(float(d1) - 1.0 / 3.0) < 1e-7
