"""Port parity, the default frame as a whole on cornell (brute kernel path,
emissive-triangle NEE and mesh-light specular): four frames at 64x48 of
`RenderConfig(width=64, height=48)` with every default flag on (irradiance
cache, SSAO, ReSTIR GI, RTR, TAA with the pre-exposure split, motion blur)
through `kajiya_tpu.frame.render_frame` and `kajiya_tpu_torch.frame.
render_frame`, from the same trace scene, jittered views and initial state.
The cache is the small `IrcacheConfig(max_entries=4096, active_budget=1024)`,
given to both packages alike (the default traces 16,384 x 4 rays a frame).
Frames 0 and 3 take the validation branches (reservoirs and cache). Plus the
carry-over check: the port started from JAX's frame-3 input state renders
JAX's frame 3.

The clustered scene runs in test_torch_frame_default_city.py, so the two
land on different test workers."""
import numpy as np
import pytest

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import jitter_for_frame as jitter_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.renderers.ircache import IrcacheConfig as IrcJ
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.frame import RenderConfig as CfgT
from kajiya_tpu_torch.frame import check_supported
from kajiya_tpu_torch.frame import init_frame_state as init_t
from kajiya_tpu_torch.frame import render_frame as render_t
from kajiya_tpu_torch.renderers.ircache import IrcacheConfig as IrcT
from test_torch_frame import H, W, _n, assert_close

# Tolerance: that of the earlier slices (test_torch_frame.py): per pixel
# <= 1e-3 absolute on >= 99% of pixels and mean absolute difference <= 1e-4,
# on every output and every state plane. Exceptions, each for a plane whose
# magnitude makes an absolute bound meaningless: `rtr_ray_len` carries 1e8
# for sky reflections (a float32 ulp is 8 there) and is held to 1e-3 + 1e-4
# relative on >= 99%; the TAA output and history are HDR radiance (the
# emitter and its reflections reach 20-50) and are held to 1e-3 relative to
# max(1, |value|): TAA's clamp box is the square root of a variance that
# cancels in flat neighbourhoods, which turns an ulp into ~3e-4 of the local
# value (test_torch_taa.py); the tonemapped `final` keeps the absolute
# bound. The integer planes (`frame_idx`, `ircache_seen`) must be equal.
# The camera step is the GI tests' (knife-edge note in
# test_torch_frame_gi.py).
SMALL_IRCACHE = dict(max_entries=4096, active_budget=1024)
N_FRAMES = 4
OUTPUTS = ("final", "lit", "diffuse_gi", "ssao", "shadow", "reflections",
           "taa")
CORNELL = (lambda: proc_j.cornell_box(), (0.0, 0.0, 2.4), (0.0, 0.0, -1.0),
           (0.04, 0.013, 0.0), True)


def configs(lights: bool):
    """The default config at 64x48 with the small cache, in both packages.
    `lights`: the scene has emissive triangles, so the Renderer turns on
    mesh-light specular (render_frame is called directly here)."""
    kw = dict(width=W, height=H, use_mesh_light_specular=lights)
    return (CfgJ(ircache=IrcJ(**SMALL_IRCACHE), **kw),
            CfgT(ircache=IrcT(**SMALL_IRCACHE), **kw))


def views(eye, fwd, step, n=N_FRAMES):
    out, prev = [], None
    for k in range(n):
        e = tuple(np.asarray(eye) + k * np.asarray(step))
        prev = view_j(e, fwd, fov_y_deg=55.0, width=W, height=H,
                      jitter=jitter_j(k), prev=prev)
        out.append(prev)
    return out


def run_default(make, eye, fwd, step, lights, n=N_FRAMES):
    """`n` frames through both renderers from the same starting point; the
    JAX frame runs eagerly, as the function is written (ROADMAP section 3)."""
    ts_j, _ = build_ts_j(build_gpu_j(make()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    cfg_j, cfg_t = configs(lights)
    sj = init_j(cfg_j)
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(sj),
                                        device="cpu")
    out = []
    for v in views(eye, fwd, step, n):
        sj_prev = sj
        sj, oj = render_j(ts_j, sj, v, cfg_j)
        vt = convert.view_from_numpy(convert.to_numpy_dict(v), device="cpu")
        st, ot = render_t(ts_t, st, vt, cfg_t)
        out.append(dict(sj_prev=sj_prev, sj=sj, oj=oj, st=st, ot=ot, vt=vt))
    return ts_t, cfg_t, out


def assert_hdr(a, b, name):
    """<= 1e-3 * max(1, |a|) on >= 99% of the elements, and that scaled
    difference <= 1e-4 on average."""
    a, b = np.asarray(a, np.float32), _n(b).astype(np.float32)
    assert a.shape == b.shape and np.isfinite(b).all(), name
    d = np.abs(a - b) / np.maximum(1.0, np.abs(a))
    assert (d <= 1e-3).mean() >= 0.99, (name, (d <= 1e-3).mean())
    assert d.mean() <= 1e-4, (name, d.mean())


HDR = ("taa", "taa_history")


def assert_knife(a, b, name, frac):
    """The bound of a plane downstream of a stated knife edge: within
    1e-3 * max(1, |a|) on >= `frac` of the elements, that scaled difference
    <= 2e-3 on average (ray lengths: 1e-3 + 1e-4 relative, no mean)."""
    a, b = np.asarray(a, np.float32), _n(b).astype(np.float32)
    assert a.shape == b.shape and np.isfinite(b).all(), name
    if name == "rtr_ray_len":
        ok = np.abs(a - b) <= 1e-3 + 1e-4 * np.abs(a)
        assert ok.mean() >= frac, (name, ok.mean())
        return
    d = np.abs(a - b) / np.maximum(1.0, np.abs(a))
    assert (d <= 1e-3).mean() >= frac, (name, (d <= 1e-3).mean())
    assert d.mean() <= 2e-3, (name, d.mean())


def assert_plane(a, b, name, loose):
    if name in loose or name == "rtr_ray_len":
        assert_knife(a, b, name, loose.get(name, 0.99))
    elif name in HDR:
        assert_hdr(a, b, name)
    else:
        a = np.asarray(a)
        assert_close(a.reshape(-1, 1) if a.ndim == 0 else a,
                     b.reshape(-1, 1) if b.ndim == 0 else b, name)


def assert_default_state(sj, st, loose=None):
    """Every state plane: integers exactly, the rest by `assert_plane`.
    `loose`: plane -> fraction, for the planes of a stated knife edge."""
    assert set(sj) == set(st)
    for k in sj:
        a = np.asarray(sj[k])
        b = _n(st[k])
        assert b.shape == a.shape and b.dtype == a.dtype, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            assert_plane(a, b, k, loose or {})


def check_frame(runs, frame, loose=None):
    _, _, out = runs
    r = out[frame]
    assert int(r["sj_prev"]["frame_idx"]) == frame
    for k in OUTPUTS:
        assert_plane(r["oj"][k], r["ot"][k], k, loose or {})
    assert_default_state(r["sj"], r["st"], loose)
    final = _n(r["ot"]["final"])
    assert final.shape == (H, W, 3) and final.mean() > 0.01
    refl = _n(r["ot"]["reflections"])
    assert np.isfinite(refl).all() and refl.min() >= 0.0
    assert int(_n(r["st"]["ircache_valid"]).sum()) > 0
    if frame == N_FRAMES - 1:
        live = _n(r["st"]["ircache_valid"])
        assert np.abs(_n(r["st"]["ircache_sh"])[live]).sum() > 0.0


def check_carry_over(runs, frame=3, loose=None):
    """Start the port from the state JAX took into `frame` (a validation
    frame, with a live cache and live reservoirs) and match JAX's frame."""
    ts_t, cfg_t, out = runs
    r = out[frame]
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(r["sj_prev"]),
                                        device="cpu")
    assert int(st["frame_idx"]) == frame
    st2, ot2 = render_t(ts_t, st, r["vt"], cfg_t)
    for k in OUTPUTS:
        assert_plane(r["oj"][k], ot2[k], k, loose or {})
    assert_default_state(r["sj"], st2, loose)


@pytest.fixture(scope="module")
def runs():
    return run_default(*CORNELL)


def test_default_init_frame_state_matches():
    cfg_j, cfg_t = configs(True)
    sj = init_j(cfg_j)
    st = init_t(cfg_t, device="cpu")
    assert list(sj) == list(st)
    for k in sj:
        a = np.asarray(sj[k])
        assert tuple(st[k].shape) == a.shape, k
        assert str(st[k].dtype).split(".")[-1] == str(a.dtype), k
        np.testing.assert_array_equal(_n(st[k]), a)


def test_default_config_is_supported():
    check_supported(CfgT())
    check_supported(CfgT(temporal_upsampling=2.0))
    for flag in ("use_wrc", "use_dof"):
        check_supported(CfgT(**{flag: True}))
    check_supported(CfgT(primary="trace"), ibl_env=object())


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_default_frames_match(runs, frame):
    check_frame(runs, frame)


def test_default_state_carry_over(runs):
    check_carry_over(runs)
