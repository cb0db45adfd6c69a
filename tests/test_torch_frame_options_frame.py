"""Port parity, one 64x48 frame of cornell with the frame's last four
options on together: the traced g-buffer (`primary="trace"`), the world
radiance cache (a 2x2x2 grid of 8^2 probes inside the box), depth of field
and an IBL sky from a panorama the test writes with the port's RGBE
writer, with diffuse GI on (so the secondary hit lighting runs with the
cache's lookup bound) and the other passes off, through
`kajiya_tpu.frame.render_frame` and `kajiya_tpu_torch.frame.render_frame`
from the same trace scene, view and state. Every output and state plane at
test_torch_frame.py's tolerance (measured: within 4e-6 everywhere)."""
import numpy as np
import pytest

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_frame_state as init_j
from kajiya_tpu.frame import render_frame as render_j
from kajiya_tpu.renderers.wrc import WrcConfig as WrcJ
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.sky.ibl import load_ibl_env as ibl_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.frame import RenderConfig as CfgT
from kajiya_tpu_torch.frame import render_frame as render_t
from kajiya_tpu_torch.renderers.wrc import WrcConfig as WrcT
from kajiya_tpu_torch.sky.ibl import load_ibl_env as ibl_t
from kajiya_tpu_torch.sky.ibl import write_hdr
from test_torch_frame import H, W, _n, assert_close, assert_state

OPTIONS = dict(width=W, height=H, primary="trace", use_wrc=True,
               use_dof=True, use_rtdgi=True, use_restir_gi=False,
               use_ircache=False, use_rtr=False, use_ssao=False,
               use_taa=False, use_motion_blur=False)
WRC = dict(grid=(2, 2, 2), probe_res=8, grid_spacing=1.0,
           grid_origin=(-0.5, -0.5, -0.5))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    rs = np.random.default_rng(0)
    pano = (rs.uniform(0.2, 1.5, (32, 64, 3))
            * np.linspace(1.5, 0.3, 32)[:, None, None]).astype(np.float32)
    path = str(tmp_path_factory.mktemp("ibl") / "sky.hdr")
    write_hdr(path, pano)
    ts_j, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    cfg_j = CfgJ(**OPTIONS, wrc=WrcJ(**WRC))
    cfg_t = CfgT(**OPTIONS, wrc=WrcT(**WRC))
    vj = view_j((0.0, 0.0, 2.4), (0.0, 0.0, -1.0), fov_y_deg=55.0, width=W,
                height=H)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    env_j, env_t = ibl_j(path), ibl_t(path, device="cpu")
    np.testing.assert_array_equal(_n(env_t), np.asarray(env_j))
    sj = init_j(cfg_j)
    st = convert.frame_state_from_numpy(convert.to_numpy_dict(sj),
                                        device="cpu")
    # eager, as the other frame tests run JAX's frame
    sj, oj = render_j(ts_j, sj, vj, cfg_j, ibl_env=env_j)
    st, ot = render_t(ts_t, st, vt, cfg_t, ibl_env=env_t)
    return sj, oj, st, ot


@pytest.mark.parametrize("key", ["final", "lit", "diffuse_gi", "shadow",
                                 "taa"])
def test_options_frame_outputs(frames, key):
    _, oj, _, ot = frames
    assert_close(oj[key], ot[key], key)


def test_options_frame_state(frames):
    sj, _, st, _ = frames
    assert "wrc_atlas" in st
    assert float(st["wrc_atlas"].max()) > 0.0
    assert_state(sj, st)


def test_options_frame_gbuffer_and_dof(frames):
    """The traced g-buffer planes, and depth of field having blurred the
    image that post tonemaps (`taa` is the image after motion blur and
    DoF; with TAA and motion blur off it differs from `lit` only by DoF)."""
    _, oj, _, ot = frames
    for k in ("depth", "normal", "albedo", "pos"):
        assert_close(oj["gbuffer"][k], ot["gbuffer"][k], k)
    assert float((ot["taa"] - ot["lit"]).abs().max()) > 1e-3
