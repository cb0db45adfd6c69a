"""Golden-oracle checks of the port on the textured cornell (the textured
half of `tests/test_oracle.py`, with the same bounds): the hybrid frame
against the port's own reference path tracer at 64x48, 48 progressive PT
frames of 5 bounces without the pixel filter against 16 hybrid frames with
TAA and motion blur off, with full and with flat secondary shading; and one
hybrid frame's g-buffer albedo, where the checker must stay crisp."""
import numpy as np
import pytest

from kajiya_tpu_torch.core.camera import make_view_constants
from kajiya_tpu_torch.frame import (RenderConfig, init_frame_state,
                                    init_reference_state, render_frame,
                                    render_frame_reference)
from kajiya_tpu_torch.scene.procedural import textured_cornell_box
from kajiya_tpu_torch.scene.scene import build_gpu_scene
from kajiya_tpu_torch.world import build_trace_scene

W, H = 64, 48
DEV = "cpu"


def _setup():
    ts, _ = build_trace_scene(build_gpu_scene(textured_cornell_box(),
                                              device=DEV), device=DEV)
    view = make_view_constants((0, 0, 2.4), (0, 0, -1), fov_y_deg=55.0,
                               width=W, height=H, device=DEV)
    return ts, view


def _cfg(**kw):
    return RenderConfig(width=W, height=H, max_trace_steps=256,
                        use_taa=False, use_motion_blur=False, **kw)


@pytest.fixture(scope="module")
def textured_albedo():
    ts, view = _setup()
    cfg = _cfg()
    _, out = render_frame(ts, init_frame_state(cfg, device=DEV), view, cfg)
    return out["gbuffer"]["albedo"].numpy()


@pytest.fixture(scope="module")
def textured_pair():
    """(PT, hybrid with full secondary shading, hybrid with flat)."""
    ts, view = _setup()

    def hybrid(full):
        cfg = _cfg(secondary_full_shading=full)
        state = init_frame_state(cfg, device=DEV)
        for _ in range(16):
            state, out = render_frame(ts, state, view, cfg)
        return out["lit"].numpy()

    cfg = _cfg()
    rstate = init_reference_state(cfg, device=DEV)
    for _ in range(48):
        rstate, rout = render_frame_reference(ts, rstate, view, cfg,
                                              num_bounces=5,
                                              pixel_filter=False)
    return rout["lit"].numpy(), hybrid(True), hybrid(False)


def _rb_ratio(img):
    cols = slice(W // 4, 3 * W // 4)
    floor_rb = img[-10:, cols, 0] - img[-10:, cols, 2]
    wall_rb = (img[H // 2 - 8: H // 2, cols, 0]
               - img[H // 2 - 8: H // 2, cols, 2])
    return floor_rb.std() / max(wall_rb.std(), 1e-6)


def test_textured_energy_and_rmse(textured_pair):
    pt, hy_full, _ = textured_pair
    assert abs(hy_full.mean() / pt.mean() - 1.0) < 0.2
    rmse = float(np.sqrt(np.mean((hy_full - pt) ** 2)))
    assert rmse < 0.21, rmse


def test_primary_texture_visible(textured_pair):
    pt, hy_full, _ = textured_pair
    assert _rb_ratio(pt) > 2.0, _rb_ratio(pt)
    assert _rb_ratio(hy_full) > 1.3, _rb_ratio(hy_full)


def test_primary_texture_albedo_crisp(textured_albedo):
    alb = textured_albedo
    cols = slice(W // 4, 3 * W // 4)
    floor_rb = alb[-10:, cols, 0] - alb[-10:, cols, 2]
    wall_rb = (alb[H // 2 - 8: H // 2, cols, 0]
               - alb[H // 2 - 8: H // 2, cols, 2])
    assert floor_rb.std() > 2.0 * wall_rb.std(), (floor_rb.std(),
                                                  wall_rb.std())


def test_secondary_shading_bias_budget(textured_pair):
    pt, hy_full, hy_flat = textured_pair
    bias = np.abs(hy_full - hy_flat).mean()
    assert bias > 0.005, bias
    assert bias < 0.08, bias
    for img in (hy_full, hy_flat):
        rmse = float(np.sqrt(np.mean((img - pt) ** 2)))
        assert rmse < 0.21, rmse
