"""Golden-oracle checks of the port: its hybrid frame against its own
reference path tracer (the untextured half of `tests/test_oracle.py`, with
the same bounds). Cornell at 64x48: 48 progressive PT frames of 5 bounces
without the pixel filter (the hybrid g-buffer point-samples pixel centers,
TAA is off), against 16 hybrid frames of the default config with TAA and
motion blur off, the default irradiance cache included. Measured on the
CPU: energy ratio 0.858, non-emitter ratio 0.669, RMSE 0.165, correlation
0.9989 (the JAX test's own measurements: 0.855, 0.66, 0.19)."""
import numpy as np
import pytest

from kajiya_tpu_torch.core.camera import make_view_constants
from kajiya_tpu_torch.frame import (RenderConfig, init_frame_state,
                                    init_reference_state, render_frame,
                                    render_frame_reference)
from kajiya_tpu_torch.scene.procedural import cornell_box
from kajiya_tpu_torch.scene.scene import build_gpu_scene
from kajiya_tpu_torch.world import build_trace_scene

W, H = 64, 48


def converged_pair(device):
    """(pt, hybrid) lit images of cornell, as numpy (H, W, 3)."""
    ts, _ = build_trace_scene(build_gpu_scene(cornell_box(), device=device),
                              device=device)
    view = make_view_constants((0, 0, 2.4), (0, 0, -1), fov_y_deg=55.0,
                               width=W, height=H, device=device)
    cfg = RenderConfig(width=W, height=H, max_trace_steps=256,
                       use_taa=False, use_motion_blur=False)
    rstate = init_reference_state(cfg, device=device)
    for _ in range(48):
        rstate, rout = render_frame_reference(ts, rstate, view, cfg,
                                              num_bounces=5,
                                              pixel_filter=False)
    state = init_frame_state(cfg, device=device)
    for _ in range(16):
        state, out = render_frame(ts, state, view, cfg)
    return rout["lit"].cpu().numpy(), out["lit"].cpu().numpy()


def oracle_metrics(pt, hy):
    """The oracle's numbers: energy ratio, non-emitter energy ratio (the
    20x emitter is ~60% of the energy and can mask a GI deficit), RMSE and
    the correlation of the two luminance images."""
    lp, lh = pt.mean(-1), hy.mean(-1)
    em = lp > 3.0
    return {"energy_ratio": float(hy.mean() / pt.mean()),
            "non_emitter_ratio": float(lh[~em].sum() / lp[~em].sum()),
            "rmse": float(np.sqrt(np.mean((hy - pt) ** 2))),
            "correlation": float(np.corrcoef(lp.ravel(), lh.ravel())[0, 1])}


# tests/test_oracle.py's bounds
BOUNDS = {"energy_ratio": (0.8, 1.2), "non_emitter_ratio": (0.55, 1.3),
          "rmse": (-np.inf, 0.21), "correlation": (0.85, np.inf)}


@pytest.fixture(scope="module")
def pair():
    return converged_pair("cpu")


@pytest.fixture(scope="module")
def metrics(pair):
    return oracle_metrics(*pair)


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_hybrid_against_oracle(metrics, name):
    lo, hi = BOUNDS[name]
    assert lo < metrics[name] < hi, metrics


def test_color_bleed_present(pair):
    """Near the red wall redder than green, near the green wall greener
    than red, in both renders."""
    for img in pair:
        left = img[H // 2 - 6: H // 2 + 6, 8:16]
        right = img[H // 2 - 6: H // 2 + 6, -16:-8]
        assert left[..., 0].mean() > left[..., 1].mean()
        assert right[..., 1].mean() > right[..., 0].mean()
