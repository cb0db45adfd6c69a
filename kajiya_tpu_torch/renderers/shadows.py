"""Sun soft shadows: blue-noise cone-sampled shadow rays + temporal moments +
a-trous denoise (port of `kajiya_tpu/renderers/shadows.py`). With a row
`band` (parallel/), each a-trous step fetches its halo rows."""
from __future__ import annotations

import torch

from ..brdf.sampling import to_world, uniform_cone
from ..core import bluenoise
from ..core import img as im
from ..ops.smallvec import dot3
from ..ops.tiling import tile_order, untile_order
from ..rt.trace import scene_trace_shadow
from .reprojection import reproject_planes

RAY_EPS = 1e-4


def sun_shadow_rays(ts, gb, frame_idx, band=None):
    """Blue-noise cone-jittered sun rays, one per pixel: (org, dir, need)
    flat over pixels in row-major order; `need` marks lit-facing hits."""
    h, w = gb["depth"].shape
    bu1, bu2 = bluenoise.blue_noise_pair(h, w, frame_idx, stream=0,
                                         device=gb["depth"].device,
                                         y0=0 if band is None else band.y0)
    cos_max = torch.cos(ts.gpu.sun_angular_radius)
    local = uniform_cone(bu1.reshape(-1), bu2.reshape(-1), cos_max)
    sun_dir = to_world(ts.gpu.sun_direction.expand(local.shape), local)
    pos = gb["pos"].reshape(-1, 3)
    gn = gb["geo_normal"].reshape(-1, 3)
    n = gb["normal"].reshape(-1, 3)
    need = gb["hit"].reshape(-1) & (dot3(n, sun_dir) > 0.0)
    return pos + gn * RAY_EPS * 8, sun_dir, need


def trace_sun_shadow_mask(ts, gb, frame_idx, max_trace_steps=None,
                          band=None):
    """(H, W) f32 mask: 1 = lit by the sun, 0 = shadowed. One cone-jittered
    ray per pixel per frame."""
    h, w = gb["depth"].shape
    org, sun_dir, need_ray = sun_shadow_rays(ts, gb, frame_idx, band)
    if ts.woop is not None and "cmin" in ts.woop:
        # screen-tile chunks keep each shadow-ray frustum compact
        org_t = tile_order(org.reshape(h, w, 3)).reshape(-1, 3)
        dir_t = tile_order(sun_dir.reshape(h, w, 3)).reshape(-1, 3)
        occ_t = scene_trace_shadow(ts, org_t, dir_t, t_min=RAY_EPS,
                                   max_steps=max_trace_steps)
        occ = untile_order(occ_t, h, w).reshape(-1)
    else:
        occ = scene_trace_shadow(ts, org, sun_dir, t_min=RAY_EPS,
                                 max_steps=max_trace_steps)
    lit = torch.where(need_ray, (~occ).to(torch.float32), 0.0)
    return lit.reshape(h, w)


def init_state(h: int, w: int, device=None):
    return {
        "moments": torch.zeros((h, w, 2), dtype=torch.float32, device=device),
        "history_len": torch.zeros((h, w), dtype=torch.float32, device=device),
    }


def denoise(mask, state, reproj, gb, near: float = 0.01, band=None):
    """Temporal moments + 3x a-trous. Returns (filtered (H,W), new_state)."""
    fetched = reproject_planes(
        {"moments": state["moments"], "history_len": state["history_len"]},
        reproj, band)
    prev = fetched["moments"]
    hist_len = torch.clamp(fetched["history_len"] * reproj["validity"] + 1.0,
                           max=32.0)
    alpha = 1.0 / hist_len
    m1 = prev[..., 0] * (1 - alpha) + mask * alpha
    m2 = prev[..., 1] * (1 - alpha) + mask * mask * alpha
    var_t = torch.clamp(m2 - m1 * m1, min=0.0)
    _, var_s = im.local_moments_3x3(mask, band)
    var = torch.where(hist_len < 4.0, torch.maximum(var_t, var_s), var_t)

    filtered = m1
    vz = near / torch.clamp(gb["depth"], min=1e-12)
    normal = gb["normal"]
    for step in (1, 2, 4):
        filtered, var = _atrous(filtered, var, vz, normal, step, band)
    new_state = {"moments": torch.stack([m1, m2], dim=-1),
                 "history_len": hist_len}
    return torch.clamp(filtered, 0.0, 1.0), new_state


_ATROUS_W = (1.0, 2.0 / 3.0, 1.0 / 6.0)


def _atrous(img, var, view_z, normal, step: int, band=None):
    """One edge-aware a-trous step over the 9 stacked taps."""
    sigma_l = torch.sqrt(torch.clamp(var, min=1e-8)) * 3.0 + 1e-3
    offs = [(iy * step, ix * step) for iy in (-1, 0, 1) for ix in (-1, 0, 1)]
    wk = torch.tensor([_ATROUS_W[abs(iy)] * _ATROUS_W[abs(ix)]
                       for iy in (-1, 0, 1) for ix in (-1, 0, 1)],
                      dtype=torch.float32, device=img.device)
    packed = torch.cat([img[..., None], var[..., None], view_z[..., None],
                        normal], dim=-1)
    s = im.shift_stack(packed, offs, band)                # (9, H, W, 6)
    v, vv, z, nn = s[..., 0], s[..., 1], s[..., 2], s[..., 3:6]
    w_z = torch.exp(-torch.abs(z - view_z) / (0.1 * view_z + 1e-4))
    w_n = torch.clamp(torch.sum(nn * normal, dim=-1), min=0.0) ** 8
    w_l = torch.exp(-torch.abs(v - img) / sigma_l)
    wgt = wk[:, None, None] * w_z * w_n * w_l
    acc = torch.sum(v * wgt, dim=0)
    acc_v = torch.sum(vv * wgt * wgt, dim=0)
    acc_w = torch.sum(wgt, dim=0)
    inv = 1.0 / torch.clamp(acc_w, min=1e-8)
    return acc * inv, acc_v * inv * inv
