"""Reprojection map (port of `kajiya_tpu/renderers/reprojection.py`): where
was this pixel last frame, and is its history valid. The history fetches go
through the warp kernel (core/img.py `warp_nearest` / `warp_bilinear`).
With a row `band` (parallel/), the planes are the band's and the history
sources are gathered whole for the fetch."""
from __future__ import annotations

import torch

from ..core import img as im
from ..core.camera import ViewConstants


def calculate_reprojection_map(gb, prev_depth, view: ViewConstants,
                               near: float = 0.01, band=None):
    """Returns dict(prev_uv (H,W,2), validity (H,W), in_bounds (H,W))."""
    h, w = gb["depth"].shape if band is None else (band.height, band.width)
    uv = im.pixel_uv(h, w, device=prev_depth.device, band=band)
    prev_uv = uv + gb["velocity"]
    in_bounds = ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] < 1.0)
                 & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] < 1.0))
    pos = gb["pos"]
    wv = view.world_to_view_prev
    vz_prev_expected = -(wv[2, 0] * pos[..., 0] + wv[2, 1] * pos[..., 1]
                         + wv[2, 2] * pos[..., 2] + wv[2, 3])
    prev_d = im.warp_nearest(prev_depth, prev_uv, band=band)
    vz_prev_stored = near / torch.clamp(prev_d, min=1e-12)
    ratio = vz_prev_stored / torch.clamp(vz_prev_expected, min=1e-6)
    depth_ok = torch.abs(ratio - 1.0) < 0.05
    had_hit_prev = prev_d > 0.0
    validity = (in_bounds & depth_ok & had_hit_prev & gb["hit"]).to(
        torch.float32)
    return {"prev_uv": prev_uv, "validity": validity,
            "in_bounds": in_bounds.to(torch.float32)}


def reproject_image(history, reproj, fallback=None, band=None):
    """Bilinear-fetch history at prev_uv, falling back where invalid."""
    fetched = im.warp_bilinear(history, reproj["prev_uv"], band=band)
    v = reproj["validity"]
    if history.ndim == 3:
        v = v[..., None]
    if fallback is None:
        fallback = torch.zeros_like(fetched)
    return fetched * v + fallback * (1.0 - v)


def reproject_planes(planes: dict, reproj, band=None):
    """Reproject several history planes with one fetch: concatenated
    channel-wise, warped once, split back."""
    keys = list(planes)
    parts, widths = [], []
    for k in keys:
        x = planes[k]
        if x.ndim == 2:
            x = x[..., None]
        parts.append(x)
        widths.append(x.shape[-1])
    fetched = im.warp_bilinear(torch.cat(parts, dim=-1), reproj["prev_uv"],
                               band=band)
    fetched = fetched * reproj["validity"][..., None]
    out, off = {}, 0
    for k, w in zip(keys, widths):
        sl = fetched[..., off:off + w]
        out[k] = sl[..., 0] if planes[k].ndim == 2 else sl
        off += w
    return out
