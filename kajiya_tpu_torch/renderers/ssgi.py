"""SSAO: half-res screen-space ambient occlusion (port of
`kajiya_tpu/renderers/ssgi.py`).

Half-res AO from depth + normal, then spatial filter -> edge-aware upsample
-> temporal filter. It does not darken final lighting; it steers GI kernel
sizes and sample weighting. Horizon sampling runs along 4 directions with
fixed step counts and 4 quantized kernel rotations picked per pixel by blue
noise, so every tap is a static pixel shift. With a row `band`
(parallel/), the taps' halo rows come from the neighbouring bands.
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..core import bluenoise
from ..core import img as im
from ..core.camera import ViewConstants
from ..device import const_tensor
from ..ops import smallvec as smv
from .reprojection import reproject_image

_N_DIRS = 4
_N_STEPS = 4
_N_ROT = 4          # quantized kernel rotations
_RADIUS_PX = 24.0


@lru_cache(maxsize=8)
def _tap_offsets(hh: int, hw: int):
    """All DIRS x STEPS x ROT static tap offsets: (dy, dx) shifts and the
    float (du, dv) uv deltas, as nested tuples."""
    offs, duv = [], []
    for d in range(_N_DIRS):
        for s in range(1, _N_STEPS + 1):
            r_px = _RADIUS_PX * (s / _N_STEPS) ** 1.5
            for k in range(_N_ROT):
                ang = (d + (k + 0.5) / _N_ROT) * (math.pi / _N_DIRS)
                dx = int(round(math.cos(ang) * r_px))
                dy = int(round(math.sin(ang) * r_px))
                offs.append((-dy, -dx))
                duv.append((dx / hw, dy / hh))
    return tuple(offs), tuple(duv)


def ssao_half(gb, view: ViewConstants, frame_idx, near: float = 0.01,
              band=None):
    """Half-res AO in [0,1]. Returns (h/2, w/2) f32."""
    h, w = gb["depth"].shape if band is None else (band.height, band.width)
    hh, hw = h // 2, w // 2
    hb = None if band is None else band.half()
    dev = gb["depth"].device
    depth_h = im.downsample_nearest(gb["depth"])
    normal_h = im.decimate2(gb["normal"])
    hit_h = im.decimate2(gb["hit"])
    vz = near / torch.clamp(depth_h, min=1e-12)

    uv = im.pixel_uv(hh, hw, device=dev, band=hb)
    rows = depth_h.shape[0]
    # view-space position of each half-res pixel
    ndc = torch.stack([uv[..., 0] * 2 - 1, 1 - uv[..., 1] * 2], dim=-1)
    c2v = view.clip_to_view
    # reversed-inf-Z: view pos = vz * ray through pixel
    vdir = smv.matvec(c2v[:3, :2], ndc) + c2v[:3, 2] + c2v[:3, 3]
    # normalize so that -z == 1
    vdir = vdir / torch.clamp(-vdir[..., 2:3], min=1e-8)
    vpos = vdir * vz[..., None]
    vnorm = smv.transform_dirs(view.world_to_view, normal_h)

    u_rot = bluenoise.blue_noise_plane(rows, hw, frame_idx, stream=6,
                                       device=dev,
                                       y0=0 if hb is None else hb.y0)
    rot_k = torch.clamp((u_rot * _N_ROT).to(torch.int32), max=_N_ROT - 1)

    offs, duv = _tap_offsets(hh, hw)
    D, S, K = _N_DIRS, _N_STEPS, _N_ROT
    taps = im.shift_stack(depth_h, offs, hb).reshape(D, S, K, rows, hw)
    duv = const_tensor(duv, dev).reshape(D, S, K, 2)

    # per-pixel rotation select: collapse the K axis by rot_k
    sel = rot_k[None] == torch.arange(K, device=dev)[:, None, None]  # (K,hh,hw)
    s_vz = near / torch.clamp(
        torch.where(sel[None, None], taps, 0.0).sum(dim=2), min=1e-12)
    duv_sel = torch.where(sel[None, None, :, :, :, None],
                          duv[:, :, :, None, None, :], 0.0).sum(dim=2)

    suv = uv[None, None] + duv_sel                      # (D,S,hh,hw,2)
    s_ndc = torch.stack([suv[..., 0] * 2 - 1, 1 - suv[..., 1] * 2], dim=-1)
    s_vdir = smv.matvec(c2v[:3, :2], s_ndc) + c2v[:3, 2] + c2v[:3, 3]
    s_vdir = s_vdir / torch.clamp(-s_vdir[..., 2:3], min=1e-8)
    s_vpos = s_vdir * s_vz[..., None]
    delta = s_vpos - vpos[None, None]
    dist = torch.sqrt(smv.dot3(delta, delta))
    cos_h = smv.dot3(delta, vnorm[None, None]) / torch.clamp(dist, min=1e-6)
    # distance falloff keeps far geometry from occluding
    falloff = torch.clamp(1.0 - dist / (vz[None, None] * 0.3 + 0.3), 0.0, 1.0)
    horizon = torch.clamp(cos_h, min=0.0) * falloff     # (D,S,hh,hw)
    ao = 1.0 - horizon.amax(dim=1).sum(dim=0) / _N_DIRS
    return torch.where(hit_h, torch.clamp(ao, 0.0, 1.0), 1.0)


def init_state(h: int, w: int, device=None):
    return {"ssao_history": torch.ones((h, w), dtype=torch.float32,
                                       device=device)}


def ssao_pipeline(gb, view, frame_idx, state, reproj, near: float = 0.01,
                  band=None):
    """ssao -> spatial (half) -> upsample -> temporal. Returns (ao (H, W),
    state)."""
    from .rtdgi import _edge_aware_upsample

    ao_h = ssao_half(gb, view, frame_idx, near, band)
    ao_h = im.separable_blur(ao_h, im.GAUSS5,
                             None if band is None else band.half())
    # depth / normal-aware upsample: plain bilinear halos AO across depth
    # edges, which then misleads the GI filters
    ao = _edge_aware_upsample(ao_h[..., None], gb, band=band)[..., 0]
    prev = reproject_image(state["ssao_history"], reproj, fallback=ao,
                           band=band)
    out = prev * 0.85 + ao * 0.15
    out = torch.where(gb["hit"], out, 1.0)
    return out, {"ssao_history": out}
