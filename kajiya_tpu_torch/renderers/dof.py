"""Depth of field: circle of confusion + gather blur (port of
`kajiya_tpu/renderers/dof.py`). Opt-in (`RenderConfig(use_dof=True)`), as
in the reference, where the pass exists but is not wired by default.

With a row `band` (parallel/), the colour and the CoC are fetched with
`HALO` rows of the neighbouring bands each way, and every tap is sampled on
the frame's lattice and clamp, shifted into that window."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import img as im
from ..device import const_tensor

N_TAPS = 12
_GOLDEN_ANGLE = 2.39996
MAX_COC_PX = 12.0
# the rows a tap reaches: its offset is below one pixel per pixel of CoC
# (the spiral's radius is below 1), and the bilinear footprint adds a row
HALO = math.ceil(MAX_COC_PX) + 1


def circle_of_confusion(depth, focus_dist: float, aperture: float,
                        near: float = 0.01, max_coc_px: float = MAX_COC_PX):
    """Signed CoC radius in pixels from reversed-Z depth."""
    vz = near / torch.clamp(depth, min=1e-12)
    coc = aperture * (vz - focus_dist) / torch.clamp(vz, min=1e-4)
    return torch.clamp(coc, -max_coc_px, max_coc_px)


def _tap_offsets(h: int, w: int):
    """(N_TAPS, 2) golden-angle spiral offsets in uv per pixel of CoC,
    float32 as the JAX module computes them."""
    out = []
    for i in range(N_TAPS):
        r = np.sqrt(np.float32((i + 0.5) / N_TAPS))
        a = np.float32(i * _GOLDEN_ANGLE)
        off = (np.array([np.cos(a) * r, np.sin(a) * r], np.float32)
               / np.array([w, h], np.float32))
        out.append(tuple(float(x) for x in off))
    return tuple(out)


def dof_gather(color, depth, focus_dist: float, aperture: float,
               near: float = 0.01, band=None):
    """Scatter-as-gather disk blur weighted by CoC overlap. `band`: the
    planes' row band of the frame (parallel/)."""
    h, w = color.shape[:2] if band is None else (band.height, band.width)
    rows = color.shape[0]
    coc = circle_of_confusion(depth, focus_dist, aperture, near)
    acoc = torch.abs(coc)
    uv = im.pixel_uv(h, w, device=color.device, band=band)
    offs = const_tensor(_tap_offsets(h, w), color.device)
    # colour and CoC sampled together: the same per-channel arithmetic
    src = torch.cat([color, acoc[..., None]], dim=-1)
    row0 = 0
    if band is not None:
        src, above = band.halo(src, HALO, label="dof halo")
        row0 = band.y0 - above
    acc = torch.zeros_like(color)
    wsum = torch.zeros((rows, w, 1), dtype=torch.float32,
                       device=color.device)
    for i in range(N_TAPS):
        suv = uv + offs[i] * acoc[..., None]
        s = im.sample_bilinear(src, suv, h, row0)
        c, s_coc = s[..., :3], s[..., 3]
        # a sample contributes if its own CoC reaches back to this pixel
        wgt = torch.clamp(s_coc / torch.clamp(acoc, min=1e-3), 0.0,
                          1.0)[..., None]
        acc = acc + c * wgt
        wsum = wsum + wgt
    return acc / torch.clamp(wsum, min=1e-6)
