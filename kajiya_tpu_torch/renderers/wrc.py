"""World radiance cache: a grid of octahedral radiance probes (port of
`kajiya_tpu/renderers/wrc.py`).

An 8x3x8 grid of 32^2 octahedral radiance probes, traced as one flat
wavefront and blended into a (GX*GY*GZ, R, R, 3) atlas. Off by default, as
in the reference; `RenderConfig(use_wrc=True)` traces it every frame and
binds `lookup` into the secondary hit lighting for far-field hits.

Over several ranks (parallel/), the atlas is split over its probes
(`probe_band`): each rank traces its probes' texels, a contiguous slice of
the wavefront, and blends its slice of the atlas (the hysteresis is per
texel); the frame all-gathers the whole atlas for `lookup`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import const_tensor
from ..sky.env import oct_decode, oct_encode


@dataclass(frozen=True)
class WrcConfig:
    grid: tuple = (8, 3, 8)         # probe grid dims
    probe_res: int = 32             # 32^2 octahedral probes
    grid_spacing: float = 2.0
    grid_origin: tuple = (-8.0, 0.5, -8.0)


def probe_centers(cfg: WrcConfig, device):
    gx, gy, gz = cfg.grid
    ii = torch.stack(torch.meshgrid(
        torch.arange(gx, device=device), torch.arange(gy, device=device),
        torch.arange(gz, device=device), indexing="ij"), -1)
    return (const_tensor(tuple(float(x) for x in cfg.grid_origin), device)
            + ii.reshape(-1, 3).to(torch.float32) * cfg.grid_spacing)


def init_state(cfg: WrcConfig, device):
    n = cfg.grid[0] * cfg.grid[1] * cfg.grid[2]
    return {"wrc_atlas": torch.zeros((n, cfg.probe_res, cfg.probe_res, 3),
                                     dtype=torch.float32, device=device)}


def probe_band(cfg: WrcConfig, comm):
    """The atlas's probes over the ranks of `comm`, as a `Band` over the
    probe axis: member i holds probes `even_slices(N, size)[i]`."""
    from ..parallel.comm import Band, even_slices

    n = cfg.grid[0] * cfg.grid[1] * cfg.grid[2]
    if n < comm.size:
        raise NotImplementedError(f"{n} probes cannot be split over "
                                  f"{comm.size} ranks")
    return Band(comm, even_slices(n, comm.size), n, cfg.probe_res)


def probe_rays(cfg: WrcConfig, device):
    """(org, dir) of every probe texel, (N * R * R, 3) each, probe-major."""
    n = cfg.grid[0] * cfg.grid[1] * cfg.grid[2]
    r = cfg.probe_res
    ar = torch.arange(r, device=device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    uv = (torch.stack([gx, gy], -1) + 0.5) / r
    dirs = oct_decode(uv.to(torch.float32)).reshape(-1, 3)
    org = torch.repeat_interleave(probe_centers(cfg, device), r * r, dim=0)
    return org, dirs.repeat(n, 1)


def trace_wrc(state, ts, sky_env, diffuse_env, frame_idx, cfg: WrcConfig,
              max_trace_steps=None, hysteresis: float = 0.9, probes=None):
    """Trace every probe texel ('wrc trace' pass) and blend into the
    atlas. `probes` (a `probe_band`): trace this rank's probes only and
    return its slice of the atlas; `state` holds that slice, or the whole
    atlas, which is then cut to it."""
    from ..rt.trace import scene_trace_closest
    from .hit_lighting import hit_radiance

    atlas = state["wrc_atlas"]
    org, d = probe_rays(cfg, atlas.device)
    if probes is not None:
        if atlas.shape[0] == probes.height:
            atlas = probes.rows_of(atlas)
        texels = cfg.probe_res * cfg.probe_res
        org = org[probes.y0 * texels:probes.y1 * texels]
        d = d[probes.y0 * texels:probes.y1 * texels]
    hit = scene_trace_closest(ts, org, d, t_min=1e-3,
                              max_steps=max_trace_steps)
    rad = hit_radiance(ts, hit, d, sky_env, diffuse_env,
                       max_trace_steps=max_trace_steps)
    new = rad.reshape(atlas.shape)
    return {"wrc_atlas": atlas * hysteresis + new * (1.0 - hysteresis)}


def lookup(state, cfg: WrcConfig, pos, direction):
    """Radiance along `direction` from the probe nearest `pos` (round half
    to even, as `jnp.round`; the int casts truncate)."""
    gx, gy, gz = cfg.grid
    dev = pos.device
    rel = ((pos - const_tensor(tuple(float(x) for x in cfg.grid_origin), dev))
           / cfg.grid_spacing)
    idx = torch.round(rel).to(torch.int32)
    idx = torch.minimum(torch.clamp(idx, min=0), const_tensor(
        (gx - 1, gy - 1, gz - 1), dev, torch.int32))
    flat = (idx[..., 0] * gy + idx[..., 1]) * gz + idx[..., 2]
    uv = oct_encode(direction)
    r = cfg.probe_res
    xi = torch.clamp((uv[..., 0] * r).to(torch.int32), 0, r - 1)
    yi = torch.clamp((uv[..., 1] * r).to(torch.int32), 0, r - 1)
    return state["wrc_atlas"][flat.long(), yi.long(), xi.long()]


def see_through(state, cfg: WrcConfig, org, d, max_dist: float = 40.0,
                steps: int = 32):
    """Debug: raymarch the probe field ('wrc see through' pass). Returns
    (R, 3) radiance approximation."""
    t = torch.linspace(0.5, max_dist, steps, device=org.device)
    acc = torch.zeros(org.shape[:-1] + (3,), dtype=torch.float32,
                      device=org.device)
    w = torch.zeros(org.shape[:-1] + (1,), dtype=torch.float32,
                    device=org.device)
    for i in range(steps):
        p = org + d * t[i]
        s = lookup(state, cfg, p, d)
        take = (w[..., 0] < 1.0)[..., None]
        acc = acc + torch.where(take, s * (1.0 / steps), 0.0)
        w = w + torch.where(take, 1.0 / steps, 0.0)
    return acc
