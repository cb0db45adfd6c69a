"""Motion blur: velocity tile reduce -> dilate -> gather blur (port of
`kajiya_tpu/renderers/motion_blur.py`).

Per-16px-tile max velocity, 3x3 tile dilation, then a gather blur along the
dominant velocity at quarter res (8 nearest-warp taps through the warp
kernel), composited over the full-res image by the blur amount.

With a row `band` (parallel/; band edges on multiples of 16 rows keep the
tiles whole), the tiles of the band are reduced on their rank, the dilation
fetches one tile row of halo, the two resizes gather their small sources
(the tile plane and the quarter-res blur), the taps gather the packed
quarter-res plane, and the clamps and the blur amount read the frame's
size.
"""
from __future__ import annotations

import torch

from ..core import img as im
from ..core.profiling import pass_scope
from ..device import const_tensor

TILE = 16
N_TAPS = 8


def _norm2(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _tile_reduce_max(vel, tile: int):
    """(H, W, 2) -> (H/t, W/t, 2): the velocity of max magnitude per tile;
    ties average."""
    h, w = vel.shape[:2]
    ht, wt = h // tile, w // tile
    v = vel[:ht * tile, :wt * tile].reshape(ht, tile, wt, tile, 2)
    mag = (v * v).sum(dim=-1)                      # (ht, tile, wt, tile)
    mmax = torch.amax(mag, dim=(1, 3), keepdim=True)
    win = (mag >= mmax)[..., None]
    cnt = win.sum(dim=(1, 3)).to(torch.float32)
    return (v * win).sum(dim=(1, 3)) / torch.clamp(cnt, min=1.0)


def _dilate_max(tiles, band=None):
    """3x3 max-magnitude dilation; ties take the first tap."""
    s = im.shift_stack(tiles, im.OFF3X3, band)       # (9, ht, wt, 2)
    k = torch.argmax(_norm2(s), dim=0)
    return torch.gather(s, 0, k[None, ..., None].expand(1, *s.shape[1:]))[0]


def motion_blur(color, velocity, depth, frame_fraction: float = 0.5,
                band=None):
    """color (H, W, 3), velocity (H, W, 2) in uv units (cur -> prev), depth
    reversed-Z. Returns the blurred color. frame_fraction scales the blur
    (the shutter). `band`: the planes' row band of the frame (parallel/)."""
    h, w = color.shape[:2] if band is None else (band.height, band.width)
    dev = color.device
    tb = None if band is None else band.scaled(TILE)
    qb = None if band is None else band.scaled(4)
    with pass_scope("tiles"):
        tiles = _tile_reduce_max(velocity, TILE)
        tiles = _dilate_max(tiles, tb)
        tile_vel = im.upsample_bilinear(tiles, h, w, tb, band) \
            * frame_fraction

    # gather taps at QUARTER res; velocities clamp to a local window
    hh, hw = h // 4, w // 4
    color_h = im.downsample_2x(im.downsample_2x(color))
    depth_h = im.downsample_nearest(im.downsample_nearest(depth))
    rows_q = color_h.shape[0]
    max_uv = const_tensor((48.0 / hw, 20.0 / hh), dev)
    vel_h = torch.minimum(torch.maximum(
        im.decimate2(im.decimate2(tile_vel)), -max_uv), max_uv)
    uv_h = im.pixel_uv(hh, hw, device=dev, band=qb)
    packed = torch.cat([color_h, depth_h[..., None]], dim=-1)
    if qb is not None:
        # every tap reads the whole quarter-res plane: gathered once
        packed = qb.gather(packed, label="motion blur taps")
    acc = torch.zeros_like(color_h)
    wsum = torch.zeros((rows_q, hw, 1), dtype=torch.float32, device=dev)
    with pass_scope("taps"):
        for i in range(N_TAPS):
            t = (i + 0.5) / N_TAPS - 0.5
            suv = uv_h + vel_h * t
            f = im.warp_nearest(packed, suv)
            c, d = f[..., :3], f[..., 3]
            # depth-aware: do not smear foreground over background
            wgt = torch.where(d[..., None] >= depth_h[..., None] * 0.95,
                              1.0, 0.25)
            acc = acc + c * wgt
            wsum = wsum + wgt
    blur_h = acc / torch.clamp(wsum, min=1e-6)
    blur = im.upsample_bilinear(blur_h, h, w, qb, band)
    amount = torch.clamp(_norm2(tile_vel * const_tensor(
        (float(w), float(h)), dev)) / 2.0, 0.0, 1.0)[..., None]
    return color * (1.0 - amount) + blur * amount
