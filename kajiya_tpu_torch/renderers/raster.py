"""Tile-binned primary visibility ("raster simple"; port of
`kajiya_tpu/renderers/raster.py`).

Each Morton-ordered 128-triangle block's world AABB is projected to a
conservative screen rect; every 512-ray chunk (4 rows of a 64 x 128 screen
tile) keeps the blocks whose rect overlaps its own, sorted front to back, and
the culled Woop kernel walks exactly those lists. Scenes without cluster
tables go straight to the scene intersector (the brute kernel).
"""
from __future__ import annotations

import torch

from ..core.camera import ViewConstants, camera_rays
from ..ops.tiling import TILE_H, TILE_W, pad_hw, tile_order, untile_order
from ..ops.woop_cuda import (CULL_RAY_BLOCK, INF, prepare_culled, run_culled,
                             sort_blocks_by_distance)
from ..rt.trace import Hit, scene_trace_closest


def _block_screen_rects(bmin, bmax, view: ViewConstants, w: int, h: int):
    """(C, 3) world AABBs -> conservative pixel rects (C, 4) [x0, y0, x1,
    y1]. Empty/behind blocks give empty rects; blocks crossing the eye plane
    give full-screen rects."""
    dev = bmin.device
    sel = torch.tensor([[(i >> k) & 1 for k in range(3)] for i in range(8)],
                       dtype=torch.float32, device=dev)      # (8, 3)
    corners = bmin[:, None, :] * (1.0 - sel) + bmax[:, None, :] * sel
    m = view.world_to_clip
    clip = torch.einsum("cki,ji->ckj", corners, m[:, :3]) + m[:, 3]
    cw = clip[..., 3]
    in_front = cw > 1e-6
    any_front = in_front.any(dim=1)
    all_front = in_front.all(dim=1)
    nonempty = ((bmin <= bmax).all(dim=-1)
                & (torch.isfinite(bmin) & torch.isfinite(bmax)).all(dim=-1))
    safe_w = torch.where(in_front, cw, 1.0)
    ndc = clip[..., :2] / safe_w[..., None]
    px = (0.5 + 0.5 * ndc[..., 0]) * w
    py = (0.5 - 0.5 * ndc[..., 1]) * h
    big = 1e9
    finite = torch.isfinite(px) & torch.isfinite(py)
    x0 = torch.where(in_front, torch.where(finite, px, -big), big).amin(dim=1)
    y0 = torch.where(in_front, torch.where(finite, py, -big), big).amin(dim=1)
    x1 = torch.where(in_front, torch.where(finite, px, big), -big).amax(dim=1)
    y1 = torch.where(in_front, torch.where(finite, py, big), -big).amax(dim=1)
    crossing = any_front & ~all_front
    x0 = torch.where(crossing, 0.0, x0)
    y0 = torch.where(crossing, 0.0, y0)
    x1 = torch.where(crossing, float(w), x1)
    y1 = torch.where(crossing, float(h), y1)
    dead = ~any_front | ~nonempty
    x0 = torch.where(dead, big, x0)
    x1 = torch.where(dead, -big, x1)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def _chunk_rects(w: int, h: int, rows_per_chunk: int, device=None,
                 row0: int = 0):
    """Pixel rect of every ray chunk in tile-major order:
    (n_chunks, 4) [x0, y0, x1, y1]. `row0` is the screen row of the first
    ray row (a row band's)."""
    ph, pw = pad_hw(h, w)
    nty, ntx = (h + ph) // TILE_H, (w + pw) // TILE_W
    per_tile = TILE_H // rows_per_chunk
    i = torch.arange(nty * ntx * per_tile, device=device)
    tile = i // per_tile
    sub = i % per_tile
    ty, tx = tile // ntx, tile % ntx
    y0 = (ty * TILE_H + sub * rows_per_chunk + row0).to(torch.float32)
    x0 = (tx * TILE_W).to(torch.float32)
    return torch.stack([x0, y0, x0 + TILE_W, y0 + rows_per_chunk], dim=-1)


def _overlap(chunk_rects, block_rects):
    """(n_chunks, C) bool rect overlap."""
    cx0, cy0, cx1, cy1 = [chunk_rects[:, k, None] for k in range(4)]
    bx0, by0, bx1, by1 = [block_rects[None, :, k] for k in range(4)]
    return (cx0 <= bx1) & (cx1 >= bx0) & (cy0 <= by1) & (cy1 >= by0)


def _mask_to_lists(hit, bmin, bmax, eye):
    """(n, C) bool -> front-to-back (blist, bdist, count); primary rays all
    start at the eye, so a block's t lower bound is |center - eye| - radius."""
    c = (bmin + bmax) * 0.5
    r = torch.sqrt(torch.clamp(((bmax - bmin) * 0.5) ** 2, min=0.0).sum(-1))
    dlb = torch.clamp(torch.sqrt(torch.clamp(((c - eye) ** 2).sum(-1),
                                             min=0.0)) - r, min=0.0)
    dlb = torch.where(torch.isfinite(dlb), dlb, INF)
    return sort_blocks_by_distance(hit, dlb[None, :].expand(hit.shape))


def raster_batch(ts, view: ViewConstants, w: int, h: int, band=None):
    """Kernel C's inputs for primary visibility of a scene with cluster
    tables: camera rays in screen-tile order and each chunk's exact
    screen-rect block list, front to back. With `band` (parallel/), the rays
    of its rows, tiled from the band's first row."""
    org, d = camera_rays(view, w, h, band=band)
    woop = ts.woop
    rects = _block_screen_rects(woop["cmin64"], woop["cmax64"], view, w, h)
    rows, row0 = (h, 0) if band is None else (band.n, band.y0)
    mask = _overlap(_chunk_rects(w, rows, CULL_RAY_BLOCK // TILE_W,
                                 org.device, row0), rects)
    lists = _mask_to_lists(mask, woop["cmin64"], woop["cmax64"],
                           view.eye_position)
    return prepare_culled(woop, tile_order(org).reshape(-1, 3),
                          tile_order(d).reshape(-1, 3), block_lists=lists)


def raster_hit(ts, view: ViewConstants, w: int, h: int,
               max_trace_steps=None, band=None) -> Hit:
    """Rasterized primary visibility -> per-pixel Hit, flat in row-major
    pixel order (of `band`'s rows when one is given)."""
    woop = ts.woop
    if woop is None or woop.get("cmin") is None:
        org, d = camera_rays(view, w, h, band=band)
        return scene_trace_closest(ts, org.reshape(-1, 3), d.reshape(-1, 3),
                                   max_steps=max_trace_steps)
    b = raster_batch(ts, view, w, h, band)
    t, tri, u, v = run_culled(b, t_min=1e-4, any_hit=False)
    hit = Hit(t=t, tri=tri, u=u, v=v)
    rows = h if band is None else band.n
    return hit.map(lambda x: untile_order(x[:b.n_rays], rows, w).reshape(-1))
