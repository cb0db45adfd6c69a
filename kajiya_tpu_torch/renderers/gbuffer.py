"""G-buffer from primary visibility (port of
`kajiya_tpu/renderers/gbuffer.py`): the raster path and the traced one
(camera rays through the same intersector). Outputs are planar (H, W[, C])
float32 planes plus the `hit` mask."""
from __future__ import annotations

import torch

from ..core.camera import ViewConstants, camera_rays
from ..ops.smallvec import matvec
from ..ops.tiling import tile_order, untile_order
from ..rt.trace import scene_trace_closest
from ..world import TraceScene, hit_attributes


def _project(m, p):
    """(4,4) @ (..., 3) homogeneous -> clip (..., 4)."""
    return matvec(m[:, :3], p) + m[:, 3]


def raytrace_gbuffer(ts: TraceScene, view: ViewConstants, width: int,
                     height: int, max_trace_steps=None,
                     no_normal_maps: bool = False, band=None):
    """Trace one camera ray per pixel -> gbuffer planes (of `band`'s rows of
    the frame when one is given, parallel/). Where the scene has cluster
    tables the rays go out in 64x128 screen tiles (compact chunks, narrow
    frustums, tight culling), counted from the band's first row, the last
    tile row edge-padded with copies of real rays, and the hits come back
    in pixel order."""
    org, d = camera_rays(view, width, height, band=band)
    rows = height if band is None else band.n
    tiled = ts.woop is not None and "cmin" in ts.woop
    if tiled:
        orgf = tile_order(org).reshape(-1, 3)
        df = tile_order(d).reshape(-1, 3)
    else:
        orgf = org.reshape(-1, 3)
        df = d.reshape(-1, 3)
    hit = scene_trace_closest(ts, orgf, df, max_steps=max_trace_steps)
    if tiled:
        hit = hit.map(lambda x: untile_order(x, rows, width).reshape(-1))
        df = d.reshape(-1, 3)
    return gbuffer_from_hit(ts, view, hit, df, width, height,
                            no_normal_maps=no_normal_maps,
                            rows=None if band is None else band.n)


def raster_gbuffer(ts: TraceScene, view: ViewConstants, width: int,
                   height: int, max_trace_steps=None,
                   no_normal_maps: bool = False, band=None):
    """Rasterized primary visibility feeding the gbuffer planes (of
    `band`'s rows of the frame when one is given, parallel/)."""
    from .raster import raster_hit

    _, d = camera_rays(view, width, height, band=band)
    hit = raster_hit(ts, view, width, height, max_trace_steps=max_trace_steps,
                     band=band)
    return gbuffer_from_hit(ts, view, hit, d.reshape(-1, 3), width, height,
                            no_normal_maps=no_normal_maps,
                            rows=None if band is None else band.n)


def gbuffer_from_hit(ts: TraceScene, view: ViewConstants, hit, df,
                     width: int, height: int, no_normal_maps: bool = False,
                     rows: int | None = None):
    """Per-pixel Hit -> gbuffer dict; hit/df flat row-major over pixels
    (`rows` of the (height, width) frame, default all)."""
    spread = 0.3 * 2.0 / (view.view_to_clip[1, 1] * height)
    cone_w = spread * torch.where(hit.hit_mask, hit.t, 0.0)
    attrs = hit_attributes(ts, hit, df, no_normal_maps=no_normal_maps,
                           with_prev_pos=True, cone_width=cone_w)
    m = hit.hit_mask
    mc = m[:, None]
    pos = attrs["pos"]

    # reversed-infinite-Z depth from view-space z
    vpos = _project(view.world_to_view, pos)[..., :3]
    near = view.view_to_clip[2, 3]
    depth = torch.where(m, near / torch.clamp(-vpos[..., 2], min=1e-8), 0.0)

    clip_cur = _project(view.world_to_clip, pos)
    clip_prev = _project(view.world_to_clip_prev, attrs["pos_prev"])
    ndc_cur = clip_cur[..., :2] / torch.clamp(clip_cur[..., 3:4], min=1e-8)
    ndc_prev = clip_prev[..., :2] / torch.clamp(clip_prev[..., 3:4], min=1e-8)
    uv_cur = torch.stack([0.5 + 0.5 * ndc_cur[..., 0],
                          0.5 - 0.5 * ndc_cur[..., 1]], -1)
    uv_prev = torch.stack([0.5 + 0.5 * ndc_prev[..., 0],
                           0.5 - 0.5 * ndc_prev[..., 1]], -1)
    velocity = torch.where(mc, uv_prev - uv_cur, 0.0)

    def r(x):
        return x.reshape((height if rows is None else rows, width)
                         + tuple(x.shape[1:]))

    return {
        "depth": r(depth),
        "normal": r(torch.where(mc, attrs["normal"], 0.0)),
        "geo_normal": r(torch.where(mc, attrs["geo_normal"], 0.0)),
        "albedo": r(torch.where(mc, attrs["base_color"], 0.0)),
        "metallic": r(torch.where(m, attrs["metallic"], 0.0)),
        "roughness": r(torch.where(m, attrs["roughness"], 1.0)),
        "emissive": r(torch.where(mc, attrs["emissive"], 0.0)),
        "velocity": r(velocity),
        "pos": r(torch.where(mc, pos, 0.0)),
        "hit": r(m),
        "ray_dir": r(df),
    }


def gbuffer_view_z(gb, near: float = 0.01):
    """Positive view-space distance per pixel; 1e8 for sky."""
    return torch.where(gb["hit"], near / torch.clamp(gb["depth"], min=1e-12),
                       1e8)
