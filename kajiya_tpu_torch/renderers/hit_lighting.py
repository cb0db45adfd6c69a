"""Secondary-hit radiance: lighting at GI / reflection ray hit points (port
of `kajiya_tpu/renderers/hit_lighting.py`).

At each secondary hit: emissive + sun NEE (one shadow ray) + emissive
triangle NEE + ambient (the irradiance cache where the frame runs one, else
the convolved sky) + screen-space reuse of last frame's lit image when the hit point is on
screen (the temporal feedback that makes GI multi-bounce), and the world
radiance cache for far-field hits when the frame traces one. On a miss: the
sky.
"""
from __future__ import annotations

import math

import torch

from ..brdf import ggx
from ..core import img as im
from ..core.profiling import pass_scope
from ..ops.smallvec import dot3, matvec
from ..rt.trace import scene_trace_shadow
from ..sky.env import sample_env
from ..world import hit_attributes

RAY_EPS = 1e-4


def _project_to_uv(world_to_clip, p):
    clip = matvec(world_to_clip[:, :3], p) + world_to_clip[:, 3]
    w = torch.clamp(clip[..., 3:4], min=1e-8)
    ndc = clip[..., :2] / w
    uv = torch.stack([0.5 + 0.5 * ndc[..., 0], 0.5 - 0.5 * ndc[..., 1]], -1)
    in_front = clip[..., 3] > 1e-6
    inb = ((uv[..., 0] > 0.0) & (uv[..., 0] < 1.0)
           & (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0) & in_front)
    return uv, inb


def hit_radiance(ts, hit, ray_dir, sky_env, diffuse_env,
                 prev_lit=None, prev_depth=None, view=None,
                 ircache_lookup=None, max_trace_steps=None, near: float = 0.01,
                 rng=None, light_nee: bool = True,
                 full_shading: bool = False, return_aux: bool = False,
                 wrc_lookup=None, wrc_min_t: float = 20.0,
                 cone_width0=None, cone_spread: float = 0.033):
    """Radiance arriving along `ray_dir` from hit / miss points. (R,) rays.

    prev_lit / prev_depth + view enable screen-space radiance reuse. When
    `rng` ((R,) seed lattice) is given, one NEE sample of the emissive
    triangles + its shadow ray is added. full_shading interpolates vertex
    attributes at the hit; False takes the face normal.
    `ircache_lookup(pos, normal) -> E/pi` supplies the ambient term;
    `wrc_lookup(pos, dir) -> radiance` (the world radiance cache) replaces
    the shade of hits farther than `wrc_min_t`."""
    m = hit.hit_mask
    # secondary ray cone: width at the hit = width at the origin + spread * t
    cw = cone_spread * torch.where(m, hit.t, 1.0)
    if cone_width0 is not None:
        cw = cw + cone_width0
    with pass_scope("attrs"):
        attrs = hit_attributes(ts, hit, ray_dir, cone_width=cw,
                               full_shading=full_shading)
    pos, n = attrs["pos"], attrs["normal"]

    # --- sun direct at the hit (one shadow ray). Hit points scatter across
    # the scene: sort=True re-buckets the divergent shadow batch
    sun_dir = ts.gpu.sun_direction.expand(pos.shape)
    cos_s = torch.clamp(dot3(n, sun_dir), min=0.0)
    with pass_scope("sun_nee"):
        occ = scene_trace_shadow(
            ts, pos + attrs["geo_normal"] * RAY_EPS * 8, sun_dir,
            t_min=RAY_EPS, max_steps=max_trace_steps, sort=True)
    sun_vis = torch.where(m & ~occ, cos_s, 0.0)
    albedo, _f0 = ggx.derive_lobes(attrs["base_color"], attrs["metallic"])
    direct = albedo / math.pi * ts.gpu.sun_radiance * sun_vis[:, None]

    # --- emissive triangle NEE (diffuse-only at secondary hits)
    if light_nee and rng is not None:
        from .lights import sample_triangle_light

        ls, rng = sample_triangle_light(ts, pos, rng)
        cos_g = dot3(n, ls["wi"])
        possible = m & ls["valid"] & (cos_g > 0.0)
        with pass_scope("light_nee"):
            occ_l = scene_trace_shadow(
                ts, pos + attrs["geo_normal"] * RAY_EPS * 8, ls["wi"],
                t_min=RAY_EPS, t_max=ls["dist"] - RAY_EPS * 10,
                max_steps=max_trace_steps, sort=True)
        contrib = (albedo / math.pi * ls["emission"]
                   * (torch.clamp(cos_g, min=0.0)
                      / torch.clamp(ls["pdf_sa"], min=1e-9))[:, None])
        direct = direct + torch.where((possible & ~occ_l)[:, None], contrib,
                                      0.0)

    # --- ambient: irradiance cache (preferred) or the convolved sky
    with pass_scope("ambient"):
        if ircache_lookup is not None:
            amb_irr = ircache_lookup(pos, n)
        else:
            amb_irr = sample_env(diffuse_env, n)
    ambient = albedo * amb_irr

    radiance = attrs["emissive"] + direct + ambient

    # --- screen-space reuse of last frame's lit image
    if prev_lit is not None and view is not None and prev_depth is not None:
        uv, inb = _project_to_uv(view.world_to_clip_prev, pos)
        packed = torch.cat([prev_lit, prev_depth[..., None]], dim=-1)
        with pass_scope("screen_reuse"):
            fetched = im.sample_nearest(packed, uv)
        reused, pd = fetched[:, :3], fetched[:, 3]
        # depth check: is the stored surface the one we hit?
        wv = view.world_to_view_prev
        vz_expected = -(wv[2, 0] * pos[..., 0] + wv[2, 1] * pos[..., 1]
                        + wv[2, 2] * pos[..., 2] + wv[2, 3])
        vz_stored = near / torch.clamp(pd, min=1e-12)
        same = torch.abs(vz_stored / torch.clamp(vz_expected, min=1e-6)
                         - 1.0) < 0.05
        use = (inb & same & m & (pd > 0))[:, None]
        radiance = torch.where(use, reused, radiance)

    # --- world radiance cache for far-field hits: beyond `wrc_min_t` the
    # probe grid's radiance replaces the full shade
    if wrc_lookup is not None:
        far = m & (hit.t > wrc_min_t)
        radiance = torch.where(far[:, None], wrc_lookup(pos, ray_dir),
                               radiance)

    # --- miss: sky
    sky = sample_env(sky_env, ray_dir)
    out = torch.where(m[:, None], radiance, sky)
    if return_aux:
        # reconnection data for ReSTIR reuse: hit point + hit normal
        return out, {"hit_pos": pos, "hit_geo_normal": attrs["geo_normal"]}
    return out
