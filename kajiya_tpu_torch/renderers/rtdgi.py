"""RTDGI: ray-traced diffuse final gather (half-res) with temporal reuse
(port of `kajiya_tpu/renderers/rtdgi.py`).

Trace half-res cosine-hemisphere candidate rays, light the hits
(hit_lighting.py), exchange them through the ReSTIR reservoirs
(restir_gi.py) or blur them, resolve to full resolution steered by depth and
normal, and accumulate temporally. Output = incident diffuse irradiance / pi
("E/pi"), multiplied by the diffuse albedo in the deferred combine.
With a row `band` (parallel/), the planes are the band's: the RNG and blue
noise take screen rows, the stencils their halo rows and the temporal fetch
a gathered history.
"""
from __future__ import annotations

import torch

from ..brdf.sampling import cosine_hemisphere, to_world
from ..core import bluenoise
from ..core import img as im
from ..core import rng as rng_mod
from ..core.profiling import pass_scope
from ..ops.smallvec import dot3, pow8
from ..rt.trace import scene_trace_closest
from .hit_lighting import hit_radiance
from .reprojection import reproject_planes

RAY_EPS = 1e-4
SKY_DIST = 1e4      # virtual hit distance for sky misses (reconnection)


def init_state(h: int, w: int, device=None):
    return {
        "rtdgi_history": torch.zeros((h, w, 3), dtype=torch.float32,
                                     device=device),
        "rtdgi_hist_len": torch.zeros((h, w), dtype=torch.float32,
                                      device=device),
    }


def half_gbuffer(gb):
    return {
        "pos": im.decimate2(gb["pos"]),
        "normal": im.decimate2(gb["normal"]),
        "geo_normal": im.decimate2(gb["geo_normal"]),
        "hit": im.decimate2(gb["hit"]),
        "depth": im.decimate2(gb["depth"]),
    }


def candidate_rays(gb_h, frame_idx, band=None):
    """Half-res candidate ray batch: one blue-noise cosine ray per half-res
    pixel. Returns (org, wi, rng) flat; the frame batches these into the
    shared secondary trace + shade wavefront. `band`: gb_h's (half-res)."""
    hh, hw = gb_h["hit"].shape
    dev = gb_h["hit"].device
    y0 = 0 if band is None else band.y0
    px = torch.arange(y0 * hw, (y0 + hh) * hw, dtype=torch.int64, device=dev)
    rng = rng_mod.pixel_rng(px % hw, px // hw, frame_idx, stream=23)
    bu1, bu2 = bluenoise.blue_noise_pair(hh, hw, frame_idx, stream=1,
                                         device=dev, y0=y0)
    u1 = bu1.reshape(-1)
    u2 = bu2.reshape(-1)

    n = gb_h["normal"].reshape(-1, 3)
    gn = gb_h["geo_normal"].reshape(-1, 3)
    pos = gb_h["pos"].reshape(-1, 3)
    wi = to_world(n, cosine_hemisphere(u1, u2))
    org = pos + gn * RAY_EPS * 8
    return org, wi, rng


def finish_candidates(gb_h, org, wi, hit_mask, hit_t, rad, aux):
    """Assemble the candidate dict from the shared wavefront's results."""
    hh, hw = gb_h["hit"].shape
    valid = gb_h["hit"].reshape(-1)
    # reconnection data: the real hit point (or a far virtual point for sky
    # misses, jacobian ~1 there) + the hit-surface normal
    m = hit_mask[:, None]
    hit_pos = torch.where(m, aux["hit_pos"], org + wi * SKY_DIST)
    hit_n = torch.where(m, aux["hit_geo_normal"], -wi)
    # the cosine-weighted estimator of E/pi is simply the sampled radiance
    return {
        "radiance": torch.where(valid[:, None], rad, 0.0).reshape(hh, hw, 3),
        "ray_dir": wi.reshape(hh, hw, 3),
        "ray_t": torch.clamp(hit_t, max=1e8).reshape(hh, hw),
        "hit_pos": hit_pos.reshape(hh, hw, 3),
        "hit_normal": hit_n.reshape(hh, hw, 3),
        "valid": valid.reshape(hh, hw),
    }


def trace_candidates(ts, gb_h, frame_idx, sky_env, diffuse_env,
                     prev_lit=None, prev_depth=None, view=None,
                     ircache_lookup=None, max_trace_steps=None,
                     secondary_full_shading: bool = False):
    """Standalone half-res candidate trace (tests / non-batched callers);
    the frame batches candidate_rays into one shared wavefront."""
    org, wi, rng = candidate_rays(gb_h, frame_idx)
    hit = scene_trace_closest(ts, org, wi, t_min=RAY_EPS,
                              max_steps=max_trace_steps)
    rad, aux = hit_radiance(ts, hit, wi, sky_env, diffuse_env,
                            prev_lit=prev_lit, prev_depth=prev_depth,
                            view=view, ircache_lookup=ircache_lookup,
                            max_trace_steps=max_trace_steps, rng=rng,
                            full_shading=secondary_full_shading,
                            return_aux=True)
    return finish_candidates(gb_h, org, wi, hit.hit_mask, hit.t, rad, aux)


def _edge_aware_upsample(half_img, gb, near: float = 0.01, band=None):
    """Half -> full resolve steered by depth + normal: joint-bilateral over
    the 4-tap footprint, phase by phase at half res, woven once at the end.
    `band`: gb's (full-res)."""
    hb = None if band is None else band.half()
    vz = near / torch.clamp(gb["depth"], min=1e-12)
    vz_h = near / torch.clamp(im.decimate2(gb["depth"]), min=1e-12)
    n_full = gb["normal"]
    n_h = im.decimate2(gb["normal"])

    # all 9 half-res shifts once (ky-1+py, kx-1+px ranges over -1..1)
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    v_s = im.shift_stack(half_img, offs, hb)
    z_s = im.shift_stack(vz_h, offs, hb)
    n_s = im.shift_stack(n_h, offs, hb)

    def idx(dy, dx):
        return (dy + 1) * 3 + (dx + 1)

    phases = {}
    for py in (0, 1):
        for px in (0, 1):
            vz_p = im.phase_extract(vz, py, px)
            n_p = im.phase_extract(n_full, py, px)
            acc = torch.zeros_like(v_s[0])
            accw = torch.zeros_like(vz_p)
            for ky in (0, 1):
                wy = (0.25, 0.75)[py] if ky == 0 else (0.75, 0.25)[py]
                for kx in (0, 1):
                    wx = (0.25, 0.75)[px] if kx == 0 else (0.75, 0.25)[px]
                    k = idx(ky - 1 + py, kx - 1 + px)
                    w_z = torch.exp(-torch.abs(z_s[k] - vz_p)
                                    / (0.05 * vz_p + 1e-4))
                    w_n = pow8(torch.clamp(dot3(n_s[k], n_p), min=0.0))
                    wt = wy * wx * w_z * w_n + 1e-6
                    acc = acc + v_s[k] * wt[..., None]
                    accw = accw + wt
            phases[(py, px)] = acc / accw[..., None]
    return im.weave2x2([[phases[(0, 0)], phases[(0, 1)]],
                        [phases[(1, 0)], phases[(1, 1)]]])


def rtdgi_pipeline(ts, gb, view, frame_idx, state, reproj, sky_env,
                   diffuse_env, ssao=None, prev_lit=None, prev_depth=None,
                   ircache_lookup=None, max_trace_steps=None,
                   use_restir: bool = True, restir_state=None,
                   secondary_full_shading: bool = False,
                   candidates=None, invalidity=None,
                   validated: bool = False, band=None):
    """Full chain -> (diffuse E/pi (H, W, 3), new_state, new_restir_state,
    candidates).

    candidates / invalidity: precomputed by the frame's shared secondary-ray
    wavefront; when absent, traced / validated here standalone. `validated`
    marks the reservoir state as already validated by the frame. `band`:
    gb's row band (parallel/); the frame passes the candidates then."""
    gb_h = half_gbuffer(gb)
    hb = None if band is None else band.half()
    if candidates is None:
        candidates = trace_candidates(
            ts, gb_h, frame_idx, sky_env, diffuse_env, prev_lit=prev_lit,
            prev_depth=prev_depth, view=view, ircache_lookup=ircache_lookup,
            max_trace_steps=max_trace_steps,
            secondary_full_shading=secondary_full_shading)

    if use_restir and restir_state is not None:
        from . import restir_gi

        # every-3rd-frame path validation: re-trace stored reservoir rays at
        # quarter res, replace / cut stale history before the temporal
        # exchange (one host read of the frame index)
        if not validated and invalidity is None:
            if int(frame_idx) % restir_gi.VALIDATE_PERIOD == 0:
                restir_state, invalidity = restir_gi.validate_reservoirs(
                    ts, restir_state, gb_h, sky_env, diffuse_env, frame_idx,
                    prev_lit=prev_lit, prev_depth=prev_depth, view=view,
                    ircache_lookup=ircache_lookup,
                    max_trace_steps=max_trace_steps,
                    secondary_full_shading=secondary_full_shading)
            else:
                invalidity = torch.zeros_like(restir_state["gi_res_w_sum"])

        with pass_scope("restir"):
            res, new_restir_state = restir_gi.restir_diffuse(
                restir_state, candidates, gb_h, reproj, frame_idx,
                ssao_h=None if ssao is None else im.decimate2(ssao),
                view=view, band=hb)
        # the near / far split is screen-space by construction (an 80 px
        # near-field window): below ~480 rows it would swallow whole test
        # scenes, so it engages only at real resolutions
        split = (gb["depth"].shape[0] if band is None else band.height) >= 480
        with pass_scope("resolve"):
            full = restir_gi.resolve(res, gb,
                                     candidates=candidates if split else None,
                                     ssao=ssao if split else None, band=band)
    else:
        new_restir_state = restir_state
        # spatial pre-filter at half res (the smoothing role of the ReSTIR
        # spatial passes for the plain path)
        rad_h = im.separable_blur(candidates["radiance"], im.GAUSS5, hb)
        full = _edge_aware_upsample(rad_h, gb, band=band)

    # temporal accumulation at full res
    with pass_scope("temporal"):
        fetched = reproject_planes(
            {"h": state["rtdgi_history"], "l": state["rtdgi_hist_len"]},
            reproj, band)
    hist = fetched["h"]
    hist_len = fetched["l"]
    hist_len = torch.clamp(hist_len * reproj["validity"] + 1.0, max=24.0)
    if invalidity is not None:
        # validation invalidity cuts the temporal filter's history: a
        # fully-invalidated pixel restarts accumulation instead of ghosting
        inv_full = invalidity.repeat_interleave(2, 0).repeat_interleave(2, 1)[
            :hist_len.shape[0], :hist_len.shape[1]]
        hist_len = torch.clamp(hist_len * (1.0 - inv_full), min=1.0)
    alpha = (1.0 / hist_len)[..., None]
    out = hist * (1 - alpha) + full * alpha

    # variance clamp against the spatial neighbourhood to cut ghosting; the
    # band includes a relative term so that a frame whose neighbourhood
    # missed the rare bright samples does not clip the converged history
    m1, var = im.local_moments_3x3(full, band)
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    clip = sigma * 3.0 + 0.15 * m1 + 1e-3
    out = torch.minimum(torch.maximum(out, m1 - clip), m1 + clip)

    new_state = {"rtdgi_history": out, "rtdgi_hist_len": hist_len}
    # candidates are also returned so that reflections can reuse the rays
    return out, new_state, new_restir_state, candidates
