"""Reference path tracer, the ground-truth oracle (port of
`kajiya_tpu/renderers/reference.py`).

Eye paths with a fixed bounce budget (default 16), russian roulette from
bounce 3, layered GGX BRDF sampling, sun NEE with a soft solar disk,
emissive-triangle NEE with BRDF hits combined by the power heuristic, the
atmosphere on a miss, progressive accumulation by the caller (`accumulate`).

The JAX module's `lax.scan` over bounces is a Python loop here, over a
wavefront of every pixel (no compaction: a boolean-mask index would make
the host wait for the card at every bounce). Lanes whose result is masked
away are traced with t_max = 0, which the intersector kernels skip: a path
that has ended, and a shadow ray whose light cannot count. Every output is
the same as tracing all lanes, as the JAX module does
(`tests/test_torch_reference_pt.py` holds the two bit for bit).
"""
from __future__ import annotations

import math

import torch

from ..brdf import ggx
from ..brdf.sampling import power_heuristic, to_world, uniform_cone
from ..core import rng as rng_mod
from ..core.camera import camera_rays
from ..core.profiling import pass_scope
from ..ops.smallvec import dot3
from ..ops.woop_cuda import INF
from ..rt.trace import scene_trace_closest, scene_trace_shadow
from ..sky.atmosphere import sky_radiance
from ..world import hit_attributes
from .lights import light_pdf_for_hit, sample_triangle_light

RAY_EPS = 1e-4
PIXEL_FILTER_SIGMA = 0.4    # gaussian pixel filter, like the reference PT


def _sample_sun(ts, rng):
    """Cone sample towards the sun disk. Returns (dir, rng')."""
    u1, rng = rng_mod.rand_u01(rng)
    u2, rng = rng_mod.rand_u01(rng)
    cos_max = torch.cos(ts.gpu.sun_angular_radius)
    local = uniform_cone(u1, u2, cos_max)
    d = to_world(ts.gpu.sun_direction.expand(local.shape), local)
    return d, rng


def _live_tmax(live, t_max):
    """Per-ray t_max with the lanes whose result is not used set to 0."""
    return torch.where(live, t_max, 0.0)


def path_trace(ts, org, d, seed, num_bounces: int = 16, rr_start: int = 3,
               sun_nee: bool = True, light_nee: bool = True,
               max_trace_steps=None, sky_fn=None, cone_spread=None):
    """Trace one path per input ray. org/d: (R, 3); seed: (R,) uint32
    lattice (int64). Returns radiance (R, 3), clipped to [0, 1e4].

    cone_spread: per-ray footprint angle for ray-cone texture LOD; the cone
    width at each hit is cone_spread * the path's length so far."""
    r = org.shape[0]
    dev = org.device
    tp = torch.ones((r, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    rng = seed
    act = torch.ones((r,), dtype=torch.bool, device=dev)
    # ~delta: camera rays get full emission
    prev_pdf = torch.full((r,), 1e8, dtype=torch.float32, device=dev)
    path_t = torch.zeros((r,), dtype=torch.float32, device=dev)

    for bounce_idx in range(num_bounces):
        # bounce wavefronts diverge after the first segment: sorted tracing
        # keeps the culled tracer's chunks beam-shaped (ops/raysort.py)
        with pass_scope("trace"):
            hit = scene_trace_closest(ts, org, d, t_min=RAY_EPS,
                                      t_max=_live_tmax(act, INF),
                                      max_steps=max_trace_steps, sort=True)
        m = hit.hit_mask & act

        # miss: the sky (or `sky_fn`)
        sky = (sky_radiance(d, ts.gpu.sun_direction) if sky_fn is None
               else sky_fn(d))
        radiance = radiance + torch.where((act & ~hit.hit_mask)[:, None],
                                          tp * sky, 0.0)

        path_t = path_t + torch.where(m, hit.t, 0.0)
        cw = None if cone_spread is None else cone_spread * path_t
        attrs = hit_attributes(ts, hit, d, cone_width=cw)
        pos, n = attrs["pos"], attrs["normal"]
        wo = -d
        org_shadow = pos + attrs["geo_normal"] * RAY_EPS * 4

        # emissive hit, MIS-weighted against NEE
        emit = attrs["emissive"]
        if light_nee:
            pdf_l = light_pdf_for_hit(ts, hit, d)
            w_mis = torch.where(pdf_l > 0.0,
                                power_heuristic(prev_pdf, pdf_l), 1.0)
        else:
            w_mis = torch.ones((r,), dtype=torch.float32, device=dev)
        radiance = radiance + torch.where(m[:, None],
                                          tp * emit * w_mis[:, None], 0.0)

        bc, metal, rough = (attrs["base_color"], attrs["metallic"],
                            attrs["roughness"])

        # sun NEE (soft disk; the pdf cancels against the disk radiance)
        if sun_nee:
            sun_dir, rng = _sample_sun(ts, rng)
            cos_s = dot3(n, sun_dir)
            sun_possible = m & (cos_s > 0.0)
            with pass_scope("sun_nee"):
                occ = scene_trace_shadow(
                    ts, org_shadow, sun_dir, t_min=RAY_EPS,
                    t_max=_live_tmax(sun_possible, INF),
                    max_steps=max_trace_steps, sort=True)
            f = ggx.eval_layered(bc, metal, rough, n, wo, sun_dir)
            contrib = (tp * f * ts.gpu.sun_radiance
                       * torch.clamp(cos_s, min=0.0)[:, None])
            radiance = radiance + torch.where(
                (sun_possible & ~occ)[:, None], contrib, 0.0)

        # emissive triangle NEE with MIS
        if light_nee:
            ls, rng = sample_triangle_light(ts, pos, rng)
            cos_s = torch.sum(n * ls["wi"], dim=-1)
            possible = m & ls["valid"] & (cos_s > 0.0)
            with pass_scope("light_nee"):
                occ = scene_trace_shadow(
                    ts, org_shadow, ls["wi"], t_min=RAY_EPS,
                    t_max=_live_tmax(possible, ls["dist"] - RAY_EPS * 10),
                    max_steps=max_trace_steps, sort=True)
            f = ggx.eval_layered(bc, metal, rough, n, wo, ls["wi"])
            pdf_b = ggx.pdf_layered(bc, metal, rough, n, wo, ls["wi"])
            w_l = power_heuristic(ls["pdf_sa"], pdf_b)
            contrib = (tp * f * ls["emission"]
                       * (torch.clamp(cos_s, min=0.0) * w_l
                          / torch.clamp(ls["pdf_sa"], min=1e-9))[:, None])
            radiance = radiance + torch.where((possible & ~occ)[:, None],
                                              contrib, 0.0)

        # continue the path: sample the layered BRDF
        ul, rng = rng_mod.rand_u01(rng)
        u1, rng = rng_mod.rand_u01(rng)
        u2, rng = rng_mod.rand_u01(rng)
        wi, pdf, f = ggx.sample_layered(bc, metal, rough, n, wo, ul, u1, u2)
        cos_i = torch.clamp(torch.sum(n * wi, dim=-1), min=0.0)
        tp_next = tp * f * (cos_i / torch.clamp(pdf, min=1e-9))[:, None]
        ok = m & (pdf > 1e-9) & (cos_i > 0.0)

        # russian roulette from bounce `rr_start`, as in the reference
        u_rr, rng = rng_mod.rand_u01(rng)
        survive = ok
        if bounce_idx >= rr_start:
            p_cont = torch.clamp(torch.amax(tp_next, dim=-1), 0.05, 1.0)
            survive = ok & (u_rr < p_cont)
            tp_next = tp_next / p_cont[:, None]

        okc = ok[:, None]
        org = torch.where(okc, org_shadow, org)
        d = torch.where(okc, wi, d)
        tp = torch.where(okc, tp_next, tp)
        act = survive
        prev_pdf = torch.where(ok, pdf, prev_pdf)

    # firefly suppression, cf. the reference's roughness-biasing intent
    return torch.clamp(radiance, 0.0, 1e4)


def render_sample(ts, view, width, height, frame_idx, spp_chunk: int = 1,
                  pixel_filter: bool = True, **pt_kwargs):
    """One progressive sample pass over the full frame -> (H, W, 3)
    radiance. Each sample traces through a fresh gaussian sub-pixel offset
    (the reference's per-sample jitter + gaussian pixel filter), so the
    converged image is antialiased ground truth. `frame_idx` may be a
    device tensor: the hashes read it on the device."""
    dev = view.device
    acc = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    px = torch.arange(width * height, dtype=torch.int64, device=dev)
    for s in range(spp_chunk):
        seed = rng_mod.hash3(px, frame_idx, s)
        if pixel_filter:
            u1, seed = rng_mod.rand_u01(seed)
            u2, seed = rng_mod.rand_u01(seed)
            # Box-Muller -> gaussian offsets in pixels
            rr = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
            ang = 2.0 * math.pi * u2
            jit = (torch.stack([rr * torch.cos(ang), rr * torch.sin(ang)],
                               dim=-1)
                   * PIXEL_FILTER_SIGMA).reshape(height, width, 2)
        else:
            jit = None
        org, d = camera_rays(view, width, height, jitter_px=jit)
        acc = acc + path_trace(ts, org.reshape(-1, 3), d.reshape(-1, 3),
                               seed, **pt_kwargs)
    return (acc / spp_chunk).reshape(height, width, 3)


def accumulate(accum, new_frame, sample_count):
    """Progressive accumulation (the `refpt.accum` temporal image).
    accum: (H, W, 3); returns the updated (accum, sample_count)."""
    total = sample_count + 1.0
    return accum + (new_frame - accum) / total, total
