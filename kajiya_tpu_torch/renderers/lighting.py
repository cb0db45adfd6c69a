"""Triangle-light specular sampling: direct specular from emissive meshes
(port of `kajiya_tpu/renderers/lighting.py`).

Reflection rays rarely hit small emitters, so the specular highlights of
mesh lights are sampled explicitly at half res with shadow rays, spatially
reused by a small blur, and added into the reflection stream before its
temporal and spatial filtering. With a row `band` (parallel/), the RNG
takes screen rows and the blur its halo rows.
"""
from __future__ import annotations

import torch

from ..brdf import ggx
from ..core import img as im
from ..core import rng as rng_mod
from ..ops.smallvec import dot3
from ..rt.trace import scene_trace_shadow
from .lights import sample_triangle_light

RAY_EPS = 1e-4
N_SAMPLES = 2      # ~ the reference's 3 sample layers


def sample_lights_specular(ts, gb, frame_idx, max_trace_steps=None,
                           band=None):
    """Half-res explicit specular from emissive triangles -> (hh, hw, 3):
    N_SAMPLES light samples, each with a shadow ray, then a 5-tap blur.
    Lanes are masked where the scene has no lights. `band`: gb's row band
    (parallel/)."""
    pos = im.decimate2(gb["pos"])
    n = im.decimate2(gb["normal"])
    gn = im.decimate2(gb["geo_normal"])
    rough = im.decimate2(gb["roughness"])
    metal = im.decimate2(gb["metallic"])
    albedo = im.decimate2(gb["albedo"])
    hitm = im.decimate2(gb["hit"])
    rd = im.decimate2(gb["ray_dir"])
    hh, hw = hitm.shape
    dev = hitm.device

    posf = pos.reshape(-1, 3)
    nf = n.reshape(-1, 3)
    gnf = gn.reshape(-1, 3)
    wo = -rd.reshape(-1, 3)
    base = albedo.reshape(-1, 3)
    mt = metal.reshape(-1)
    rg = rough.reshape(-1)
    hm = hitm.reshape(-1)

    hb = None if band is None else band.half()
    y0 = 0 if hb is None else hb.y0
    px = torch.arange(y0 * hw, (y0 + hh) * hw, dtype=torch.int64, device=dev)
    rng = rng_mod.pixel_rng(px % hw, px // hw, frame_idx, stream=53)

    acc = torch.zeros((hh * hw, 3), dtype=torch.float32, device=dev)
    for _ in range(N_SAMPLES):
        ls, rng = sample_triangle_light(ts, posf, rng)
        cos_g = dot3(nf, ls["wi"])
        possible = hm & ls["valid"] & (cos_g > 0.0)
        occ = scene_trace_shadow(
            ts, posf + gnf * RAY_EPS * 8, ls["wi"],
            t_min=RAY_EPS, t_max=ls["dist"] - RAY_EPS * 10,
            max_steps=max_trace_steps)
        _albedo, f0 = ggx.derive_lobes(base, mt)
        f_spec, _pdf = ggx.specular_brdf(f0, rg, nf, wo, ls["wi"])
        contrib = (f_spec * ls["emission"]
                   * (torch.clamp(cos_g, min=0.0)
                      / torch.clamp(ls["pdf_sa"], min=1e-9))[:, None])
        acc = acc + torch.where((possible & ~occ)[:, None], contrib, 0.0)
    out = (acc / N_SAMPLES).reshape(hh, hw, 3)
    # spatial reuse: a small blur at half res
    return im.separable_blur(out, im.GAUSS5, hb)
