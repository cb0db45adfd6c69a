"""Deferred lighting: gbuffer + shadow + GI terms -> lit radiance (port of
`kajiya_tpu/renderers/deferred.py`)."""
from __future__ import annotations

import torch

from ..brdf import ggx
from ..ops.smallvec import dot3

DEBUG_MODES = (
    "none", "albedo", "normal", "geo_normal", "roughness", "metallic",
    "emissive", "depth", "shadow", "diffuse_gi", "reflections", "velocity",
    "ssao",
)


def light_gbuffer(gb, sun_shadow_mask, diffuse_gi, reflections, sky_bg,
                  sun_radiance, sun_direction, ssao=None, debug_mode="none"):
    """All inputs (H, W[,C]); returns lit radiance (H, W, 3)."""
    n = gb["normal"]
    wo = -gb["ray_dir"]
    albedo = gb["albedo"]
    metallic = gb["metallic"]
    rough = gb["roughness"]
    diffuse_albedo, f0 = ggx.derive_lobes(albedo, metallic)

    ndotl = torch.clamp(dot3(n, sun_direction), min=0.0)
    f_sun = ggx.eval_layered(albedo, metallic, rough, n, wo,
                             sun_direction.expand(n.shape))
    direct = f_sun * sun_radiance * (ndotl * sun_shadow_mask)[..., None]
    indirect_d = diffuse_albedo * diffuse_gi
    ndotv = torch.clamp(torch.sum(n * wo, dim=-1), 1e-4, 1.0)
    indirect_s = reflections * ggx.preintegrated_specular(f0, rough, ndotv)
    lit = direct + indirect_d + indirect_s + gb["emissive"]
    out = torch.where(gb["hit"][..., None], lit, sky_bg)
    if debug_mode == "none":
        return out
    return _debug_view(gb, sun_shadow_mask, diffuse_gi, reflections, ssao,
                       debug_mode, out)


def _debug_view(gb, shadow, dgi, refl, ssao, mode, lit):
    def rep(x):
        return x[..., None].expand(x.shape + (3,))

    if mode in ("albedo", "emissive"):
        return gb["albedo" if mode == "albedo" else "emissive"]
    if mode in ("normal", "geo_normal"):
        return gb[mode] * 0.5 + 0.5
    if mode in ("roughness", "metallic", "depth"):
        return rep(gb[mode])
    if mode == "shadow":
        return rep(shadow)
    if mode == "diffuse_gi":
        return dgi
    if mode == "reflections":
        return refl
    if mode == "velocity":
        v = gb["velocity"]
        return torch.stack([torch.abs(v[..., 0]) * 10,
                            torch.abs(v[..., 1]) * 10,
                            torch.zeros_like(v[..., 0])], -1)
    if mode == "ssao" and ssao is not None:
        return rep(ssao)
    return lit
