"""Emissive triangle light sampling (NEE), shared by the GI hit lighting and
the passes still to come (port of `kajiya_tpu/renderers/lights.py`)."""
from __future__ import annotations

import torch

from ..brdf.sampling import uniform_triangle
from ..core import rng as rng_mod
from ..ops import smallvec as smv


def sample_triangle_light(ts, pos, rng):
    """Pick one emissive triangle + point on it, uniformly over lights.

    pos: (R, 3) shading points. Returns (dict(wi, dist, pdf_sa, emission,
    valid), rng'). pdf_sa is the solid-angle pdf including light selection.
    """
    n_lights = torch.clamp(ts.gpu.num_lights, min=1)
    u_l, rng = rng_mod.rand_u01(rng)
    li = torch.minimum((u_l * n_lights).to(torch.int64), n_lights - 1)
    u1, rng = rng_mod.rand_u01(rng)
    u2, rng = rng_mod.rand_u01(rng)
    b1, b2 = uniform_triangle(u1, u2)
    lv0, le1, le2 = ts.light_v0[li], ts.light_e1[li], ts.light_e2[li]
    l_n = ts.light_normal[li]
    emission = ts.light_emission[li]
    area = ts.light_area[li]
    lp = lv0 + le1 * b1[:, None] + le2 * b2[:, None]

    to_l = lp - pos
    dist2 = smv.dot3(to_l, to_l)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    wi = to_l / dist[:, None]
    cos_l = torch.abs(smv.dot3(l_n, wi))   # double-sided emitters
    pdf_sa = dist2 / torch.clamp(
        cos_l * area * n_lights.to(torch.float32), min=1e-9)
    valid = (ts.gpu.num_lights > 0) & (area > 0.0) & (cos_l > 1e-6)
    return dict(wi=wi, dist=dist, pdf_sa=pdf_sa, emission=emission,
                valid=valid), rng


def light_pdf_for_hit(ts, hit, wi):
    """Solid-angle pdf NEE would assign to a BRDF-sampled emissive hit (for
    MIS). hit.tri indexes global triangles."""
    n_lights = torch.clamp(ts.gpu.num_lights, min=1).to(torch.float32)
    matches = ts.gpu.light_tri[None, :] == hit.tri[:, None]     # (R, L)
    is_light = matches.any(dim=-1)
    area = torch.where(matches, ts.light_area[None, :], 0.0).sum(dim=-1)
    tri = torch.clamp(hit.tri, min=0).long()
    l_cross = smv.cross(ts.e1[tri], ts.e2[tri])
    l_n = l_cross * (1.0 / torch.clamp(smv.norm3(l_cross),
                                       min=1e-12))[:, None]
    cos_l = torch.abs(smv.dot3(l_n, wi))
    dist2 = hit.t * hit.t
    pdf = dist2 / torch.clamp(cos_l * area * n_lights, min=1e-9)
    return torch.where(is_light & (area > 0), pdf, 0.0)
