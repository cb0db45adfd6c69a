"""Layered GGX + Lambert BRDF (port of the parts of `kajiya_tpu/brdf/ggx.py`
the ported passes use): eval, VNDF sampling and its pdf, the layered
mixture's sampling and pdf (the reference path tracer), split-sum energy
compensation through a polynomial fit of the integrated FG table,
metalness lobes, and the FG table itself (`fg_lut`)."""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..device import const_tensor, resolve_device
from ..ops.smallvec import cross, matmul_small
from ..ops.smallvec import dot3 as _dot
from .sampling import cosine_hemisphere, orthonormal_basis, to_world

MIN_ROUGHNESS = 1e-3


def f_schlick(f0, cos_theta):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0),
                                       5.0)


def ndf_ggx(a2, ndoth):
    d = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-12)


def g_smith_correlated(a2, ndotv, ndotl):
    lv = ndotl * torch.sqrt((ndotv - a2 * ndotv) * ndotv + a2)
    ll = ndotv * torch.sqrt((ndotl - a2 * ndotl) * ndotl + a2)
    return 0.5 / torch.clamp(lv + ll, min=1e-12)


def _g1_smith(a2, ndotx):
    return 2.0 * ndotx / torch.clamp(
        ndotx + torch.sqrt(a2 + (1.0 - a2) * ndotx * ndotx), min=1e-12)


def specular_brdf(f0, roughness, n, wo, wi):
    """GGX specular BRDF value (RGB) and its VNDF sampling pdf."""
    a = torch.clamp(roughness, min=MIN_ROUGHNESS) ** 2
    a2 = a * a
    h = wo + wi
    h = h * (1.0 / torch.clamp(torch.sqrt(torch.clamp(_dot(h, h), min=1e-24)),
                               min=1e-12))[..., None]
    ndoth = torch.clamp(_dot(n, h), 0.0, 1.0)
    ndotv = torch.clamp(_dot(n, wo), 1e-5, 1.0)
    ndotl = torch.clamp(_dot(n, wi), 0.0, 1.0)
    hdotv = torch.clamp(_dot(h, wo), 1e-5, 1.0)
    d = ndf_ggx(a2, ndoth)
    vis = g_smith_correlated(a2, ndotv, ndotl)
    f = f_schlick(f0, hdotv[..., None])
    brdf = f * (d * vis)[..., None]
    pdf = d * _g1_smith(a2, ndotv) / torch.clamp(4.0 * ndotv, min=1e-12)
    return brdf, pdf


def _normalize(v):
    return v * (1.0 / torch.clamp(torch.sqrt(torch.clamp(_dot(v, v),
                                                         min=1e-24)),
                                  min=1e-12))[..., None]


def sample_vndf(roughness, n, wo, u1, u2):
    """Sample a GGX half-vector with the visible-NDF method (Heitz 2018).
    Returns world-space wi (reflected wo); it may point below the surface."""
    a = torch.clamp(roughness, min=MIN_ROUGHNESS) ** 2
    t, b = orthonormal_basis(n)
    # wo in local space
    vo = torch.stack([_dot(wo, t), _dot(wo, b), _dot(wo, n)], dim=-1)
    vh = _normalize(torch.stack([a * vo[..., 0], a * vo[..., 1], vo[..., 2]],
                                dim=-1))
    # orthonormal frame around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    t1 = torch.where(
        (lensq > 1e-9)[..., None],
        torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                     torch.zeros_like(inv)], dim=-1),
        const_tensor((1.0, 0.0, 0.0), vh.device).expand(vh.shape))
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = t1 * p1[..., None] + t2 * p2[..., None] + vh * pz[..., None]
    # unstretch
    h_local = _normalize(torch.stack(
        [a * nh[..., 0], a * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)],
        dim=-1))
    h_world = (t * h_local[..., 0:1] + b * h_local[..., 1:2]
               + n * h_local[..., 2:3])
    return 2.0 * _dot(wo, h_world)[..., None] * h_world - wo


def pdf_vndf(roughness, n, wo, wi):
    """Solid-angle pdf of `sample_vndf` for direction wi:
    G1(wo) * D(h) / (4 * n.wo)."""
    a = torch.clamp(roughness, min=MIN_ROUGHNESS) ** 2
    a2 = a * a
    h = _normalize(wi + wo)
    ndotv = torch.clamp(_dot(n, wo), min=1e-6)
    ndoth = torch.clamp(_dot(n, h), 0.0, 1.0)
    d = ndf_ggx(a2, ndoth)
    g1 = _g1_smith(a2, ndotv)
    return torch.clamp(g1 * d / (4.0 * ndotv), min=1e-12)


_FG_RES = 64
_POLY_DEG = 5
_FG_POLY_ROWS = None    # (n_feats, 2) float32 values as tuples, fitted once


def _compute_fg_lut():
    """(R, V, 2) split-sum (scale, bias) table for F0: integral of GGX."""
    res = _FG_RES
    n_samples = 256
    rough = (np.arange(res) + 0.5) / res
    ndotv = (np.arange(res) + 0.5) / res
    out = np.zeros((res, res, 2), np.float32)
    i = np.arange(n_samples)
    u1 = (i + 0.5) / n_samples
    u2 = (i * 0.6180339887498949) % 1.0
    for ri, r in enumerate(rough):
        a = max(r, MIN_ROUGHNESS) ** 2
        a2 = a * a
        cos_h = np.sqrt((1.0 - u1) / (1.0 + (a2 - 1.0) * u1))
        sin_h = np.sqrt(np.maximum(0.0, 1.0 - cos_h**2))
        phi = 2.0 * np.pi * u2
        h = np.stack([sin_h * np.cos(phi), sin_h * np.sin(phi), cos_h], -1)
        for vi, nv in enumerate(ndotv):
            v = np.array([np.sqrt(max(0.0, 1 - nv * nv)), 0.0, nv])
            l = 2.0 * (h @ v)[:, None] * h - v
            nl = np.clip(l[:, 2], 0, 1)
            nh = np.clip(h[:, 2], 0, 1)
            vh = np.clip(h @ v, 1e-5, 1)
            mask = nl > 0
            g1l = 2 * nl / np.maximum(nl + np.sqrt(a2 + (1 - a2) * nl * nl), 1e-9)
            g1v = 2 * nv / np.maximum(nv + np.sqrt(a2 + (1 - a2) * nv * nv), 1e-9)
            g_vis = g1l * g1v * vh / np.maximum(nh * nv, 1e-9)
            fc = (1.0 - vh) ** 5
            out[ri, vi, 0] = np.sum(np.where(mask, (1 - fc) * g_vis, 0)) / n_samples
            out[ri, vi, 1] = np.sum(np.where(mask, fc * g_vis, 0)) / n_samples
    return out


@lru_cache(maxsize=1)
def _fg_lut_host() -> np.ndarray:
    return _compute_fg_lut()


def fg_lut(device=None):
    """The (64, 64, 2) split-sum table, computed once on the host and
    returned on `device` (default CUDA)."""
    return torch.as_tensor(_fg_lut_host(), device=resolve_device(device))


def _fit_fg_poly():
    """Least-squares polynomial fit of the FG table over (roughness, ndotv)."""
    lut = _fg_lut_host()
    res = lut.shape[0]
    r = (np.arange(res) + 0.5) / res
    rr, vv = np.meshgrid(r, r, indexing="ij")
    rf, vf = rr.ravel(), vv.ravel()
    feats = np.stack([rf ** i * vf ** j
                      for i in range(_POLY_DEG + 1)
                      for j in range(_POLY_DEG + 1 - i)], axis=-1)
    coef, *_ = np.linalg.lstsq(feats, lut.reshape(-1, 2), rcond=None)
    return coef.astype(np.float32)


def _poly_features(r, v):
    rp = [torch.ones_like(r)]
    vp = [torch.ones_like(v)]
    for _ in range(_POLY_DEG):
        rp.append(rp[-1] * r)
        vp.append(vp[-1] * v)
    return torch.stack([rp[i] * vp[j]
                        for i in range(_POLY_DEG + 1)
                        for j in range(_POLY_DEG + 1 - i)], dim=-1)


def env_brdf_approx(roughness, ndotv):
    """(scale, bias) of the split-sum env BRDF via the polynomial fit."""
    global _FG_POLY_ROWS
    if _FG_POLY_ROWS is None:
        _FG_POLY_ROWS = tuple(tuple(r) for r in _fit_fg_poly().tolist())
    c = const_tensor(_FG_POLY_ROWS, roughness.device)
    feats = _poly_features(torch.clamp(roughness, 0.0, 1.0),
                           torch.clamp(ndotv, 0.0, 1.0))
    out = matmul_small(feats, c)
    return out[..., 0], out[..., 1]


def preintegrated_specular(f0, roughness, ndotv, use_lut: bool = False):
    """Split-sum specular reflectance E[f_spec] for (f0, roughness, ndotv):
    the polynomial fit by default, or with `use_lut` a bilinear lookup in
    the integrated table (`fg_lut`) that the fit approximates."""
    if not use_lut:
        scale, bias = env_brdf_approx(roughness, ndotv)
        return f0 * scale[..., None] + bias[..., None]
    lut = fg_lut(roughness.device)
    ri = torch.clamp(roughness * _FG_RES - 0.5, 0, _FG_RES - 1)
    vi = torch.clamp(ndotv * _FG_RES - 0.5, 0, _FG_RES - 1)
    r0 = torch.floor(ri).to(torch.int64)
    v0 = torch.floor(vi).to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=_FG_RES - 1)
    v1 = torch.clamp(v0 + 1, max=_FG_RES - 1)
    fr, fv = (ri - r0)[..., None], (vi - v0)[..., None]
    sb = (lut[r0, v0] * (1 - fr) * (1 - fv) + lut[r1, v0] * fr * (1 - fv)
          + lut[r0, v1] * (1 - fr) * fv + lut[r1, v1] * fr * fv)
    return f0 * sb[..., 0:1] + sb[..., 1:2]


def derive_lobes(base_color, metallic):
    """Diffuse albedo and F0 from the metalness workflow."""
    albedo = base_color * (1.0 - metallic[..., None])
    f0 = 0.04 * (1.0 - metallic[..., None]) + base_color * metallic[..., None]
    return albedo, f0


def eval_layered(base_color, metallic, roughness, n, wo, wi):
    """Full layered BRDF value (RGB). Zero below the horizon."""
    albedo, f0 = derive_lobes(base_color, metallic)
    ndotl = _dot(n, wi)
    ndotv = _dot(n, wo)
    spec, _ = specular_brdf(f0, roughness, n, wo, wi)
    e_ss = preintegrated_specular(f0, roughness, torch.clamp(ndotv, 1e-5, 1.0))
    spec = spec * (1.0 + f0 * (1.0 / torch.clamp(e_ss, 1e-3, 1.0) - 1.0))
    kd = 1.0 - f_schlick(f0, torch.clamp(ndotv, 0.0, 1.0)[..., None])
    diff = albedo * kd / math.pi
    valid = ((ndotl > 0.0) & (ndotv > 0.0))[..., None]
    return torch.where(valid, spec + diff, 0.0)


def pdf_layered(base_color, metallic, roughness, n, wo, wi):
    """Mixture pdf matching `sample_layered`'s lobe selection."""
    albedo, f0 = derive_lobes(base_color, metallic)
    p_spec = _lobe_spec_prob(albedo, f0)
    ndotl = torch.clamp(_dot(n, wi), 0.0, 1.0)
    _, pdf_s = specular_brdf(f0, roughness, n, wo, wi)
    pdf_d = ndotl / math.pi
    return p_spec * pdf_s + (1.0 - p_spec) * pdf_d


def _lobe_spec_prob(albedo, f0):
    ls = torch.mean(f0, dim=-1)
    ld = torch.mean(albedo, dim=-1)
    return torch.clamp(ls / torch.clamp(ls + ld, min=1e-6), 0.05, 0.95)


def sample_layered(base_color, metallic, roughness, n, wo, u_lobe, u1, u2):
    """Sample the layered BRDF. Returns (wi, pdf, brdf_value); samples
    below the horizon get pdf 0 and value 0."""
    albedo, f0 = derive_lobes(base_color, metallic)
    p_spec = _lobe_spec_prob(albedo, f0)
    wi_spec = sample_vndf(roughness, n, wo, u1, u2)
    wi_diff = to_world(n, cosine_hemisphere(u1, u2))
    take_spec = (u_lobe < p_spec)[..., None]
    wi = _normalize(torch.where(take_spec, wi_spec, wi_diff))
    pdf = pdf_layered(base_color, metallic, roughness, n, wo, wi)
    val = eval_layered(base_color, metallic, roughness, n, wo, wi)
    ok = _dot(n, wi) > 1e-5
    return wi, torch.where(ok, pdf, 0.0), torch.where(ok[..., None], val, 0.0)
