"""Procedural atmosphere: single-scattering Rayleigh + Mie ray march (port
of `kajiya_tpu/sky/atmosphere.py`). The sun disk is not part of
`sky_radiance`; direct sun is shaded explicitly."""
from __future__ import annotations

import math

import torch

from ..device import const_tensor
from ..ops.smallvec import dot3

EARTH_RADIUS = 6_360e3
ATMO_RADIUS = 6_420e3
H_RAYLEIGH = 8_500.0
H_MIE = 1_200.0
BETA_RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
BETA_MIE = (3.996e-6, 3.996e-6, 3.996e-6)
BETA_MIE_ABS = (4.4e-6, 4.4e-6, 4.4e-6)
MIE_G = 0.8
SUN_INTENSITY = 20.0


def _vec(x, ref):
    return const_tensor(x, ref.device)


def _ray_sphere_exit(origin_h, mu):
    b = origin_h * mu
    c = origin_h * origin_h - ATMO_RADIUS * ATMO_RADIUS
    disc = torch.clamp(b * b - c, min=0.0)
    return -b + torch.sqrt(disc)


def _densities(h):
    h = torch.clamp(h, min=0.0)
    return torch.exp(-h / H_RAYLEIGH), torch.exp(-h / H_MIE)


def _phase_rayleigh(c):
    return 3.0 / (16.0 * math.pi) * (1.0 + c * c)


def _phase_mie(c, g=MIE_G):
    g2 = g * g
    return (3.0 / (8.0 * math.pi)) * ((1.0 - g2) * (1.0 + c * c)) / (
        (2.0 + g2) * torch.pow(1.0 + g2 - 2.0 * g * c, 1.5))


def _optical_depth_to_sun(pos_r, mu_s, steps: int = 4):
    dist = _ray_sphere_exit(pos_r, mu_s)
    ds = dist / steps
    t = (torch.arange(steps, dtype=torch.float32, device=pos_r.device)
         + 0.5) * ds[..., None]
    h = torch.sqrt(torch.clamp(
        pos_r[..., None] ** 2 + t * t + 2.0 * pos_r[..., None] * t
        * mu_s[..., None], min=1.0)) - EARTH_RADIUS
    dr, dm = _densities(h)
    return (dr * ds[..., None]).sum(-1), (dm * ds[..., None]).sum(-1)


def sky_radiance(direction, sun_direction, altitude: float = 200.0,
                 steps: int = 12):
    """In-scattered sky radiance (RGB) for unit view directions (..., 3);
    sun_direction (3,) unit, towards the sun."""
    d = direction
    r0 = EARTH_RADIUS + altitude
    mu = torch.clamp(d[..., 1], -1.0, 1.0)
    dist = _ray_sphere_exit(torch.full_like(mu, r0), torch.clamp(mu, min=-0.03))
    ds = dist / steps
    cos_sun = dot3(d, sun_direction)
    ph_r = _phase_rayleigh(cos_sun)[..., None]
    ph_m = _phase_mie(cos_sun)[..., None]
    mu_s = sun_direction[1]
    beta_r = _vec(BETA_RAYLEIGH, d)
    beta_m = _vec(BETA_MIE, d)
    beta_ma = _vec(BETA_MIE_ABS, d)

    shape = d.shape[:-1]
    accum_r = d.new_zeros(shape + (3,))
    accum_m = d.new_zeros(shape + (3,))
    od_r = d.new_zeros(shape)
    od_m = d.new_zeros(shape)
    for i in range(steps):
        t = (float(i) + 0.5) * ds
        r = torch.sqrt(torch.clamp(r0 * r0 + t * t + 2.0 * r0 * t * mu,
                                   min=1.0))
        h = r - EARTH_RADIUS
        dr, dm = _densities(h)
        od_r = od_r + dr * ds
        od_m = od_m + dm * ds
        sr, sm = _optical_depth_to_sun(r, mu_s.expand(r.shape))
        tau = (beta_r * (od_r + sr)[..., None]
               + (beta_m + beta_ma) * (od_m + sm)[..., None])
        trans = torch.exp(-tau)
        accum_r = accum_r + trans * (dr * ds)[..., None]
        accum_m = accum_m + trans * (dm * ds)[..., None]

    radiance = SUN_INTENSITY * (accum_r * beta_r * ph_r
                                + accum_m * beta_m * ph_m)
    below = torch.clamp(-mu * 20.0, 0.0, 1.0)[..., None]
    return radiance * (1.0 - 0.9 * below)


def atmosphere_sun_transmittance(sun_direction, altitude: float = 200.0):
    """Transmittance of direct sunlight to the ground (tints the sun at
    dusk): (..., 3) for sun directions (..., 3)."""
    mu_s = torch.clamp(sun_direction[..., 1], -1.0, 1.0)
    sr, sm = _optical_depth_to_sun(
        torch.full_like(mu_s, EARTH_RADIUS + altitude), mu_s, steps=8)
    tau = (_vec(BETA_RAYLEIGH, mu_s) * sr[..., None]
           + (_vec(BETA_MIE, mu_s) + _vec(BETA_MIE_ABS, mu_s))
           * sm[..., None])
    return torch.exp(-tau) * torch.clamp(mu_s * 10.0 + 0.1, 0.0,
                                         1.0)[..., None]
