"""Sampling primitives (port of `kajiya_tpu/brdf/sampling.py`)."""
from __future__ import annotations

import math

import torch


def orthonormal_basis(n):
    """Branchless ONB from a unit normal (Duff et al. 2017). Returns (t, b)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]],
                    dim=-1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(n, v_local):
    """Local (tangent-space, +Z = n) direction -> world."""
    t, b = orthonormal_basis(n)
    return (t * v_local[..., 0:1] + b * v_local[..., 1:2]
            + n * v_local[..., 2:3])


def cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere sample in local space (+Z up). pdf = cos/pi."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_cone(u1, u2, cos_theta_max):
    """Uniform direction in a cone around +Z."""
    cos_t = 1.0 - u1 * (1.0 - cos_theta_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def uniform_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_triangle(u1, u2):
    """Uniform barycentrics on a triangle (sqrt parameterization)."""
    su = torch.sqrt(u1)
    b1 = 1.0 - su
    b2 = u2 * su
    return b1, b2


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta=2) weight for strategy a."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
