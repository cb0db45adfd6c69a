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


def uniform_cone(u1, u2, cos_theta_max):
    """Uniform direction in a cone around +Z."""
    cos_t = 1.0 - u1 * (1.0 - cos_theta_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)
