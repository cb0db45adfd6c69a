"""Sky environment as an octahedral map and its L2 spherical-harmonic
reconstruction (port of `kajiya_tpu/sky/env.py`: `build_sky_env`,
`convolve_diffuse`, `project_sh9`, `sh9_radiance_fn`, `sh9_irradiance_fn`,
`sample_env`)."""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops.smallvec import matmul_small
from .atmosphere import sky_radiance

SKY_RES = 64
DIFFUSE_RES = 16


def oct_encode(d):
    """Unit direction -> octahedral uv in [0,1]^2."""
    ad = torch.abs(d)
    inv_l1 = 1.0 / torch.clamp(ad[..., 0] + ad[..., 1] + ad[..., 2], min=1e-12)
    x = d[..., 0] * inv_l1
    y = d[..., 1] * inv_l1
    xf = torch.where(d[..., 2] < 0.0,
                     (1.0 - torch.abs(y)) * torch.sign(x + 1e-20), x)
    yf = torch.where(d[..., 2] < 0.0,
                     (1.0 - torch.abs(x)) * torch.sign(y + 1e-20), y)
    return torch.stack([xf * 0.5 + 0.5, yf * 0.5 + 0.5], dim=-1)


def oct_decode(uv):
    """Octahedral uv in [0,1]^2 -> unit direction."""
    f = uv * 2.0 - 1.0
    x, y = f[..., 0], f[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    xf = torch.where(z < 0.0, (1.0 - torch.abs(y)) * torch.sign(x + 1e-20), x)
    yf = torch.where(z < 0.0, (1.0 - torch.abs(x)) * torch.sign(y + 1e-20), y)
    d = torch.stack([xf, yf, z], dim=-1)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-12)


def _texel_dirs(res: int, device):
    ar = torch.arange(res, device=device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    uv = (torch.stack([gx, gy], dim=-1) + 0.5) / res
    return oct_decode(uv.to(torch.float32))


def build_sky_env(sun_direction, res: int = SKY_RES):
    """(res, res, 3) octahedral sky radiance map."""
    dirs = _texel_dirs(res, sun_direction.device)
    return sky_radiance(dirs.reshape(-1, 3), sun_direction).reshape(res, res, 3)


def _oct_dirs_np(res: int) -> np.ndarray:
    """(res, res, 3) unit directions of the oct texel centres (float64)."""
    uv = (np.stack(np.meshgrid(np.arange(res), np.arange(res),
                               indexing="xy"), -1) + 0.5) / res
    f = uv * 2.0 - 1.0
    x, y = f[..., 0], f[..., 1]
    z = 1.0 - np.abs(x) - np.abs(y)
    xf = np.where(z < 0, (1 - np.abs(y)) * np.sign(x + 1e-20), x)
    yf = np.where(z < 0, (1 - np.abs(x)) * np.sign(y + 1e-20), y)
    d = np.stack([xf, yf, z], -1)
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)


@lru_cache(maxsize=4)
def _convolve_matrix(res_in: int, res_out: int) -> np.ndarray:
    """(res_out^2, res_in^2) cosine-convolution weights over equal-area oct
    texels (solid angle 4 pi / res_in^2 each), scaled to E(n) / pi."""
    di = _oct_dirs_np(res_in).reshape(-1, 3)
    do = _oct_dirs_np(res_out).reshape(-1, 3)
    cosw = np.maximum(do @ di.T, 0.0)
    d_omega = 4.0 * np.pi / (res_in * res_in)
    return (cosw * (d_omega / np.pi)).astype(np.float32)


def convolve_diffuse(env, res_out: int = DIFFUSE_RES):
    """Cosine-convolve a (res, res, 3) sky map into a (res_out, res_out, 3)
    irradiance / pi map: one float32 matrix product (TF32 stays off, as
    the package sets it)."""
    m = torch.as_tensor(_convolve_matrix(env.shape[0], res_out),
                        device=env.device)
    return torch.matmul(m, env.reshape(-1, 3)).reshape(res_out, res_out, 3)


def sample_env(env, d):
    """Environment radiance along d: `env` is an octahedral map (bilinear)
    or a callable d -> radiance."""
    if callable(env):
        return env(d)
    from ..core import img as im

    return im.sample_bilinear(env, oct_encode(d))


_SH_C = (0.28209479, 0.48860251, 1.09254843, 0.31539157, 0.54627421)
_A = (3.141593, 2.094395, 0.785398)


def _sh9_basis(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c = _SH_C
    return torch.stack([
        torch.full_like(x, c[0]),
        c[1] * y, c[1] * z, c[1] * x,
        c[2] * x * y, c[2] * y * z,
        c[3] * (3.0 * z * z - 1.0),
        c[2] * x * z, 0.5 * c[2] * (x * x - y * y),
    ], dim=-1)


@lru_cache(maxsize=4)
def _sh9_project_matrix(res: int):
    """(res^2, 9) SH projection weights over the equal-area oct texels."""
    d = _oct_dirs_np(res).reshape(-1, 3)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    c = _SH_C
    b = np.stack([
        np.full_like(x, c[0]), c[1] * y, c[1] * z, c[1] * x,
        c[2] * x * y, c[2] * y * z, c[3] * (3 * z * z - 1),
        c[2] * x * z, 0.5 * c[2] * (x * x - y * y)], axis=-1)
    return (b * (4.0 * np.pi / (res * res))).astype(np.float32)


def project_sh9(env_map):
    """(res, res, 3) radiance map -> (9, 3) SH radiance coefficients."""
    m = torch.as_tensor(_sh9_project_matrix(env_map.shape[0]),
                        device=env_map.device)
    return m.T @ env_map.reshape(-1, 3)


def sh9_radiance_fn(sh_coeffs):
    """Callable d -> SH9-reconstructed radiance (sun disk not included)."""
    def fetch(d):
        return torch.clamp(matmul_small(_sh9_basis(d), sh_coeffs), min=0.0)

    return fetch


def sh9_irradiance_fn(sh_coeffs):
    """Callable n -> E(n)/pi from SH radiance coefficients."""
    a = torch.tensor([_A[0]] + [_A[1]] * 3 + [_A[2]] * 5, dtype=torch.float32,
                     device=sh_coeffs.device)
    conv = sh_coeffs * a[:, None] / math.pi

    def fetch(n):
        return torch.clamp(matmul_small(_sh9_basis(n), conv), min=0.0)

    return fetch
