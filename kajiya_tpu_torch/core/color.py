"""Color math (port of `kajiya_tpu/core/color.py`)."""
from __future__ import annotations

import torch

_LUMA = (0.2126, 0.7152, 0.0722)  # Rec.709


def luminance(rgb):
    return (rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1]
            + rgb[..., 2] * _LUMA[2])


def srgb_encode(linear):
    linear = torch.clamp(linear, min=0.0)
    lo = linear * 12.92
    hi = 1.055 * torch.pow(torch.clamp(linear, min=1e-8), 1.0 / 2.4) - 0.055
    return torch.where(linear <= 0.0031308, lo, hi)


def srgb_decode(srgb):
    srgb = torch.clamp(srgb, min=0.0)
    lo = srgb / 12.92
    hi = torch.pow((srgb + 0.055) / 1.055, 2.4)
    return torch.where(srgb <= 0.04045, lo, hi)


def lin_to_ycbcr(rgb):
    y = luminance(rgb)
    return torch.stack([y, rgb[..., 2] - y, rgb[..., 0] - y], dim=-1)


def ycbcr_to_lin(ycc):
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    r = cr + y
    b = cb + y
    g = (y - 0.2126 * r - 0.0722 * b) / 0.7152
    return torch.stack([r, g, b], dim=-1)
