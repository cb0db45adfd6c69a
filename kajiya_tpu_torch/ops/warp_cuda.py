"""Image warp kernel W: wrapper and plain version. Port of
`kajiya_tpu/ops/warp_pallas.py`.

`warp2d(img, uv, bilinear)` samples an (H, W) or (H, W, C) float32 image at
per-pixel uv (H2, W2, 2) with clamp-to-edge addressing per tap. CPU tensors
take the plain version (core/img.py's `sample_bilinear` / `sample_nearest`,
which the JAX package also takes off the TPU); CUDA tensors launch the kernel
in csrc/warp.cu or raise. The TPU kernel's window clamp (a limit of its VMEM
window) has no counterpart here: the port is held to the plain sampler.

The kernel spreads the channels over its threads: the output is a flat run
of elements, the element being the widest vector (4, 2 or 1 floats) that
divides C (`vector_width`).
"""
from __future__ import annotations

import torch

from ..core import img as im
from . import _native


def warp_plain(img, uv, bilinear: bool = True):
    return im.sample_bilinear(img, uv) if bilinear else im.sample_nearest(img, uv)


def vector_width(c: int) -> int:
    """Floats per element of the kernel's flat output run."""
    return 4 if c % 4 == 0 else (2 if c % 2 == 0 else 1)


def _aligned(t, nbytes):
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def warp_launch(img, uv, bilinear: bool = True):
    """Launch kernel W on CUDA tensors."""
    _native.check_cuda(img, uv)
    squeeze = img.ndim == 2
    img3 = img[..., None] if squeeze else img
    h, w, c = img3.shape
    if img3.dtype != torch.float32 or uv.dtype != torch.float32:
        raise ValueError("warp kernel takes float32 image and uv")
    if uv.shape[-1] != 2:
        raise ValueError(f"uv must end in 2, got {tuple(uv.shape)}")
    n = uv.numel() // 2
    if n * c >= 1 << 31:
        raise ValueError(f"warp kernel indexes {n} x {c} outputs in 32 bits")
    # the kernel moves 16-, 8- or 4-byte elements: a view at an odd offset
    # is copied to an aligned buffer
    img3 = _aligned(img3.contiguous(), 4 * vector_width(c))
    uv = _aligned(uv.contiguous(), 8)
    out = torch.empty(tuple(uv.shape[:-1]) + (c,), dtype=torch.float32,
                      device=img.device)
    if n:
        lib = _native.library()
        status = lib.kt_warp(img3.data_ptr(), h, w, c, uv.data_ptr(), n,
                             int(bilinear), out.data_ptr(),
                             _native.stream_ptr(img))
        _native.check_status("warp", status)
        _native.launches["warp"] += 1
    return out[..., 0] if squeeze else out


def warp2d(img, uv, bilinear: bool = True):
    """Kernel W wrapper (port of `warp2d_pallas`)."""
    if img.device.type == "cpu":
        return warp_plain(img, uv, bilinear)
    return warp_launch(img, uv, bilinear)
