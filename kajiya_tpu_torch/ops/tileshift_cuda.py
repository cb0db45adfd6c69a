"""Per-tile shift kernel S: wrapper and plain version. Port of
`kajiya_tpu/ops/tileshift_pallas.py`.

`tile_shift(img, dy, dx)` fetches an (H, W) or (H, W, C) float32 image at one
integer pixel offset per (8, 128) output tile, with the offsets clipped to
+-MAX_DY / +-MAX_DX and a per-pixel clamp at the image edges:

    out[y, x] = img[clamp(y + dy_t, 0, H-1), clamp(x + dx_t, 0, W-1)]

The ReSTIR spatial passes quantize their spiral rotation to these tiles, so
every neighbour tap of the packed reservoir plane is one such fetch. CPU
tensors take the plain version (an advanced-index gather); CUDA tensors
launch the kernel in csrc/tileshift.cu or raise. Both move values only, so
they agree bit for bit.
"""
from __future__ import annotations

import torch

from . import _native

TH, TW = 8, 128          # the offset-quantization tile
MAX_DY = 16              # |dy| <= 16 rows
MAX_DX = 64              # |dx| <= 64 cols


def tile_grid(h: int, w: int):
    """Number of offset tiles (nty, ntx) for an (h, w) image."""
    return -(-h // TH), -(-w // TW)


def _check_offsets(img, dy, dx):
    nty, ntx = tile_grid(img.shape[0], img.shape[1])
    for name, o in (("dy", dy), ("dx", dx)):
        if tuple(o.shape) != (nty * ntx,):
            raise ValueError(f"{name} must have one offset per tile "
                             f"({nty * ntx},), got {tuple(o.shape)}")
    return nty, ntx


def shift_indices(img, dy, dx):
    """The (H, W) int64 row and column each output pixel fetches: the
    per-tile offsets clipped, added and clamped at the image edges."""
    h, w = img.shape[0], img.shape[1]
    nty, ntx = _check_offsets(img, dy, dx)

    def full(o, lim):
        o = torch.clamp(o.to(torch.int64), -lim, lim).reshape(nty, ntx)
        return o.repeat_interleave(TH, 0).repeat_interleave(TW, 1)[:h, :w]

    dev = img.device
    iy = torch.arange(h, device=dev)[:, None] + full(dy, MAX_DY)
    ix = torch.arange(w, device=dev)[None, :] + full(dx, MAX_DX)
    return iy.clamp(0, h - 1), ix.clamp(0, w - 1)


def tile_shift_plain(img, dy, dx):
    """Plain version of kernel S: the same fetch as an index gather."""
    iy, ix = shift_indices(img, dy, dx)
    return img[iy, ix]


def tile_shift_launch(img, dy, dx):
    """Launch kernel S on CUDA tensors."""
    _native.check_cuda(img, dy, dx)
    if img.ndim not in (2, 3) or img.dtype != torch.float32:
        raise ValueError("tile shift kernel takes a float32 (H, W) or "
                         f"(H, W, C) image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    if dy.dtype != torch.int32 or dx.dtype != torch.int32:
        raise ValueError("tile shift kernel takes int32 offsets")
    nty, ntx = _check_offsets(img, dy, dx)
    img, dy, dx = img.contiguous(), dy.contiguous(), dx.contiguous()
    h, w = img.shape[0], img.shape[1]
    c = img.shape[2] if img.ndim == 3 else 1
    out = torch.empty_like(img)
    if img.numel():
        lib = _native.library()
        status = lib.kt_tile_shift(img.data_ptr(), h, w, c,
                                   dy.data_ptr(), dx.data_ptr(), nty, ntx,
                                   out.data_ptr(), _native.stream_ptr(img))
        _native.check_status("tile_shift", status)
        _native.launches["tile_shift"] += 1
    return out


def tile_shift(img, dy, dx):
    """Kernel S wrapper (port of `tile_shift`). dy/dx: (nty*ntx,) integer
    per-tile pixel offsets, row-major over the tiles of `tile_grid`."""
    if img.device.type == "cpu":
        return tile_shift_plain(img, dy, dx)
    return tile_shift_launch(img, dy, dx)
