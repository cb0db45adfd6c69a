"""Spatial blue-noise sampler (port of `kajiya_tpu/core/bluenoise.py`).

The masks are baked at first use by the same void-and-cluster code as the
JAX module (numpy, same seeds), so they come out bit-identical, and are
cached under the repository's gitignored `cache/` in a file of the port's own.
Per frame the 64x64 mask is toroidally shifted by an R2 offset and tiled over
the screen; the shift and tiling are one index gather on the device.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from . import rng as rng_mod

BN_SIZE = 64
_N_MASKS = 8
_PHI = 0.6180339887498949
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cache")
_CACHE_FILE = f"bluenoise{BN_SIZE}x{_N_MASKS}_torch.npy"

_masks = None   # (N_MASKS, BN_SIZE, BN_SIZE) float32 numpy, baked once


def _gauss_fft(n: int, sigma: float = 1.9):
    x = np.arange(n)
    x = np.minimum(x, n - x).astype(np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return np.fft.rfft2(np.outer(g, g))


def _void_and_cluster(n: int, seed: int) -> np.ndarray:
    """(n, n) float32 in (0, 1): rank/n^2 blue-noise mask, toroidal."""
    rng = np.random.default_rng(seed)
    total = n * n
    n_init = total // 10
    mask = np.zeros(total, bool)
    mask[rng.choice(total, n_init, replace=False)] = True
    kf = _gauss_fft(n)

    def energy(m):
        return np.fft.irfft2(np.fft.rfft2(m.reshape(n, n).astype(np.float64))
                             * kf, s=(n, n)).ravel()

    for _ in range(total):                # relax the initial pattern
        e = energy(mask)
        cluster = int(np.argmax(np.where(mask, e, -np.inf)))
        mask[cluster] = False
        void = int(np.argmin(np.where(mask, np.inf, energy(mask))))
        mask[void] = True
        if void == cluster:
            break

    rank = np.zeros(total, np.int64)
    m = mask.copy()                       # peel, ranking downward
    for r in range(n_init - 1, -1, -1):
        e = energy(m)
        cluster = int(np.argmax(np.where(m, e, -np.inf)))
        m[cluster] = False
        rank[cluster] = r
    m = mask.copy()                       # fill voids upward
    for r in range(n_init, total):
        void = int(np.argmin(np.where(m, np.inf, energy(m))))
        m[void] = True
        rank[void] = r
    return ((rank.astype(np.float32) + 0.5) / total).reshape(n, n)


def load_masks() -> np.ndarray:
    global _masks
    if _masks is not None:
        return _masks
    path = os.path.join(_CACHE, _CACHE_FILE)
    arr = None
    if os.path.exists(path):
        arr = np.load(path)
        if arr.shape != (_N_MASKS, BN_SIZE, BN_SIZE):
            arr = None
    if arr is None:
        arr = np.stack([_void_and_cluster(BN_SIZE, seed)
                        for seed in range(_N_MASKS)])
        os.makedirs(_CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)
    _masks = np.ascontiguousarray(arr, np.float32)
    return _masks


@lru_cache(maxsize=4 * _N_MASKS)
def _mask_on(k: int, device: torch.device) -> torch.Tensor:
    """Mask k on `device`, copied there once (a copy per call would make the
    host wait for the card). Callers must not write into it."""
    return torch.as_tensor(load_masks()[k], device=device)


def blue_noise_plane(h: int, w: int, frame_idx, stream: int = 0,
                     device=None, y0: int = 0):
    """(h, w) float32 in (0, 1): the blue-noise mask tiled over the screen,
    shifted by the frame's R2 offset. `stream` decorrelates consumers. `y0`
    is the screen row of the plane's first row (a row band's)."""
    bn = _mask_on(stream % _N_MASKS, torch.device(device or "cpu"))
    if stream >= _N_MASKS:
        k = stream // _N_MASKS
        bn = torch.remainder(bn + _PHI * k, 1.0)
        bn = torch.roll(bn, shifts=(int((k * 23) % BN_SIZE),
                                    int((k * 41) % BN_SIZE)), dims=(0, 1))
    off = rng_mod.r2_sequence(torch.as_tensor(frame_idx, device=device)
                              .to(torch.float32))
    oy = (off[0] * BN_SIZE).to(torch.int64)
    ox = (off[1] * BN_SIZE).to(torch.int64)
    # roll by (-oy, -ox) then tile: out[i, j] = bn[(i+oy) % N, (j+ox) % N]
    rows = (torch.arange(y0, y0 + h, device=device) + oy) % BN_SIZE
    cols = (torch.arange(w, device=device) + ox) % BN_SIZE
    return bn[rows[:, None], cols[None, :]]


def blue_noise_pair(h: int, w: int, frame_idx, stream: int = 0, device=None,
                    y0: int = 0):
    """Two decorrelated (h, w) planes: the (u1, u2) of a 2D sample."""
    return (blue_noise_plane(h, w, frame_idx, 2 * stream, device, y0),
            blue_noise_plane(h, w, frame_idx, 2 * stream + 1, device, y0))
