"""Hash-based counter RNG (port of `kajiya_tpu/core/rng.py`).

The JAX module hashes in uint32. PyTorch on the CPU has no uint32 `add` or
`>>`, so the uint32 lattice is carried in int64 tensors holding values in
[0, 2^32) and every step masks with 0xFFFFFFFF. Products are split into
16-bit halves so no intermediate leaves int64's range. The streams are
bit-identical to the JAX ones (tests/test_torch_numerics.py).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    t = torch.as_tensor(x)
    if t.dtype != torch.int64:
        t = t.to(torch.int64)
    return t & MASK


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) and a constant k < 2^32."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg_hash(x):
    """PCG output-permutation hash of a uint32 lattice (O'Neill / JCGT 2020)."""
    x = _u32(x)
    state = (_mul32(x, 747796405) + 2891336453) & MASK
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return ((word >> 22) ^ word) & MASK


def hash_combine(a, b):
    """Combine two uint32 streams into one (order-sensitive)."""
    return pcg_hash(_u32(a) ^ _mul32(_u32(b), 0x9E3779B9))


def hash3(a, b, c):
    return hash_combine(hash_combine(a, b), c)


def u01(bits):
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (_u32(bits) >> 8).to(torch.float32) * (1.0 / 16777216.0)


def pixel_rng(px_x, px_y, frame_idx, stream: int = 0):
    """Per-pixel, per-frame decorrelated uint32 seed lattice."""
    return hash_combine(hash3(px_x, px_y, frame_idx), (0x85EBCA6B + stream) & MASK)


def next_rng(rng):
    """Advance a seed lattice one step."""
    return pcg_hash(rng)


def rand_u01(rng):
    """Draw one float in [0,1) and return (value, advanced rng)."""
    rng2 = next_rng(rng)
    return u01(rng2), rng2


def radical_inverse(n: int, base: int) -> float:
    val, inv_b, f = 0.0, 1.0 / base, 1.0 / base
    while n > 0:
        val += (n % base) * f
        n //= base
        f *= inv_b
    return val


def halton23_sequence(count: int) -> np.ndarray:
    """(count, 2) float32 Halton(2,3) points in [0,1)^2, 1-based."""
    return np.array([[radical_inverse(i + 1, 2), radical_inverse(i + 1, 3)]
                     for i in range(count)], dtype=np.float32)


_PLASTIC_A1 = 0.7548776662466927
_PLASTIC_A2 = 0.5698402909980532


def r2_sequence(n, offset=0.5):
    """R2 low-discrepancy sequence (Roberts), in float32."""
    n = torch.as_tensor(n, dtype=torch.float32)
    return torch.stack([torch.remainder(offset + _PLASTIC_A1 * n, 1.0),
                        torch.remainder(offset + _PLASTIC_A2 * n, 1.0)], dim=-1)
