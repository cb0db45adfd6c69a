"""Prefix scans and stream compaction (port of `kajiya_tpu/ops/scan.py`).

The reference's 3-dispatch GPU prefix scan is `torch.cumsum`;
`compact_indices` packs the True lanes of a mask into a fixed-size buffer,
the idiom the irradiance cache's allocation is built on.
"""
from __future__ import annotations

import torch


def inclusive_scan(x, dim: int = -1):
    """Inclusive prefix sum, in x's dtype (torch would widen ints to int64)."""
    return torch.cumsum(x, dim=dim, dtype=x.dtype)


def exclusive_scan(x, dim: int = -1):
    return inclusive_scan(x, dim) - x


def scatter_max(base, idx, val):
    """`base.at[idx].max(val)`: a copy of `base` with val scattered in by
    max. Masked lanes of the JAX module write a neutral value into index 0,
    so plain `amax` over all lanes gives the same result."""
    return base.scatter_reduce(0, idx.long(), val.to(base.dtype), "amax",
                               include_self=True)


def compact_indices(mask, capacity: int | None = None):
    """Indices of True lanes, densely packed into a fixed-size buffer.

    Returns (packed (capacity,) int32 with -1 padding, count ()). Ranks are
    unique, so the scatter is deterministic."""
    n = mask.shape[0]
    if capacity is None:
        capacity = n
    m32 = mask.to(torch.int32)
    rank = exclusive_scan(m32)
    count = m32.sum(dtype=torch.int32)
    ids = torch.arange(n, dtype=torch.int32, device=mask.device)
    ok = mask & (rank < capacity)
    packed = torch.full((capacity,), -1, dtype=torch.int32, device=mask.device)
    packed = scatter_max(packed, torch.where(ok, rank, 0),
                         torch.where(ok, ids, -1))
    return packed, torch.clamp(count, max=capacity)
