"""Morton codes (the one piece of `kajiya_tpu/rt/bvh.py` this slice needs).

Every scene of this slice has at most 262,144 triangles and takes the Woop
path, so no BVH is built or walked; `morton3d` orders the triangle tables of
scenes above 8,192 triangles so consecutive 128-triangle blocks are compact.
"""
from __future__ import annotations

import numpy as np


def _expand_bits(v):
    """Spread the lower 10 bits of v to every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(xyz01: np.ndarray) -> np.ndarray:
    """(N,3) floats in [0,1] -> 30-bit Morton codes."""
    q = np.clip(xyz01 * 1024.0, 0, 1023).astype(np.uint64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))
