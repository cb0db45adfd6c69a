"""Direction+origin sorted ray wavefronts for the culled tracer (port of
`kajiya_tpu/ops/raysort.py`).

The culled intersector prices a ray chunk by how many 128-triangle blocks its
bounding beam touches. GI and bounce rays arrive in screen order with
hemisphere-random directions, so every chunk is divergent and visits nearly
every in-range block. Sorting the whole batch by a spatial-directional key
restores coherence: chunks of the sorted batch share an origin cell and a
direction cell, so the beam test sees genuine cones again.

Keys are 24 bits and ride int64 tensors; the sort is stable, so the
permutation equals the JAX module's `lax.sort`. Integer results stay integer
through the scatter back (no round trip through float).
"""
from __future__ import annotations

import numbers

import torch

from ..core.profiling import pass_scope

_OBITS = 5
_DBITS = 3


def _interleave3(x, y, z, bits):
    """Morton-interleave three `bits`-wide ints."""
    out = torch.zeros_like(x)
    for b in range(bits):
        out = out | (((x >> b) & 1) << (3 * b + 2))
        out = out | (((y >> b) & 1) << (3 * b + 1))
        out = out | (((z >> b) & 1) << (3 * b))
    return out


def ray_sort_key(org, d, smin, smax, obits: int = _OBITS,
                 dbits: int = _DBITS):
    """(R,) int64 sort key, mixed-radix: origin-morton high bits | direction
    cell | origin-morton low bits | direction low bits. Placing the direction
    cell above the origin's fine bits bounds a chunk in position and in
    direction, which the reach-box test of the cull needs."""
    ext = torch.clamp(smax - smin, min=1e-6)
    oq = torch.clamp(((org - smin) / ext) * (1 << obits), 0.0,
                     float((1 << obits) - 1)).to(torch.int64)
    dq = torch.clamp((d * 0.5 + 0.5) * (1 << dbits), 0.0,
                     float((1 << dbits) - 1)).to(torch.int64)
    o_lo_b = min(2, obits)           # fine origin bits demoted below dir
    d_lo_b = min(1, dbits)           # finest dir bit below those
    o_hi = _interleave3(oq[:, 0] >> o_lo_b, oq[:, 1] >> o_lo_b,
                        oq[:, 2] >> o_lo_b, obits - o_lo_b)
    d_hi = _interleave3(dq[:, 0] >> d_lo_b, dq[:, 1] >> d_lo_b,
                        dq[:, 2] >> d_lo_b, dbits - d_lo_b)
    lo_mask = (1 << o_lo_b) - 1
    o_lo = _interleave3(oq[:, 0] & lo_mask, oq[:, 1] & lo_mask,
                        oq[:, 2] & lo_mask, o_lo_b)
    dlo_mask = (1 << d_lo_b) - 1
    d_lo = _interleave3(dq[:, 0] & dlo_mask, dq[:, 1] & dlo_mask,
                        dq[:, 2] & dlo_mask, d_lo_b)
    key = o_hi
    for part, bits in ((d_hi, 3 * (dbits - d_lo_b)), (o_lo, 3 * o_lo_b),
                       (d_lo, 3 * d_lo_b)):
        key = (key << bits) | part
    return key


# Sorted-wavefront defaults of the JAX module: coarse key bits bound every
# bucket in position and direction at realistic wavefront sizes, and fine
# 128-ray chunks cull tighter than 512-ray ones.
SORT_OBITS = 3
SORT_DBITS = 2
SORT_RAY_BLOCK = 128


def sort_permutation(woop, org, d, obits: int = SORT_OBITS,
                     dbits: int = SORT_DBITS):
    """The stable key-sort permutation of a ray batch."""
    smin = woop["cmin64"].amin(dim=0)
    smax = woop["cmax64"].amax(dim=0)
    key = ray_sort_key(org, d, smin, smax, obits, dbits)
    return torch.sort(key, stable=True)[1]


def sorted_trace(trace_fn, woop, org, d, t_max=None, obits: int = SORT_OBITS,
                 dbits: int = SORT_DBITS):
    """Run `trace_fn(org, d, t_max) -> tuple of (R,) tensors` on a key-sorted
    permutation of the rays and scatter the results back."""
    r = org.shape[0]
    with pass_scope("ray_sort"):
        perm = sort_permutation(woop, org, d, obits, dbits)
    tm = None
    if isinstance(t_max, numbers.Real):    # filled on the device, no copy
        tm = torch.full((r,), float(t_max), dtype=torch.float32,
                        device=org.device)
    elif t_max is not None:
        tm = torch.as_tensor(t_max, dtype=torch.float32,
                             device=org.device).expand(r)[perm]
    outs = trace_fn(org[perm], d[perm], tm)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(r, device=perm.device)
    return tuple(o[inv] for o in outs)
