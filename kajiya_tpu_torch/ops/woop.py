"""Woop ray/triangle tables (port of `kajiya_tpu/ops/woop.py`).

For each triangle the affine map A into its barycentric frame (unit triangle
in the w=0 plane) is precomputed. For a ray (o, d):
    q = A o + b,  r = A d,  t = -q_w / r_w,  u = q_u + t r_u,  v = q_v + t r_v
and the ray hits iff u, v >= 0, u + v <= 1 and t lies in (t_min, t_max), with
a 1e-5 barycentric slack that closes cracks along shared edges.

`intersect_brute` is the dense reference over the whole table; it is the
plain version of kernel B (ops/woop_cuda.py).
"""
from __future__ import annotations

import torch

from .smallvec import cross

INF = 1e30

TRI_BLOCK = 256     # cluster granularity of `cmin`/`cmax` (and table padding)


def build_woop(v0, e1, e2, pad_to: int | None = None):
    """Per-triangle barycentric-frame transforms: dict with
    a_d (3T, 3), a_o (3T, 4) grouped as [u rows | v rows | w rows], and
    valid (T,) for non-degenerate triangles."""
    t = v0.shape[0]
    n = cross(e1, e2)
    m = torch.stack([e1, e2, n], dim=-1)              # (T, 3, 3) columns
    det = torch.linalg.det(m)
    valid = torch.abs(det) > 1e-18
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    safe_m = torch.where(valid[:, None, None], m, eye)
    inv = torch.linalg.inv(safe_m)
    inv = torch.where(valid[:, None, None], inv, torch.zeros_like(inv))
    b = -(inv[:, :, 0] * v0[:, 0:1] + inv[:, :, 1] * v0[:, 1:2]
          + inv[:, :, 2] * v0[:, 2:3])
    if pad_to is not None and pad_to > t:
        pad = pad_to - t
        inv = torch.cat([inv, inv.new_zeros((pad, 3, 3))])
        b = torch.cat([b, b.new_zeros((pad, 3))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    a_d = torch.cat([inv[:, 0, :], inv[:, 1, :], inv[:, 2, :]], dim=0)
    a_o = torch.cat([torch.cat([inv[:, k, :], b[:, k:k + 1]], dim=-1)
                     for k in range(3)], dim=0)
    return {"a_d": a_d.contiguous(), "a_o": a_o.contiguous(), "valid": valid}


def build_clusters(v0, e1, e2, pad_to: int, tri_block: int = TRI_BLOCK):
    """Per-block AABBs over consecutive triangle blocks: (cmin, cmax), each
    (C, 3). Padded triangles collapse to inverted (+1e30, -1e30) boxes."""
    t = v0.shape[0]
    p1, p2 = v0 + e1, v0 + e2
    tmin = torch.minimum(torch.minimum(v0, p1), p2)
    tmax = torch.maximum(torch.maximum(v0, p1), p2)
    pad = pad_to - t
    if pad:
        tmin = torch.cat([tmin, tmin.new_full((pad, 3), INF)])
        tmax = torch.cat([tmax, tmax.new_full((pad, 3), -INF)])
    c = pad_to // tri_block
    return (tmin.reshape(c, tri_block, 3).amin(dim=1),
            tmax.reshape(c, tri_block, 3).amax(dim=1))


def intersect_brute(woop, org, d, t_min=1e-4, t_max=None, any_hit=False):
    """Closest hit over all triangles: (t, tri, u, v) with t = 1e30 and
    tri = -1 on a miss. Dense reference, any device."""
    from .woop_cuda import brute_plain, coef_rows, ray_tmax, stored_table

    tm = ray_tmax(org, t_max)
    return brute_plain(stored_table(woop, "coef_rows", coef_rows), org, d, tm,
                       t_min)
