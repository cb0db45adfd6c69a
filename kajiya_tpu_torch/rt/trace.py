"""Ray queries (port of `kajiya_tpu/rt/trace.py`).

`scene_trace_closest` / `scene_trace_shadow` are the software `TraceRay` of
every pass. Scenes up to `brute_max_tris` triangles (world.py) carry Woop
tables and go to the intersector kernels (ops/woop_cuda.py): the culled
kernel where the scene has cluster tables, the brute kernel otherwise.
Divergent batches (GI, bounce and validation rays) ask for `sort=True`:
where the culled kernel runs they are traced as a key-sorted wavefront in
128-ray chunks (ops/raysort.py). Larger scenes carry a BVH instead
(`ts.woop` is None) and go to `trace_closest` / `trace_shadow`, unsorted, as
in JAX: the skip-link walk, the kernel csrc/bvh.cu on CUDA tensors
(ops/bvh_cuda.py) and its plain version `walk_plain` on CPU tensors.

`walk_plain` is `_traverse` of the JAX module in PyTorch: every ray advances
one node a step in lockstep, with one host read of "any ray left" a step.
Its arithmetic is written out in the kernel's order (dot products summed
(x x' + y y') + z z', crosses as ops/smallvec.py takes them), so on the card
both return the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.raysort import SORT_RAY_BLOCK, sorted_trace
from ..ops.smallvec import cross, dot3
from ..ops.woop_cuda import INF, intersect_scene, ray_tmax

_EPS = float(np.float32(1e-12))


@dataclass
class Hit:
    """Closest-hit payload (~ `GbufferRayPayload`, inc/rt.hlsl)."""
    t: torch.Tensor     # (R,) f32; a miss: 1e30 (Woop), t_max (BVH walk)
    tri: torch.Tensor   # (R,) int32, -1 = miss
    u: torch.Tensor     # (R,) f32 barycentric
    v: torch.Tensor     # (R,) f32 barycentric

    @property
    def hit_mask(self):
        return self.tri >= 0

    def map(self, fn):
        return Hit(fn(self.t), fn(self.tri), fn(self.u), fn(self.v))


# ----------------------------------------------------------------------------
# The skip-link BVH walk
# ----------------------------------------------------------------------------

def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) < _EPS,
                             torch.where(d < 0, -_EPS, _EPS), d)


def _aabb_hit(org, inv_d, bmin, bmax, t_max):
    t0 = (bmin - org) * inv_d
    t1 = (bmax - org) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (tn <= tf) & (tf >= 0.0) & (tn <= t_max)


def _tri_intersect(org, d, v0, e1, e2):
    """Moller-Trumbore, double-sided. Returns (t, u, v, valid)."""
    pvec = cross(d, e2)
    det = dot3(e1, pvec)
    valid = torch.abs(det) > _EPS
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    tvec = org - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    valid = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, valid


def walk_plain(bvh, tris, org, d, t_min, tmax, any_hit: bool,
               max_steps=None, counts: bool = False):
    """The lockstep walk in plain PyTorch: (t, tri, u, v) and, with
    `counts`, the per-ray int32 node visits and triangle tests. `tmax`:
    (R,) float32. `max_steps` caps the steps (each live ray visits one node
    a step); None walks until every ray has ended."""
    v0s, e1s, e2s = tris
    n_nodes = bvh.num_nodes
    lsz = bvh.leaf_size
    r = org.shape[0]
    dev = org.device
    t_min = float(np.float32(t_min))
    inv_d = _safe_inv(d)
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    t = tmax.clone()
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((r,), dtype=torch.float32, device=dev)
    v = torch.zeros((r,), dtype=torch.float32, device=dev)
    visits = torch.zeros((r,), dtype=torch.int32, device=dev)
    tests = torch.zeros((r,), dtype=torch.int32, device=dev)
    first_all = bvh.node_first.long()
    count_all = bvh.node_count.long()
    skip_all = bvh.node_skip.long()
    steps = 0
    while max_steps is None or steps < max_steps:
        active = node < n_nodes
        if not bool(active.any()):
            break
        safe = torch.where(active, node, 0)
        count = count_all[safe]
        first = first_all[safe]
        box_hit = _aabb_hit(org, inv_d, bvh.node_min[safe],
                            bvh.node_max[safe], t) & active
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf
        for k in range(lsz):
            tid = bvh.tri_order[torch.where(do_leaf, first + k, 0)]
            tri_ok = do_leaf & (k < count) & (tid >= 0)
            safe_tid = torch.clamp(tid, min=0).long()
            tk, uk, vk, ok = _tri_intersect(org, d, v0s[safe_tid],
                                            e1s[safe_tid], e2s[safe_tid])
            closer = tri_ok & ok & (tk > t_min) & (tk < t)
            t = torch.where(closer, tk, t)
            tri = torch.where(closer, tid, tri)
            u = torch.where(closer, uk, u)
            v = torch.where(closer, vk, v)
            tests += tri_ok
        next_node = torch.where(box_hit & ~is_leaf, node + 1, skip_all[safe])
        if any_hit:
            # shadow rays park as soon as anything is hit
            next_node = torch.where(tri >= 0, n_nodes, next_node)
        node = torch.where(active, next_node, n_nodes)
        visits += active
        steps += 1
    return (t, tri, u, v, visits, tests) if counts else (t, tri, u, v)


def _walk(bvh, tris, org, d, t_min, t_max, any_hit, max_steps):
    from ..ops.bvh_cuda import walk_launch

    org, d = org.contiguous(), d.contiguous()
    tmax = ray_tmax(org, t_max)
    if org.device.type == "cpu":
        return walk_plain(bvh, tris, org, d, t_min, tmax, any_hit, max_steps)
    return walk_launch(bvh, tris, org, d, t_min, tmax, any_hit, max_steps)


def trace_closest(bvh, tris, org, d, t_min=1e-4, t_max=INF,
                  max_steps=None) -> Hit:
    """Closest-hit walk. `tris` = (v0, e1, e2) world-space SoA from
    `GpuScene.triangle_corners`; org / d: (R, 3); t_max a number or (R,)."""
    return Hit(*_walk(bvh, tris, org, d, t_min, t_max, False, max_steps))


def trace_shadow(bvh, tris, org, d, t_min=1e-4, t_max=INF, max_steps=None):
    """Any-hit walk -> (R,) bool `occluded` (~ rt_is_shadowed)."""
    return _walk(bvh, tris, org, d, t_min, t_max, True, max_steps)[1] >= 0


# ----------------------------------------------------------------------------
# Scene-level dispatch
# ----------------------------------------------------------------------------

def _can_sort(ts, sort: bool) -> bool:
    """Wavefront sorting only pays where the culled tracer runs (scenes with
    cluster tables); small brute scenes would pay the sort for nothing, and
    BVH wavefronts are never sorted (as in JAX)."""
    return (sort and isinstance(ts.woop, dict)
            and ts.woop.get("cmin64") is not None)


def scene_trace_closest(ts, org, d, t_min=1e-4, t_max=INF, max_steps=None,
                        sort: bool = False, rb=None) -> Hit:
    """Closest hit against a TraceScene. `rb` overrides the culled kernel's
    rays per chunk; sorted wavefronts default to SORT_RAY_BLOCK."""
    woop = ts.woop
    if woop is None:
        return trace_closest(ts.bvh, ts.tris, org, d, t_min, t_max,
                             max_steps)
    if _can_sort(ts, sort):
        crb = SORT_RAY_BLOCK if rb is None else rb
        t, tri, u, v = sorted_trace(
            lambda o, dd, tm: intersect_scene(woop, o, dd, t_min=t_min,
                                              t_max=tm, rb=crb),
            woop, org, d, t_max=t_max)
    else:
        t, tri, u, v = intersect_scene(woop, org, d, t_min=t_min,
                                       t_max=t_max, rb=rb)
    return Hit(t=t, tri=tri, u=u, v=v)


def scene_trace_shadow(ts, org, d, t_min=1e-4, t_max=INF, max_steps=None,
                       sort: bool = False, rb=None):
    """Occlusion against a TraceScene -> (R,) bool (~ `rt_is_shadowed`)."""
    woop = ts.woop
    if woop is None:
        return trace_shadow(ts.bvh, ts.tris, org, d, t_min, t_max, max_steps)
    if _can_sort(ts, sort):
        crb = SORT_RAY_BLOCK if rb is None else rb
        (tri,) = sorted_trace(
            lambda o, dd, tm: (intersect_scene(woop, o, dd, t_min=t_min,
                                               t_max=tm, any_hit=True,
                                               rb=crb)[1],),
            woop, org, d, t_max=t_max)
    else:
        tri = intersect_scene(woop, org, d, t_min=t_min, t_max=t_max,
                              any_hit=True, rb=rb)[1]
    return tri >= 0
