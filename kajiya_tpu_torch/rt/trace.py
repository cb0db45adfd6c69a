"""Ray queries (port of `kajiya_tpu/rt/trace.py`).

`scene_trace_closest` / `scene_trace_shadow` are the software `TraceRay` of
every pass. Scenes up to `brute_max_tris` triangles (world.py) carry Woop
tables and go to the intersector kernels (ops/woop_cuda.py): the culled
kernel where the scene has cluster tables, the brute kernel otherwise.
Divergent batches (GI, bounce and validation rays) ask for `sort=True`:
where the culled kernel runs they are traced as a key-sorted wavefront in
128-ray chunks (ops/raysort.py). Larger scenes carry a BVH instead
(`ts.woop` is None) and go to `trace_closest` / `trace_shadow`, unsorted, as
in JAX: the BVH walk, the kernel csrc/bvh.cu on CUDA tensors
(ops/bvh_cuda.py) and its plain versions on CPU tensors.

Two walk orders, each with a plain version in lockstep PyTorch (one host
read of "any ray left" a step), its arithmetic written out in the kernel's
order (dot products summed (x x' + y y') + z z', crosses as
ops/smallvec.py takes them), so that on the card both return the same bits
and the same per-ray counts:
- `walk_plain`, the skip-link walk, `_traverse` of the JAX module: one node
  a step in DFS order. Any-hit calls and calls with `max_steps` take it
  (the cap counts its steps).
- `walk_ordered_plain`, the front-to-back walk of closest-hit calls without
  a cap: at an internal node both children's boxes are tested, the nearer
  is entered and the farther kept on a per-ray stack with its entry
  distance. A triangle wins on t < t_best, or on t == t_best from a lower
  `tri_order` slot: the skip-link walk tests slots in increasing order
  under a strict t < t_best, so both walks pick the same triangle whenever
  both test it. Once a ray has a hit, its boxes are tested against
  t_best (1 + 2^-16) rather than t_best: a triangle that ties the hit
  (coplanar overlapping faces, as a building's floor on the ground) then
  has its box entered although the box's entry distance rounds above the
  tie. The walks can differ only where a box test's rounding hides the
  winning triangle beyond that margin, that is where a ray has two hits
  within rounding of each other.
A ray with t_max <= t_min cannot be hit: both walks return it at once
(t_max, -1, 0, 0) with no visit.
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


def _slab(org, inv_d, bmin, bmax):
    """Entry and exit distances (tn, tf) of the rays through the boxes."""
    t0 = (bmin - org) * inv_d
    t1 = (bmax - org) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return tn, tf


def _box_hit(tn, tf, t_max):
    return (tn <= tf) & (tf >= 0.0) & (tn <= t_max)


def _aabb_hit(org, inv_d, bmin, bmax, t_max):
    return _box_hit(*_slab(org, inv_d, bmin, bmax), t_max)


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
    node = torch.where(tmax <= t_min, n_nodes, node)     # dead lanes
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


# the front-to-back walk's box margin once a ray has a hit (a power of two:
# t * TIE_MARGIN is exact)
TIE_MARGIN = 2.0 ** -16


def walk_depth(n_tris: int, leaf_size: int) -> int:
    """Internal levels of the builders' BVH over n_tris triangles: they
    split at the median, so the larger half of m triangles is ceil(m / 2).
    A ray of the front-to-back walk keeps at most one far child a level,
    so this is the size of its stack (city40: 19; at most 31 below 2^31
    triangles)."""
    depth = 0
    while n_tris > leaf_size:
        n_tris = -(-n_tris // 2)
        depth += 1
    return depth


def walk_ordered_plain(bvh, tris, org, d, t_min, tmax, counts: bool = False):
    """The front-to-back closest-hit walk in plain PyTorch: (t, tri, u, v)
    and, with `counts`, the per-ray int32 box tests ("visits": the root,
    then two a descent) and triangle tests. `tmax`: (R,) float32.

    A live ray tests the root box; while its current node is internal it
    tests both children against t_cull, enters the nearer (the left one on
    a tie of entry distances) and pushes the farther with its entry
    distance, or pops when neither is hit; at a leaf it tests the leaf's
    triangles in slot order and pops. A pop drops entries whose entry
    distance is above t_cull (the box test at the current t_cull) and takes
    the first one that is not. t_cull is t_max until the first hit, then
    t_best + |t_best| TIE_MARGIN. Each lockstep step does one of: a
    descent, a leaf, a pop."""
    v0s, e1s, e2s = tris
    n_nodes = bvh.num_nodes
    lsz = bvh.leaf_size
    r = org.shape[0]
    dev = org.device
    i64 = torch.int64
    t_min = float(np.float32(t_min))
    inv_d = _safe_inv(d)
    t = tmax.clone()
    t_cull = tmax.clone()
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((r,), dtype=torch.float32, device=dev)
    v = torch.zeros((r,), dtype=torch.float32, device=dev)
    pos_best = torch.zeros((r,), dtype=i64, device=dev)
    first_all = bvh.node_first.long()
    count_all = bvh.node_count.long()
    right_all = bvh.node_skip.long()[torch.clamp(
        torch.arange(1, n_nodes + 1, device=dev), max=n_nodes - 1)]
    live = ~(tmax <= t_min)
    root = _aabb_hit(org, inv_d, bvh.node_min[:1], bvh.node_max[:1], t) & live
    visits = live.to(torch.int32)
    tests = torch.zeros((r,), dtype=torch.int32, device=dev)
    cur = torch.where(root, 0, -1).to(i64)
    popping = torch.zeros((r,), dtype=torch.bool, device=dev)
    depth = max(walk_depth(v0s.shape[0], lsz), 1)
    stack_node = torch.zeros((r, depth), dtype=i64, device=dev)
    stack_tn = torch.zeros((r, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros((r,), dtype=i64, device=dev)
    while bool(((cur >= 0) | popping).any()):
        act = cur >= 0
        safe = torch.where(act, cur, 0)
        count = count_all[safe]
        leaf = act & (count > 0)
        inner = act & ~leaf
        # a descent: both children against t_cull
        c0 = torch.clamp(safe + 1, max=n_nodes - 1)
        c1 = torch.clamp(right_all[safe], max=n_nodes - 1)
        tn0, tf0 = _slab(org, inv_d, bvh.node_min[c0], bvh.node_max[c0])
        tn1, tf1 = _slab(org, inv_d, bvh.node_min[c1], bvh.node_max[c1])
        h0 = inner & _box_hit(tn0, tf0, t_cull)
        h1 = inner & _box_hit(tn1, tf1, t_cull)
        visits += 2 * inner.to(torch.int32)
        swap = tn1 < tn0
        push = h0 & h1
        # a ray pushes at most one entry a level, so sp < depth where it
        # pushes; elsewhere the clamped slot is written back unchanged
        at = torch.clamp(sp, max=depth - 1)[:, None]
        stack_node.scatter_(1, at, torch.where(
            push, torch.where(swap, c0, c1),
            stack_node.gather(1, at)[:, 0])[:, None])
        stack_tn.scatter_(1, at, torch.where(
            push, torch.where(swap, tn0, tn1),
            stack_tn.gather(1, at)[:, 0])[:, None])
        sp = sp + push.long()
        nxt = torch.where(push, torch.where(swap, c1, c0),
                          torch.where(h0, c0, torch.where(h1, c1, -1)))
        # a leaf: its triangles in slot order
        first = first_all[safe]
        for k in range(lsz):
            tid = bvh.tri_order[torch.where(leaf, first + k, 0)]
            tri_ok = leaf & (k < count) & (tid >= 0)
            safe_tid = torch.clamp(tid, min=0).long()
            tk, uk, vk, ok = _tri_intersect(org, d, v0s[safe_tid],
                                            e1s[safe_tid], e2s[safe_tid])
            pos = first + k
            closer = tri_ok & ok & (tk > t_min) & (
                (tk < t) | ((tk == t) & (tri >= 0) & (pos < pos_best)))
            t = torch.where(closer, tk, t)
            tri = torch.where(closer, tid, tri)
            u = torch.where(closer, uk, u)
            v = torch.where(closer, vk, v)
            pos_best = torch.where(closer, pos, pos_best)
            t_cull = torch.where(closer, tk + torch.abs(tk) * TIE_MARGIN,
                                 t_cull)
            tests += tri_ok
        cur = torch.where(inner, nxt, torch.where(leaf, -1, cur))
        # a pop: one entry a step, kept where its box is still hit
        want = popping | leaf | (inner & (nxt < 0))
        can = want & (sp > 0)
        top = torch.clamp(sp - 1, min=0)[:, None]
        e_node = stack_node.gather(1, top)[:, 0]
        e_tn = stack_tn.gather(1, top)[:, 0]
        sp = sp - can.long()
        take = can & (e_tn <= t_cull)
        cur = torch.where(take, e_node, cur)
        popping = can & ~take
    return (t, tri, u, v, visits, tests) if counts else (t, tri, u, v)


def _walk(bvh, tris, org, d, t_min, t_max, any_hit, max_steps, tables):
    from ..ops.bvh_cuda import walk_launch

    org, d = org.contiguous(), d.contiguous()
    tmax = ray_tmax(org, t_max)
    if org.device.type == "cpu":
        if any_hit or max_steps is not None:
            return walk_plain(bvh, tris, org, d, t_min, tmax, any_hit,
                              max_steps)
        return walk_ordered_plain(bvh, tris, org, d, t_min, tmax)
    return walk_launch(bvh, tris, tables, org, d, t_min, tmax, any_hit,
                       max_steps)


def trace_closest(bvh, tris, org, d, t_min=1e-4, t_max=INF,
                  max_steps=None, tables=None) -> Hit:
    """Closest-hit walk (front to back; the skip-link walk with
    `max_steps`). `tris` = (v0, e1, e2) world-space SoA from
    `GpuScene.triangle_corners`; org / d: (R, 3); t_max a number or (R,).
    `tables`: the kernel's `pack_walk_tables(bvh, tris)`
    (`TraceScene.walk_tables`), needed on CUDA tensors; the plain walks on
    CPU tensors do not read it."""
    return Hit(*_walk(bvh, tris, org, d, t_min, t_max, False, max_steps,
                      tables))


def trace_shadow(bvh, tris, org, d, t_min=1e-4, t_max=INF, max_steps=None,
                 tables=None):
    """Any-hit walk -> (R,) bool `occluded` (~ rt_is_shadowed)."""
    return _walk(bvh, tris, org, d, t_min, t_max, True, max_steps,
                 tables)[1] >= 0


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
                             max_steps, ts.walk_tables)
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
        return trace_shadow(ts.bvh, ts.tris, org, d, t_min, t_max, max_steps,
                            ts.walk_tables)
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
