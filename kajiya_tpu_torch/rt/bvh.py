"""BVH build (host) and per-frame refit (device): port of
`kajiya_tpu/rt/bvh.py`.

Scenes above `brute_max_tris` triangles (world.py) take the BVH route: the
topology is built once on the host over Morton-sorted triangles (median
splits over the sorted order), flattened into a skip-link ("threaded")
layout so the walk (rt/trace.py, csrc/bvh.cu) needs no per-ray stack; the
bounds are refit on the device from the current world-space triangles
whenever the trace scene is refreshed.

Skip-link layout: nodes in DFS order. For node i, `first_child == i + 1`; the
`skip` pointer jumps over i's whole subtree. Traversal: box hit & internal ->
descend to i + 1; otherwise -> skip[i]. Leaves store `leaf_size`-aligned runs
of reordered triangle ids, padded with -1.

`build_bvh` (Python) and `build_bvh_native` (csrc/bvh_builder.cpp, the port's
copy of the JAX package's builder, compiled with g++ at first use into the
gitignored `_build/` by `hostlib.load`) give the same bytes. From
NATIVE_BUILD_MIN_TRIS triangles on `bvh_from_scene` uses the native one;
where it cannot be built it raises with the compiler's output. This differs
from the JAX package, which falls back to the Python builder there; both
give the same output, so only a missing compiler shows.

`pack_walk_tables` lays the BVH and the triangles out as the walk kernel
reads them: a 32-byte record and a 64-byte record of its children a node,
and a 48-byte record a `tri_order` slot, repacked after every build and
refit.

`morton3d` also orders the triangle tables of Woop-route scenes above 8,192
triangles so consecutive 128-triangle blocks are compact.
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import hostlib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDER_SOURCE = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
# meshes from this size on go through the native builder
NATIVE_BUILD_MIN_TRIS = 20_000
_DEAD = float(np.float32(3e37))     # bounds of the -1 padding slots

_lock = threading.Lock()
_builder = None


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


@dataclass
class Bvh:
    """Flattened skip-link BVH, with the JAX `Bvh`'s fields and dtypes.
    numpy arrays as built; torch tensors after `.to(device)`.

    node_min/node_max : (N, 3) f32  AABB (refittable)
    node_first        : (N,) i32    leaf: offset into tri_order; internal: 0
    node_count        : (N,) i32    leaf: #tris (1..leaf_size); internal: 0
    node_skip         : (N,) i32    next DFS node when the subtree is skipped
                                    (N = done)
    tri_order         : (P,) i32    reordered triangle ids, padded with -1 to
                                    a multiple of leaf_size
    """

    node_min: object
    node_max: object
    node_first: object
    node_count: object
    node_skip: object
    tri_order: object
    leaf_size: int = 4

    @property
    def num_nodes(self) -> int:
        return int(self.node_min.shape[0])

    def to(self, device) -> "Bvh":
        """Contiguous torch tensors of the stored dtypes on `device`."""
        dev = torch.device(device)
        kw = {}
        for f in fields(self):
            x = getattr(self, f.name)
            if f.name == "leaf_size":
                kw[f.name] = int(x)
                continue
            dtype = torch.float32 if f.name in ("node_min", "node_max") \
                else torch.int32
            if isinstance(x, np.ndarray) and not x.flags.writeable:
                x = x.copy()
            kw[f.name] = torch.as_tensor(x, dtype=dtype,
                                         device=dev).contiguous()
        return Bvh(**kw)


def _refit_levels(node_count, node_skip, node_depth):
    """Internal nodes grouped by depth, deepest first, as (ids, child0,
    child1) int32 arrays."""
    internal = np.nonzero(node_count == 0)[0].astype(np.int32)
    levels = []
    if len(internal):
        child0 = internal + 1
        child1 = node_skip[child0]
        depths = node_depth[internal]
        for d in range(depths.max(), -1, -1):
            sel = depths == d
            if sel.any():
                levels.append((internal[sel], child0[sel], child1[sel]))
    return levels


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int = 4):
    """Build the topology on the host. Returns (Bvh with numpy arrays,
    levels), `levels` the bottom-up refit schedule: (node_ids, child0,
    child1) per depth, deepest first (leaves excluded: their bounds come
    from the triangles)."""
    n_tris = tri_min.shape[0]
    centers = 0.5 * (tri_min + tri_max)
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    norm = (centers - lo) / np.maximum(hi - lo, 1e-12)
    order = np.argsort(morton3d(norm), kind="stable").astype(np.int32)

    # Emit nodes in DFS order. Recursion depth is O(log n) (median splits).
    node_min, node_max = [], []
    node_first, node_count, node_skip, node_depth = [], [], [], []
    tri_runs = []  # (start_in_order, count) per leaf, in emission order

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    omin = tri_min[order]
    omax = tri_max[order]

    def rec(s, e, depth):
        i = len(node_min)
        node_min.append(None)
        node_max.append(None)
        node_first.append(0)
        node_count.append(0)
        node_skip.append(0)
        node_depth.append(depth)
        if e - s <= leaf_size:
            node_first[i] = len(tri_runs) * leaf_size
            node_count[i] = e - s
            tri_runs.append((s, e - s))
            node_min[i] = omin[s:e].min(axis=0)
            node_max[i] = omax[s:e].max(axis=0)
        else:
            mid = (s + e) // 2
            rec(s, mid, depth + 1)
            rec(mid, e, depth + 1)
            node_min[i] = np.minimum(node_min[i + 1], node_min[node_skip[i + 1]])
            node_max[i] = np.maximum(node_max[i + 1], node_max[node_skip[i + 1]])
        node_skip[i] = len(node_min)

    rec(0, n_tris, 0)

    # padded, leaf_size-aligned triangle order
    tri_order = np.full(len(tri_runs) * leaf_size, -1, np.int32)
    for li, (s, cnt) in enumerate(tri_runs):
        tri_order[li * leaf_size: li * leaf_size + cnt] = order[s: s + cnt]

    node_count = np.asarray(node_count, np.int32)
    node_skip = np.asarray(node_skip, np.int32)
    levels = _refit_levels(node_count, node_skip,
                           np.asarray(node_depth, np.int32))
    bvh = Bvh(node_min=np.stack(node_min).astype(np.float32),
              node_max=np.stack(node_max).astype(np.float32),
              node_first=np.asarray(node_first, np.int32),
              node_count=node_count, node_skip=node_skip,
              tri_order=tri_order, leaf_size=leaf_size)
    return bvh, levels


def builder_library() -> ctypes.CDLL:
    """The native builder, compiled at first use into BUILD_DIR (keyed by a
    hash of its source and flags) and loaded with ctypes."""
    global _builder
    with _lock:
        if _builder is not None:
            return _builder
        lib = hostlib.load(BUILDER_SOURCE, "bvh_builder", CXX, CXX_FLAGS,
                           BUILD_DIR, "the native BVH builder")
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.build_bvh.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                  f32p, f32p, i32p, i32p, i32p, i32p, i32p,
                                  i32p, i32p]
        lib.build_bvh.restype = ctypes.c_int
        _builder = lib
        return lib


def build_bvh_native(tri_min: np.ndarray, tri_max: np.ndarray,
                     leaf_size: int = 4):
    """The C++ builder: the same (Bvh numpy, levels) as `build_bvh`, bit for
    bit, at C++ speed. Raises if it cannot be built or fails."""
    lib = builder_library()
    n = tri_min.shape[0]
    cap_nodes = 2 * n + 2
    cap_order = 2 * n + leaf_size
    node_min = np.empty((cap_nodes, 3), np.float32)
    node_max = np.empty((cap_nodes, 3), np.float32)
    node_first = np.empty(cap_nodes, np.int32)
    node_count = np.empty(cap_nodes, np.int32)
    node_skip = np.empty(cap_nodes, np.int32)
    node_depth = np.empty(cap_nodes, np.int32)
    tri_order = np.empty(cap_order, np.int32)
    n_nodes = ctypes.c_int()
    n_order = ctypes.c_int()

    tmin = np.ascontiguousarray(tri_min, np.float32)
    tmax = np.ascontiguousarray(tri_max, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    rc = lib.build_bvh(
        tmin.ctypes.data_as(f32p), tmax.ctypes.data_as(f32p),
        ctypes.c_int(n), ctypes.c_int(leaf_size),
        node_min.ctypes.data_as(f32p), node_max.ctypes.data_as(f32p),
        node_first.ctypes.data_as(i32p), node_count.ctypes.data_as(i32p),
        node_skip.ctypes.data_as(i32p), node_depth.ctypes.data_as(i32p),
        tri_order.ctypes.data_as(i32p),
        ctypes.byref(n_nodes), ctypes.byref(n_order))
    if rc != 0:
        raise RuntimeError(f"native bvh build failed rc={rc}")
    nn, no = n_nodes.value, n_order.value
    node_count, node_skip = node_count[:nn], node_skip[:nn]
    levels = _refit_levels(node_count, node_skip, node_depth[:nn])
    bvh = Bvh(node_min=node_min[:nn], node_max=node_max[:nn],
              node_first=node_first[:nn], node_count=node_count,
              node_skip=node_skip, tri_order=tri_order[:no],
              leaf_size=leaf_size)
    return bvh, levels


def refit_schedule(levels, device):
    """The refit schedule as int64 index tensors on `device`, built once
    per scene so that a refit makes no host copy."""
    dev = torch.device(device)
    return [tuple(torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                  device=dev) for a in lv) for lv in levels]


def refit_bvh(bvh: Bvh, levels, v0, e1, e2) -> Bvh:
    """Refit the node bounds from the current triangle geometry on the
    device (the analog of the reference's per-frame TLAS rebuild,
    `ray_tracing.rs:455+`). `levels`: the schedule of `refit_schedule`,
    index tensors on the BVH's device, so a refit makes no host copy and no
    host read. Each level writes its distinct node ids once, so the bounds
    are exact: the same bits as the JAX refit."""
    t = bvh.tri_order
    safe = torch.clamp(t, min=0).long()
    p0 = v0[safe]
    p1 = p0 + e1[safe]
    p2 = p0 + e2[safe]
    dead = (t < 0)[:, None]
    tmin = torch.where(dead, _DEAD,
                       torch.minimum(torch.minimum(p0, p1), p2))
    tmax = torch.where(dead, -_DEAD,
                       torch.maximum(torch.maximum(p0, p1), p2))
    # leaf bounds: reduce each aligned run of leaf_size
    lsz = bvh.leaf_size
    runs_min = tmin.reshape(-1, lsz, 3).amin(dim=1)
    runs_max = tmax.reshape(-1, lsz, 3).amax(dim=1)
    is_leaf = (bvh.node_count > 0)[:, None]
    run_idx = torch.div(bvh.node_first, lsz, rounding_mode="floor").long()
    node_min = torch.where(is_leaf, runs_min[run_idx], bvh.node_min)
    node_max = torch.where(is_leaf, runs_max[run_idx], bvh.node_max)
    for ids, c0, c1 in levels:
        node_min[ids] = torch.minimum(node_min[c0], node_min[c1])
        node_max[ids] = torch.maximum(node_max[c0], node_max[c1])
    return Bvh(node_min=node_min, node_max=node_max,
               node_first=bvh.node_first, node_count=bvh.node_count,
               node_skip=bvh.node_skip, tri_order=bvh.tri_order,
               leaf_size=lsz)


def pack_walk_tables(bvh: Bvh, tris):
    """The walk kernel's tables (csrc/bvh.cu), the same bits as the `Bvh`
    arrays and the (v0, e1, e2) world SoA, on their device:

    nodes  (N, 8) f32, 32 bytes a node, read as two aligned float4:
           min.xyz, skip | max.xyz, link. `skip` is `node_skip`; `link` is
           the right child `node_skip[i + 1]` of an internal node (its left
           child is i + 1) and -1 - `node_first` of a leaf. Both words are
           int32 bits.
    leaves (P, 12) f32, 48 bytes a `tri_order` slot, in leaf order:
           v0.xyz, id | e1.xyz, 0 | e2.xyz, 0, with `id` the triangle id as
           int32 bits. A leaf's run of `leaf_size` slots is contiguous; its
           triangles come first and its padding slots carry id -1 (zeros
           elsewhere), so a leaf's count is the run's ids >= 0.
    pairs  (N, 16) f32, 64 bytes a node, read as four aligned float4, for
           the front-to-back walk: an internal node's two children's boxes
           and codes, c0min.xyz, w0 | c0max.xyz, w1 | c1min.xyz, c1 |
           c1max.xyz, 0, with c0 = i + 1, c1 its right child and w0 / w1
           the children's links (a leaf child's -1 - first; an internal
           child's own code is its index, c0 or c1); zeros for a leaf.

    Every internal node of the builders has two children (a leaf holds at
    least one triangle), so i + 1 < N there. Plain PyTorch, no host read."""
    v0, e1, e2 = tris
    n = bvh.num_nodes
    f32 = torch.float32
    skip = bvh.node_skip
    c0 = torch.clamp(torch.arange(1, n + 1, device=skip.device), max=n - 1)
    right = skip[c0]
    link = torch.where(bvh.node_count > 0, -1 - bvh.node_first, right)
    nodes = torch.cat([bvh.node_min, skip.view(f32)[:, None], bvh.node_max,
                       link.view(f32)[:, None]], dim=1)
    inner = (bvh.node_count == 0)[:, None]
    c1 = torch.where(inner[:, 0], right, 0).long()
    pairs = torch.where(inner, torch.cat([
        bvh.node_min[c0], link[c0].view(f32)[:, None], bvh.node_max[c0],
        link[c1].view(f32)[:, None], bvh.node_min[c1],
        c1.to(torch.int32).view(f32)[:, None], bvh.node_max[c1],
        torch.zeros((n, 1), dtype=f32, device=skip.device)], dim=1), 0.0)
    t = bvh.tri_order
    safe = torch.clamp(t, min=0).long()
    live = (t >= 0)[:, None]
    zero = torch.zeros((t.shape[0], 1), dtype=f32, device=t.device)
    leaves = torch.cat([torch.where(live, v0[safe], 0.0), t.view(f32)[:, None],
                        torch.where(live, e1[safe], 0.0), zero,
                        torch.where(live, e2[safe], 0.0), zero], dim=1)
    return nodes.contiguous(), leaves.contiguous(), pairs.contiguous()


def bvh_from_scene(gpu_scene, leaf_size: int = 4):
    """Build a BVH over a GpuScene's current world-space triangles.
    Returns (bvh on the scene's device, levels (numpy), (v0, e1, e2) world
    triangle SoA). Meshes of NATIVE_BUILD_MIN_TRIS triangles or more use the
    native builder, which raises where it cannot be built."""
    v0, e1, e2 = gpu_scene.triangle_corners()
    v0n, e1n, e2n = (x.cpu().numpy() for x in (v0, e1, e2))
    p1, p2 = v0n + e1n, v0n + e2n
    tmin = np.minimum(np.minimum(v0n, p1), p2)
    tmax = np.maximum(np.maximum(v0n, p1), p2)
    build = (build_bvh_native if tmin.shape[0] >= NATIVE_BUILD_MIN_TRIS
             else build_bvh)
    bvh, levels = build(tmin, tmax, leaf_size=leaf_size)
    return bvh.to(v0.device), levels, (v0, e1, e2)
