"""The BVH walk kernel (csrc/bvh.cu `bvh_walk_kernel`): its wrapper.

The kernel replaces the lockstep `lax.while_loop` walk of
`kajiya_tpu/rt/trace.py::_traverse`; its plain versions are
`rt/trace.py::walk_ordered_plain` (closest-hit calls without a step cap,
walked front to back) and `walk_plain` (any-hit calls and capped calls, the
skip-link walk), which `trace_closest` / `trace_shadow` take for CPU tensors
only. `walk_launch` takes CUDA tensors, launches on the current stream,
reads nothing back and raises on anything the kernel does not take.
"""
from __future__ import annotations

import torch

from . import _native
from .woop_cuda import _check, _empty_hits


def walk_launch(bvh, tris, tables, org, d, t_min, tmax, any_hit: bool,
                max_steps=None, counts: bool = False):
    """Launch the walk on CUDA tensors: `bvh` a `rt.bvh.Bvh` of tensors,
    `tris` the (v0, e1, e2) world SoA, `tables` the kernel's (nodes,
    leaves, pairs) of `rt.bvh.pack_walk_tables(bvh, tris)`, packed where the
    BVH is built or refit (`TraceScene.walk_tables`); org / d (R, 3), tmax
    (R,) float32. Returns (t, tri, u, v) and, with `counts`, also the
    per-ray int32 node visits and triangle tests (a checking launch)."""
    from ..rt.trace import walk_depth

    _native.check_cuda(org, d, tmax)
    if tables is None:
        raise ValueError("bvh_walk: no packed tables (TraceScene.walk_tables "
                         "or rt.bvh.pack_walk_tables)")
    nodes, leaves, pairs = tables
    _native.check_cuda(nodes, leaves, pairs)
    r, n, n_slots = org.shape[0], bvh.num_nodes, bvh.tri_order.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(org, (r, 3), f32)
    _check(d, (r, 3), f32)
    _check(tmax, (r,), f32)
    _check(nodes, (n, 8), f32)
    _check(leaves, (n_slots, 12), f32)
    _check(pairs, (n, 16), f32)
    outs = _empty_hits(r, org.device)
    cnt = ((torch.empty((r,), dtype=i32, device=org.device),
            torch.empty((r,), dtype=i32, device=org.device)) if counts
           else (None, None))
    if r > 0:
        counter = torch.empty((1,), dtype=i32, device=org.device)
        lib = _native.library()
        status = lib.kt_bvh_walk(
            org.data_ptr(), d.data_ptr(), tmax.data_ptr(), float(t_min),
            nodes.data_ptr(), n, leaves.data_ptr(), pairs.data_ptr(),
            int(bvh.leaf_size), walk_depth(tris[0].shape[0], bvh.leaf_size),
            r, int(any_hit), -1 if max_steps is None else int(max_steps),
            counter.data_ptr(), *(x.data_ptr() for x in outs),
            *(None if x is None else x.data_ptr() for x in cnt),
            _native.stream_ptr(org))
        _native.check_status("bvh_walk", status)
        _native.launches["bvh_walk"] += 1
    return outs + cnt if counts else outs
