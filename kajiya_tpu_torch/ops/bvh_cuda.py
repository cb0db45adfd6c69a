"""The skip-link BVH walk kernel (csrc/bvh.cu `bvh_walk_kernel`): its
wrapper.

The kernel replaces the lockstep `lax.while_loop` walk of
`kajiya_tpu/rt/trace.py::_traverse`; its plain version is
`rt/trace.py::walk_plain`, which `trace_closest` / `trace_shadow` take for
CPU tensors only. `walk_launch` takes CUDA tensors, launches on the current
stream, reads nothing back and raises on anything the kernel does not take.
"""
from __future__ import annotations

import torch

from . import _native
from .woop_cuda import _check, _empty_hits


def walk_launch(bvh, tris, org, d, t_min, tmax, any_hit: bool,
                max_steps=None, counts: bool = False):
    """Launch the walk on CUDA tensors: `bvh` a `rt.bvh.Bvh` of tensors,
    `tris` the (v0, e1, e2) world SoA, org / d (R, 3), tmax (R,) float32.
    Returns (t, tri, u, v) and, with `counts`, also the per-ray int32 node
    visits and triangle tests (a checking launch)."""
    v0, e1, e2 = tris
    node_arrays = (bvh.node_first, bvh.node_count, bvh.node_skip)
    _native.check_cuda(org, d, tmax, bvh.node_min, bvh.node_max,
                       *node_arrays, bvh.tri_order, v0, e1, e2)
    r, n, n_tris = org.shape[0], bvh.node_min.shape[0], v0.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(org, (r, 3), f32)
    _check(d, (r, 3), f32)
    _check(tmax, (r,), f32)
    for x in (bvh.node_min, bvh.node_max):
        _check(x, (n, 3), f32)
    for x in node_arrays:
        _check(x, (n,), i32)
    _check(bvh.tri_order, (bvh.tri_order.shape[0],), i32)
    for x in tris:
        _check(x, (n_tris, 3), f32)
    outs = _empty_hits(r, org.device)
    cnt = ((torch.empty((r,), dtype=i32, device=org.device),
            torch.empty((r,), dtype=i32, device=org.device)) if counts
           else (None, None))
    if r > 0:
        lib = _native.library()
        status = lib.kt_bvh_walk(
            org.data_ptr(), d.data_ptr(), tmax.data_ptr(), float(t_min),
            bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
            *(x.data_ptr() for x in node_arrays), n,
            bvh.tri_order.data_ptr(), v0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), r, int(any_hit),
            -1 if max_steps is None else int(max_steps),
            *(x.data_ptr() for x in outs),
            *(None if x is None else x.data_ptr() for x in cnt),
            _native.stream_ptr(org))
        _native.check_status("bvh_walk", status)
        _native.launches["bvh_walk"] += 1
    return outs + cnt if counts else outs
