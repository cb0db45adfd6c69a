"""Scene-level ray queries (port of the dispatch of `kajiya_tpu/rt/trace.py`).

`scene_trace_closest` / `scene_trace_shadow` are the software `TraceRay` of
every pass. Scenes up to 262,144 triangles carry Woop tables and go to the
intersector kernels (ops/woop_cuda.py): the culled kernel where the scene
has cluster tables, the brute kernel otherwise. On CUDA tensors the kernels
run; on CPU tensors their plain versions. The BVH walk for larger scenes and
the sorted wavefront (`sort=True`, ops/raysort.py) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.woop_cuda import INF, intersect_scene


@dataclass
class Hit:
    """Closest-hit payload (~ `GbufferRayPayload`, inc/rt.hlsl)."""
    t: torch.Tensor     # (R,) f32, 1e30 = miss
    tri: torch.Tensor   # (R,) int32, -1 = miss
    u: torch.Tensor     # (R,) f32 barycentric
    v: torch.Tensor     # (R,) f32 barycentric

    @property
    def hit_mask(self):
        return self.tri >= 0

    def map(self, fn):
        return Hit(fn(self.t), fn(self.tri), fn(self.u), fn(self.v))


def _woop_or_raise(ts, sort: bool):
    if ts.woop is None:
        raise NotImplementedError(
            "scenes above 262,144 triangles need the BVH walk "
            "(ROADMAP section 1, step 2); not ported yet")
    if sort:
        raise NotImplementedError(
            "sorted wavefronts (ops/raysort.py) come with the secondary-ray "
            "passes (ROADMAP section 1, step 3); not ported yet")
    return ts.woop


def scene_trace_closest(ts, org, d, t_min=1e-4, t_max=INF, max_steps=None,
                        sort: bool = False, rb=None) -> Hit:
    """Closest hit against a TraceScene."""
    woop = _woop_or_raise(ts, sort)
    t, tri, u, v = intersect_scene(woop, org, d, t_min=t_min, t_max=t_max,
                                   rb=rb)
    return Hit(t=t, tri=tri, u=u, v=v)


def scene_trace_shadow(ts, org, d, t_min=1e-4, t_max=INF, max_steps=None,
                       sort: bool = False, rb=None):
    """Occlusion against a TraceScene -> (R,) bool (~ `rt_is_shadowed`)."""
    woop = _woop_or_raise(ts, sort)
    _t, tri, _u, _v = intersect_scene(woop, org, d, t_min=t_min, t_max=t_max,
                                      any_hit=True, rb=rb)
    return tri >= 0
