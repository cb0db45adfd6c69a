"""Scene-level ray queries (port of the dispatch of `kajiya_tpu/rt/trace.py`).

`scene_trace_closest` / `scene_trace_shadow` are the software `TraceRay` of
every pass. Scenes up to 262,144 triangles carry Woop tables and go to the
intersector kernels (ops/woop_cuda.py): the culled kernel where the scene
has cluster tables, the brute kernel otherwise. On CUDA tensors the kernels
run; on CPU tensors their plain versions. Divergent batches (GI, bounce and
validation rays) ask for `sort=True`: where the culled kernel runs they are
traced as a key-sorted wavefront in 128-ray chunks (ops/raysort.py). The BVH
walk for larger scenes is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.raysort import SORT_RAY_BLOCK, sorted_trace
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


def _woop_or_raise(ts):
    if ts.woop is None:
        raise NotImplementedError(
            "scenes above 262,144 triangles need the BVH walk "
            "(ROADMAP section 1, step 2); not ported yet")
    return ts.woop


def _can_sort(ts, sort: bool) -> bool:
    """Wavefront sorting only pays where the culled tracer runs (scenes with
    cluster tables); small brute scenes would pay the sort for nothing."""
    return (sort and isinstance(ts.woop, dict)
            and ts.woop.get("cmin64") is not None)


def scene_trace_closest(ts, org, d, t_min=1e-4, t_max=INF, max_steps=None,
                        sort: bool = False, rb=None) -> Hit:
    """Closest hit against a TraceScene. `rb` overrides the culled kernel's
    rays per chunk; sorted wavefronts default to SORT_RAY_BLOCK."""
    woop = _woop_or_raise(ts)
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
    woop = _woop_or_raise(ts)
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
