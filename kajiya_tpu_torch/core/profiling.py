"""Per-pass profiler ranges (port of `kajiya_tpu/core/profiling.py::pass_scope`).

`pass_scope(name)` is `torch.profiler.record_function`: each pass shows up as
a named range in a `torch.profiler` trace, with the device time of the
kernels it launched. Outside a profiler it adds only a small host cost per
range. The frame's ranges: `tlas_refit` (the trace scene's refresh and,
on the BVH route, the refit, where a frame or `Renderer.draw` after a move
makes one), `sky_env`, `gbuffer`, `reprojection`, `ssao`,
`shadow_trace`, `shadow_denoise`, `gi_validate`, `gi_trace` (with `trace`
and `shade` inside, and `attrs`, `sun_nee`, `light_nee`, `ambient`,
`screen_reuse` inside each hit-lighting call; on a textured scene
`tex_fetch`, the four texture fetches of each attribute fetch, inside
`gbuffer` and `attrs`), `rtdgi` (with `restir` >
`spatial0` / `spatial1`, `resolve`, `temporal` inside), `sky_ambient`,
`sky_refl`, `sky_bg`, `deferred`, `wrc`, `dof`, `post`; the path tracer's
frame: `refpt` (with `trace`, `sun_nee`, `light_nee` per bounce) and `post`.
Inside any trace, `ray_sort` (a sorted wavefront's key sort) and `cull` (the
culled tracer's host-side beam cull). `tools/torch_frame_profile.py`
reports them.
"""
from __future__ import annotations

import torch


def pass_scope(name: str):
    """Annotate a pass for the profiler."""
    return torch.profiler.record_function(name)
