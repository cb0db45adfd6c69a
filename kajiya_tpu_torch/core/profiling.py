"""Per-pass profiler ranges, frame timing and traces (port of
`kajiya_tpu/core/profiling.py`).

`pass_scope(name)` is `torch.profiler.record_function`: each pass shows up as
a named range in a `torch.profiler` trace, with the device time of the
kernels it launched. Outside a profiler it adds only a small host cost per
range. The frame's ranges: `tlas_refit` (the trace scene's refresh and,
on the BVH route, the refit, where a frame or `Renderer.draw` after a
change to the scene tables makes one), `sky_env`, `gbuffer`, `reprojection`,
`ssao`, `shadow_trace`, `shadow_denoise`, `gi_validate`, `gi_trace` (with
`trace` and `shade` inside, and `attrs`, `sun_nee`, `light_nee`, `ambient`,
`screen_reuse` inside each hit-lighting call; on a textured scene
`tex_fetch`, the four texture fetches of each attribute fetch, inside
`gbuffer` and `attrs`), `rtdgi` (with `restir` >
`spatial0` / `spatial1`, `resolve`, `temporal` inside), `sky_ambient`,
`sky_refl`, `sky_bg`, `deferred`, `wrc`, `dof`, `post`; the path tracer's
frame: `refpt` (with `trace`, `sun_nee`, `light_nee` per bounce) and `post`.
Inside any trace, `ray_sort` (a sorted wavefront's key sort) and `cull` (the
culled tracer's host-side beam cull). `tools/torch_frame_profile.py`
reports them.

`FrameTimer` smooths frame dt over the last frames as the reference's main
loop does (`main_loop.rs:398`); `time_wall_ms` is the median wall time of a
call that waits for the devices its outputs lie on; `start_trace` /
`stop_trace` write a Chrome trace of a `torch.profiler` session.
"""
from __future__ import annotations

import os
import time
from collections import deque

import torch


def pass_scope(name: str):
    """Annotate a pass for the profiler."""
    return torch.profiler.record_function(name)


class FrameTimer:
    """dt filter over the last N frames (`main_loop.rs:398-420`)."""

    def __init__(self, window: int = 10):
        self.samples = deque(maxlen=window)
        self._last = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
        self._last = now
        return self.dt

    @property
    def dt(self) -> float:
        if not self.samples:
            return 1.0 / 60.0
        return sum(self.samples) / len(self.samples)

    @property
    def fps(self) -> float:
        return 1.0 / max(self.dt, 1e-9)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _synchronize(out):
    """Wait for every CUDA device that a tensor of `out` (nested dicts,
    tuples and lists) lies on."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def time_wall_ms(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall ms of `fn(*args)`, each call ended by a synchronize of
    its outputs' devices (the port's `time_jitted`: eager, no trace)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _synchronize(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


_trace = None      # the running start_trace session: (profiler, logdir)


def start_trace(logdir: str):
    """Begin a `torch.profiler` trace of the host and, where there is one,
    the CUDA device."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace = (prof, logdir)


def stop_trace() -> str:
    """End the trace and write it into its logdir as a Chrome trace
    (chrome://tracing, Perfetto); returns the file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running")
    prof, logdir = _trace
    _trace = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
