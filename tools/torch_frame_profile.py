"""Where a 1080p frame of the PyTorch port spends its time, per scene.

    python3 tools/torch_frame_profile.py [--frames 3]
        [--path raster|gi|default|options|refpt|textured]
        [--scenes cornell,city]

Renders one ported path of `kajiya_tpu_torch` at 1920x1080 ("raster": the
raster + sun-shadow frame; "gi": that plus SSAO, RTDGI and ReSTIR GI;
"default": the default `RenderConfig`, which adds the irradiance cache, RTR,
TAA with the jitter and motion blur; "options": that plus the traced
g-buffer, the world radiance cache, depth of field and an IBL sky;
"refpt": progressive frames of the reference path tracer, 16 bounces, 1
spp; "textured": the default frame on the textured cornell and the textured
asset city, which the tool writes as `chip_smoke.py` does, with the device
time of the four texture fetches of one 1080p g-buffer and the bake time)
on the scenes of `chip_smoke.py` (`--scenes`, default cornell,city; city40
is the 1,228,802-triangle city of the BVH route, whose traces are the BVH
walk kernel's launches) through
`chip_smoke.PathRun`, three warm-up frames and then `--frames` frames under
`torch.profiler` (CPU + CUDA activity; with the default 3 frames from frame
index 3 on, one of them validates the reservoirs). Prints per
scene: wall ms per frame, the device busy share (summed kernel, copy and set
time over wall time; the port runs on one stream, so they do not overlap),
host ms, device span, summed kernel time and launches per pass
(`core/profiling.py::pass_scope` ranges) and
the kernels with the most device time. The whole report goes to
`chiprun_out/torch_frame_profile_<path>.json`. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = ("tlas_refit", "sky_env", "gbuffer", "reprojection", "ircache", "ssao",
          "shadow_trace", "shadow_denoise", "gi_validate", "gi_trace",
          "wrc", "rtdgi", "rtr", "sky_ambient", "sky_refl", "sky_bg",
          "deferred", "taa", "motion_blur", "dof", "refpt", "post")
# ranges nested inside the passes above (reported, not summed with them)
SUB_PASSES = ("ircache_alloc", "ircache_trace", "ircache_value_grid", "trace",
              "shade", "attrs", "sun_nee", "light_nee", "ambient",
              "screen_reuse", "restir", "spatial0", "spatial1", "resolve",
              "temporal", "rtr_restir", "rtr_resolve", "rtr_temporal",
              "filter_input", "closest_vel", "warp9", "filter_history",
              "input_prob", "unjitter", "tiles", "taps", "ray_sort", "cull",
              "tex_fetch")
WARMUP = 3


def _launches(event):
    """Kernels launched inside a profiler range (its ops' and their
    children's)."""
    return len(event.kernels) + sum(_launches(c) for c in event.cpu_children)


def _add_range(acc, e, scale):
    """Add one profiler event of a named range to `acc`: its host time and,
    from the host event, the summed device time and count of the kernels
    launched inside it; the device-side event gives the span from its first
    kernel's start to its last kernel's end (idle gaps included)."""
    if e.device_type == torch.autograd.DeviceType.CUDA:
        acc["device_ms"] += e.time_range.elapsed_us() / 1e3 * scale
        return
    acc["host_ms"] += e.time_range.elapsed_us() / 1e3 * scale
    acc["kernel_ms"] += e.device_time_total / 1e3 * scale
    acc["launches"] += _launches(e) * scale


def gbuffer_fetch_ms(run, view):
    """The texture fetch (the `tex_fetch` range) of one raster g-buffer at
    the run's size, under the profiler: device span, summed kernel time,
    host time and launches."""
    from kajiya_tpu_torch.renderers import gbuffer

    cfg = run.cfg
    gbuffer.raster_gbuffer(run.r.ts, view, cfg.width, cfg.height)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        gbuffer.raster_gbuffer(run.r.ts, view, cfg.width, cfg.height)
        torch.cuda.synchronize()
    out = dict.fromkeys(("device_ms", "kernel_ms", "host_ms", "launches"), 0.0)
    for e in prof.events():
        if e.name == "tex_fetch":
            _add_range(out, e, 1.0)
    return out


def profile_scene(name, frames, path, ibl):
    from chip_smoke import HEIGHT, SCENES, WIDTH, PathRun

    make, eye, fwd, step = SCENES[name]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    run = PathRun(path, make, dev, WIDTH, HEIGHT, ibl=ibl)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    vs = run.views(eye, fwd, step, frames + WARMUP, dev)
    for v in vs[:WARMUP]:
        run.step(v)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for v in vs[WARMUP:]:
            run.step(v)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    cuda = torch.autograd.DeviceType.CUDA
    per_pass = {p: dict.fromkeys(("device_ms", "kernel_ms", "host_ms",
                                  "launches"), 0.0)
                for p in PASSES + SUB_PASSES}
    kern = {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.name in per_pass:
            # a pass is a host range plus, on newer PyTorch, a device range
            # spanning its kernels (idle gaps between them included)
            _add_range(per_pass[e.name], e, 1.0 / frames)
        elif e.device_type == cuda:
            n, t = kern.get(e.name, (0, 0.0))
            kern[e.name] = (n + 1, t + us)
    busy_ms = sum(t for _, t in kern.values()) / 1e3 / frames
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:15]
    extra = {}
    if path == "textured":
        extra = {"setup_s_with_bake": setup_s,
                 "gbuffer_tex_fetch": gbuffer_fetch_ms(run, vs[-1])}
    return {**extra,
        "wall_ms_per_frame": wall_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_frame": sum(n for n, _ in kern.values()) / frames,
        "passes": {p: per_pass[p] for p in PASSES},
        "sub_passes": {p: per_pass[p] for p in SUB_PASSES
                       if per_pass[p]["host_ms"] > 0.0},
        "top_kernels": [{"name": k[:120], "device_ms": t / 1e3 / frames,
                         "count_per_frame": n / frames}
                        for k, (n, t) in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--path", choices=("raster", "gi", "default", "options",
                                       "refpt", "textured"),
                    default="default")
    ap.add_argument("--scenes", default="cornell,city",
                    help="comma-separated chip_smoke.SCENES names "
                         "(textured: its own two)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    from chip_smoke import PATH_SCENES, SCENES, asset_scenes, write_panorama

    report = {"card": card, "frames": args.frames, "path": args.path}
    tmp = tempfile.mkdtemp(prefix="torch_frame_profile_")
    ibl = os.path.join(tmp, "sky.hdr")
    write_panorama(ibl)
    names = tuple(filter(None, args.scenes.split(",")))
    if args.path == "textured":
        SCENES.update(asset_scenes(tmp)[0])
        names = PATH_SCENES["textured"]
    for name in names:
        rep = profile_scene(name, args.frames, args.path, ibl)
        report[name] = rep
        print(f"{name}: wall {rep['wall_ms_per_frame']:.2f} ms/frame, device "
              f"busy {rep['device_busy_ms_per_frame']:.2f} ms "
              f"({100 * rep['device_busy_share']:.1f}%), "
              f"{rep['kernel_launches_per_frame']:.0f} kernels/frame")
        if "gbuffer_tex_fetch" in rep:
            f = rep["gbuffer_tex_fetch"]
            print(f" setup with the bake {rep['setup_s_with_bake']:.1f} s; "
                  "one 1080p g-buffer's texture fetch: kernels "
                  f"{f['kernel_ms']:.3f} ms in {f['launches']:.0f} launches, "
                  f"device span {f['device_ms']:.3f} ms, host "
                  f"{f['host_ms']:.3f} ms")
        for group in ("passes", "sub_passes"):
            print(f" {group}:")
            for p, v in sorted(rep[group].items(),
                               key=lambda kv: -kv[1]["device_ms"]):
                print(f"  {p:15s} device span {v['device_ms']:8.3f} ms  "
                      f"kernels {v['kernel_ms']:8.3f} ms  host "
                      f"{v['host_ms']:8.3f} ms  launches "
                      f"{v['launches']:6.0f}")
        for k in rep["top_kernels"][:10]:
            print(f"  {k['device_ms']:8.3f} ms x{k['count_per_frame']:.0f} "
                  f"{k['name'][:90]}")
    print(card)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    out = os.path.join(REPO, "chiprun_out",
                       f"torch_frame_profile_{args.path}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
