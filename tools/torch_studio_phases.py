"""The studio city's phases of `chip_smoke.py` alone on the card (158.8 s with
the kernels' build on an NVIDIA H100 80GB HBM3 at 700.00 W): every asset
city written, the studio maps decoded and timed against their writer's
texels, the studio fixtures, the textured path at 1080p on tcity and
tcitystudio in one call (their bakes timed by format, launches and host
syncs counted), and the small GPU-vs-CPU textured frames on tcitystudio4
(pages equal, each plane's share within GI_FRAME_TOL and its mean
difference). Writes chiprun_out/studio_phases.json.

    python3 tools/torch_studio_phases.py
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402
from kajiya_tpu_torch.ops import _native  # noqa: E402


def main():
    t_all = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _native.library()
    c.log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp()
    ibl = os.path.join(tmp, "sky.hdr")
    c.write_panorama(ibl)
    scenes, maps = c.asset_scenes(tmp)
    c.SCENES.update(scenes)
    fmt = c.format_phase({k: v for k, v in maps.items()
                          if os.sep + "studio" + os.sep in k})
    fix = c.studio_phase()
    dev = torch.device("cuda", 0)
    c.PATH_SCENES["textured"] = ("tcity", "tcitystudio")
    frames = c.frame_phase(dev, "textured", ibl)
    make, eye, fwd, step = c.SCENES["tcitystudio4"]
    outs, pages = {}, {}
    for d in (dev, torch.device("cpu")):
        run = c.PathRun("textured", make, d, 64, 48, small_ircache=True)
        for v in run.views(eye, fwd, step, 4, d):
            o = run.step(v)
        outs[d.type], pages[d.type] = o, run.r.gpu.tex_pages
    small = {"pages_equal": bool(torch.equal(pages["cuda"].cpu(),
                                             pages["cpu"]))}
    for k in c.FRAME_KEYS["textured"]:
        diff = (outs["cuda"][k].cpu() - outs["cpu"][k]).abs()
        small[k] = (float((diff <= c.GI_FRAME_TOL[0]).float().mean()),
                    float(diff.mean()))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/studio_phases.json", "w") as f:
        json.dump({"formats": fmt, "fixtures": fix, "frames": frames,
                   "small": small}, f, indent=1, default=str)
    print(json.dumps({
        "decode_ms": {k: round(v["ms"], 1) for k, v in fmt.items()},
        "fixture_ms": {k: v.get("ms") for k, v in fix.items()},
        "bake": {k: v["bake"] for k, v in frames.items()},
        "frame_ms": {k: v["frame_ms"] for k, v in frames.items()},
        "launches": {k: v["launches"] for k, v in frames.items()},
        "host_syncs": {k: v["host_syncs"] for k, v in frames.items()},
        "small": small, "wall_s": time.perf_counter() - t_all}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
