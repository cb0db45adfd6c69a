"""Build the port's CUDA kernels and run chosen kernel phases of chip_smoke.py.

    python3 tools/torch_kernel_check.py [--phases culled,warp] [--ptxas]

The short call to make after a kernel changes: with `--ptxas` every source
under `kajiya_tpu_torch/csrc/` is first compiled with `-Xptxas -v`, which
prints each kernel's registers, shared memory and spills; then the chosen
phases of `chip_smoke.py` (brute, culled, warp, tileshift; none for "") hold
the kernels against their plain versions at the 1080p frame's shapes and time
them. The cases go to `chiprun_out/torch_kernel_check.json`. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report():
    from kajiya_tpu_torch.ops import _native

    for name in _native.SOURCES:
        out = subprocess.run(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             os.path.join(_native.CSRC, name), "-o", os.devnull],
            capture_output=True, text=True)
        print(f"--- {name} (nvcc exit {out.returncode})")
        print(out.stdout + out.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="culled,warp")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.ptxas:
        ptxas_report()
    dev = torch.device("cuda", 0)
    report = {"card": card}
    for phase in filter(None, args.phases.split(",")):
        report[phase] = getattr(chip_smoke, f"{phase}_phase")(dev)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "torch_kernel_check.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
