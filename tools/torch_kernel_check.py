"""Build the port's CUDA kernels and run chosen kernel phases of chip_smoke.py.

    python3 tools/torch_kernel_check.py [--phases culled,warp,bvh] [--ptxas]
        [--sass] [--against TREE]
    python3 tools/torch_kernel_check.py --count-sass chiprun_out/woop.sass

The short call to make after a kernel changes: with `--ptxas` every source
under `kajiya_tpu_torch/csrc/` is first compiled with `-Xptxas -v`, which
prints each kernel's registers, shared memory and spills; with `--sass` the
SASS of csrc/woop.cu (`cuobjdump -sass`) goes to `chiprun_out/woop.sass`
and kernel B's innermost loops are counted (`sass_loops`; `--count-sass`
counts a saved listing, without a device);
then the chosen phases of `chip_smoke.py` (brute, culled, warp, tileshift,
bvh; none for "") hold the kernels against their plain versions at the
1080p frame's shapes and time them (`--phases bvh`: the BVH walk on the six
wavefronts of the 1,228,802-triangle city40). The cases go to
`chiprun_out/torch_kernel_check.json`. Needs a CUDA device.

Kernel B can be timed beside another build of itself on the brute phase's
inputs, in the same process, each checked against the plain version:
`--against TREE` builds TREE's csrc/woop.cu (a checkout from before the
(T, 24) table, whose B reads the (T, 21) rows) and times it before and after
this tree's B (with `brute` among the phases).

With `bvh` among the phases, `--against TREE` builds TREE's csrc/bvh.cu (a
checkout from before the packed tables: the skip-link walk over the build's
arrays, one thread a ray) and this tree's csrc/bvh.cu, each with
`-Xptxas -v` (registers and spills are printed), and times them on the bvh
phase's six city40 wavefronts and the path tracer's bounce-2 sun NEE
wavefront in turns (TREE, this, this, TREE). This tree's build must return
the package's launch bit for bit; TREE's must equal it on the any-hit and
the capped cases and, on the closest-hit cases that this tree walks front
to back, differ from it only as chip_smoke.ordered_differences allows. It
also times, on the two divergent closest-hit wavefronts, a key sort of the
rays (ops/raysort.py::ray_sort_key on the BVH's root box) before this
tree's walk, with the results scattered back, against the walk on the rays
as they come.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report():
    """Each source compiled with -Xptxas -v: the whole report goes to
    chiprun_out/ptxas.txt; each kernel's registers, shared memory and
    spills are printed."""
    from kajiya_tpu_torch.ops import _native

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = []
    for name in _native.SOURCES:
        out = subprocess.run(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             os.path.join(_native.CSRC, name), "-o", os.devnull],
            capture_output=True, text=True)
        text = out.stdout + out.stderr
        report.append(f"--- {name} (nvcc exit {out.returncode})\n{text}")
        print(f"--- {name} (nvcc exit {out.returncode})", flush=True)
        if out.returncode:
            print(text, flush=True)
        kernel = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("registers" in line or "spill" in line):
                print(f"{kernel[-60:]}: {line.strip()}", flush=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write("\n".join(report))


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"^(?:@!?U?P\w+\s+)?BRA(?:\.\w+)*\s+(?:!?U?P\w+,\s*)?"
                  r"(0x[0-9a-f]+)")


def sass_loops(sass, kernel="woop_brute"):
    """The innermost loops of every function of a `cuobjdump -sass` listing
    whose name holds `kernel`: per loop its address range, instructions and
    divisions (MUFU.RCP: one per ray x triangle test of the Woop kernels).
    A loop with one division and no branch around it issues its
    instructions once a test (the first kernel B: 90); where the exact test
    sits behind branches, read the listing for the length of each path."""
    out = []
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        if kernel not in name:
            continue
        insns = [(int(a, 16), t) for a, t in _INSN.findall(chunk)
                 if not t.startswith("NOP")]
        loops = []
        for addr, text in insns:
            m = _BRA.match(text)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in loops)]
        for lo, hi in inner:
            body = [t for a, t in insns if lo <= a <= hi]
            out.append(dict(function=name, start=hex(lo), end=hex(hi),
                            instructions=len(body),
                            divisions=sum(t.startswith("MUFU.RCP")
                                          for t in body)))
    return out


def sass_dump():
    """cuobjdump -sass of csrc/woop.cu, written to chiprun_out/woop.sass."""
    from kajiya_tpu_torch.ops import _native

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, "woop.cubin")
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-cubin",
                    os.path.join(_native.CSRC, "woop.cu"), "-o", cubin],
                   check=True)
    tool = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(out_dir, "woop.sass"), "w") as f:
        f.write(sass)
    os.remove(cubin)
    print(f"--- woop.sass: {len(sass.splitlines())} lines", flush=True)
    for loop in sass_loops(sass):
        print(f"--- loop {loop}", flush=True)


def build_brutes(specs):
    """Each (source, tag, counts_arg) built alone into a library, all nvcc
    processes at once; returns the ctypes handles with kt_woop_brute bound
    (without the counts argument for a tree from before it: counts_arg
    False)."""
    import hashlib

    from kajiya_tpu_torch.ops import _native

    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    jobs = []
    for source, tag, _ in specs:
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        so = os.path.join(_native.BUILD_DIR, f"brute_{tag}_{digest}.so")
        jobs.append((so, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", source, "-o",
             so])))
    libs = []
    for (so, proc), (source, _, counts_arg) in zip(jobs, specs):
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {source}")
        lib = ctypes.CDLL(so)
        argtypes = list(_native._SIGNATURES["kt_woop_brute"])
        if not counts_arg:
            del argtypes[-2]
        lib.kt_woop_brute.argtypes = argtypes
        lib.kt_woop_brute.restype = ctypes.c_int
        lib.counts_arg = counts_arg
        libs.append(lib)
    return libs


def time_brute_build(dev, lib, table_key, label, inputs):
    """One build of kernel B on the brute phase's inputs: bits against the
    plain version (any-hit: the mask), then its time over 20 launches."""
    import chip_smoke
    from kajiya_tpu_torch.ops import _native
    from kajiya_tpu_torch.ops import woop_cuda as wc

    cases = []
    for name, (ts, rays, plain) in inputs.items():
        table = ts.woop[table_key]

        def launch(o, dd, tm, t_min, any_hit):
            outs = wc._empty_hits(o.shape[0], o.device)
            status = lib.kt_woop_brute(
                o.data_ptr(), dd.data_ptr(), tm.data_ptr(), table.data_ptr(),
                o.shape[0], table.shape[0], float(t_min), int(any_hit),
                *(x.data_ptr() for x in outs),
                *([None] if lib.counts_arg else []), _native.stream_ptr(o))
            _native.check_status(f"woop_brute ({label})", status)
            return outs

        for case, (o, dd, tm, t_min, any_hit) in rays.items():
            chip_smoke.compare_exact(f"{label}/{name}/{case}",
                                     launch(o, dd, tm, t_min, any_hit),
                                     plain[case], any_hit)
            ms = chip_smoke.time_ms(
                lambda: launch(o, dd, tm, t_min, any_hit), 20, graph=True)
            cases.append(dict(build=label, case=f"{name}/{case}", ms=ms))
            print(f"woop_brute [{label}] {name}/{case}: {ms:.4f} ms",
                  flush=True)
    return cases


def brute_builds(dev, against):
    """Kernel B of another tree before, then after this tree's B, on the
    brute phase's inputs."""
    import chip_smoke
    from kajiya_tpu_torch.ops import woop_cuda as wc

    inputs = {}
    for name in ("cornell", "city3"):
        ts, rays = chip_smoke.brute_inputs(dev, name)
        plain = {case: wc.brute_plain(ts.woop["coef_rows"], o, dd, tm, t_min)
                 for case, (o, dd, tm, t_min, _a) in rays.items()}
        inputs[name] = (ts, rays, plain)
    here = os.path.join(REPO, "kajiya_tpu_torch", "csrc", "woop.cu")
    this, other = build_brutes([
        (here, "this", True),
        (os.path.join(against, "kajiya_tpu_torch", "csrc", "woop.cu"),
         "against", False)])
    runs = time_brute_build(dev, other, "coef_rows", "against", inputs)
    runs += time_brute_build(dev, this, "coef_rows24", "this", inputs)
    runs += time_brute_build(dev, other, "coef_rows", "against", inputs)
    return runs


# the walk's C interface before the packed tables: org, dir, tmax, t_min,
# node_min, node_max, node_first, node_count, node_skip, n_nodes, tri_order,
# v0, e1, e2, n_rays, any_hit, max_steps, t / tri / u / v out, visits,
# tests, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARRAYS_WALK_ARGS = [_P, _P, _P, _F, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                    _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]


def build_walks(specs):
    """Each (label, source) of the walk built alone, every nvcc at
    once, each with -Xptxas -v ("against": the interface before the packed
    tables). Returns {label: ctypes handle} and {label: [register / spill
    lines]}."""
    import hashlib

    from kajiya_tpu_torch.ops import _native

    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    jobs = []
    for label, source in specs:
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        so = os.path.join(_native.BUILD_DIR, f"walk_{label}_{digest}.so")
        jobs.append((label, so, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", source, "-o", so], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for label, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the walk {label}:\n{out}")
        regs[label] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln]
        for ln in regs[label]:
            print(f"bvh_walk [{label}] {ln}", flush=True)
        lib = ctypes.CDLL(so)
        lib.kt_bvh_walk.argtypes = (ARRAYS_WALK_ARGS if label == "against"
                                    else _native._SIGNATURES["kt_bvh_walk"])
        lib.kt_bvh_walk.restype = ctypes.c_int
        libs[label] = lib
    return libs, regs


def walk_call(lib, label, ts, o, dd, tm, t_min, any_hit, cap):
    """A launch of one build of the walk -> (t, tri, u, v)."""
    from kajiya_tpu_torch.ops import _native
    from kajiya_tpu_torch.ops.woop_cuda import _empty_hits
    from kajiya_tpu_torch.rt.trace import walk_depth

    bvh, (v0, e1, e2) = ts.bvh, ts.tris
    outs = _empty_hits(o.shape[0], o.device)
    steps = -1 if cap is None else int(cap)
    if label == "against":
        status = lib.kt_bvh_walk(
            o.data_ptr(), dd.data_ptr(), tm.data_ptr(), float(t_min),
            bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
            bvh.node_first.data_ptr(), bvh.node_count.data_ptr(),
            bvh.node_skip.data_ptr(), bvh.num_nodes,
            bvh.tri_order.data_ptr(), v0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), o.shape[0], int(any_hit), steps,
            *(x.data_ptr() for x in outs), None, None, _native.stream_ptr(o))
    else:
        nodes, leaves, pairs = ts.walk_tables
        counter = torch.empty((1,), dtype=torch.int32, device=o.device)
        status = lib.kt_bvh_walk(
            o.data_ptr(), dd.data_ptr(), tm.data_ptr(), float(t_min),
            nodes.data_ptr(), bvh.num_nodes, leaves.data_ptr(),
            pairs.data_ptr(), bvh.leaf_size,
            walk_depth(v0.shape[0], bvh.leaf_size), o.shape[0], int(any_hit),
            steps,
            counter.data_ptr(), *(x.data_ptr() for x in outs), None, None,
            _native.stream_ptr(o))
    _native.check_status(f"bvh_walk ({label})", status)
    return outs


def pt_sun_wavefront(ts, dev, bounce=2):
    """The sun NEE shadow wavefront (any-hit) of the path tracer's bounce
    `bounce` of frame 0 on city40 at 1080p, as `path_trace` hands it to the
    trace: the ended paths and the points the sun cannot light as dead
    lanes (t_max 0)."""
    import chip_smoke
    from kajiya_tpu_torch.renderers import reference

    _make, eye, fwd, _step = chip_smoke.SCENES["city40"]
    view = chip_smoke.views(eye, fwd, (0, 0, 0), 1, chip_smoke.WIDTH,
                            chip_smoke.HEIGHT, dev)[0]
    calls = []
    trace = reference.scene_trace_shadow

    def record(ts_, org, d, **kw):
        calls.append((org.contiguous(), d.contiguous(),
                      kw["t_max"].contiguous(), kw["t_min"]))
        return trace(ts_, org, d, **kw)

    reference.scene_trace_shadow = record
    try:
        reference.render_sample(ts, view, chip_smoke.WIDTH, chip_smoke.HEIGHT,
                                0, num_bounces=bounce + 1)
    finally:
        reference.scene_trace_shadow = trace
    org, d, tmax, t_min = calls[bounce]
    return org, d, tmax, t_min, True, None


def walk_builds(dev, against):
    """The walk of TREE and of this tree, timed in turns on the six city40
    wavefronts and on the path tracer's bounce-2 sun NEE wavefront
    (any-hit, its ended paths dead lanes); then the key-sort
    measurement."""
    import chip_smoke
    from kajiya_tpu_torch.ops import bvh_cuda

    ts, inputs = chip_smoke.bvh_inputs(dev)
    inputs["pt_bounce2_sun_any_hit"] = pt_sun_wavefront(ts, dev)
    libs, regs = build_walks(
        [("against", os.path.join(against, "kajiya_tpu_torch", "csrc",
                                  "bvh.cu")),
         ("this", os.path.join(REPO, "kajiya_tpu_torch", "csrc", "bvh.cu"))])
    want, differing = {}, {}
    for case, (o, dd, tm, t_min, any_hit, cap) in inputs.items():
        old = walk_call(libs["against"], "against", ts, o, dd, tm, t_min,
                        any_hit, cap)
        this = bvh_cuda.walk_launch(ts.bvh, ts.tris, ts.walk_tables, o, dd,
                                    t_min, tm, any_hit, cap)
        if any_hit or cap is not None:
            if not all(torch.equal(a, b) for a, b in zip(old, this)):
                raise AssertionError(f"bvh_walk [against] {case}: hits "
                                     "differ from this tree's")
        else:
            differing[case] = chip_smoke.ordered_differences(
                case, this, old, o, dd, ts.tris, t_min, tm)[0]
        want[case] = dict(against=old, this=this)
    runs = []
    for label in ("against", "this", "this", "against"):
        for case, (o, dd, tm, t_min, any_hit, cap) in inputs.items():
            def call(label=label, o=o, dd=dd, tm=tm, t_min=t_min,
                     any_hit=any_hit, cap=cap):
                return walk_call(libs[label], label, ts, o, dd, tm, t_min,
                                 any_hit, cap)

            got = call()
            if not all(torch.equal(a, b)
                       for a, b in zip(got, want[case][label])):
                raise AssertionError(f"bvh_walk [{label}] {case}: hits "
                                     "differ from the first launch")
            ms = chip_smoke.time_ms(call, 5)
            runs.append(dict(build=label, case=case, ms=ms))
            print(f"bvh_walk [{label}] {case}: {ms:.4f} ms", flush=True)
    return dict(runs=runs, registers=regs,
                rays_differing_from_against=differing,
                sort=walk_sort(dev, ts, inputs))


def walk_sort(dev, ts, inputs):
    """This tree's walk on the GI + reflection and the PT bounce-2
    wavefronts: the rays as they come, against a stable key sort of the
    rays (ray_sort_key on the BVH's root box, at the sorted culled
    wavefronts' key bits and at the key's own defaults) before the walk,
    with the results scattered back (the same bits); the walk on the sorted
    rays is timed alone too."""
    import chip_smoke
    from kajiya_tpu_torch.ops import bvh_cuda
    from kajiya_tpu_torch.ops.raysort import (SORT_DBITS, SORT_OBITS,
                                              ray_sort_key)

    bvh, tris = ts.bvh, ts.tris
    smin, smax = bvh.node_min[0], bvh.node_max[0]
    out = []
    for case in ("gi_rtr_closest", "pt_bounce2_closest"):
        o, dd, tm, t_min, any_hit, cap = inputs[case]

        def walk(o, dd, tm):
            return bvh_cuda.walk_launch(bvh, tris, ts.walk_tables, o, dd,
                                        t_min, tm, any_hit, cap)

        base = walk(o, dd, tm)
        plain_ms = chip_smoke.time_ms(lambda: walk(o, dd, tm), 5)
        for obits, dbits in ((SORT_OBITS, SORT_DBITS), (5, 3)):
            def sorted_walk(obits=obits, dbits=dbits):
                key = ray_sort_key(o, dd, smin, smax, obits, dbits)
                perm = torch.sort(key, stable=True)[1]
                res = walk(o[perm], dd[perm], tm[perm])
                inv = torch.empty_like(perm)
                inv[perm] = torch.arange(perm.shape[0], device=dev)
                return tuple(x[inv] for x in res)

            got = sorted_walk()
            if not all(torch.equal(a, b) for a, b in zip(got, base)):
                raise AssertionError(f"bvh_walk sort {case}: the sorted "
                                     "walk's hits differ")
            perm = torch.sort(ray_sort_key(o, dd, smin, smax, obits, dbits),
                              stable=True)[1]
            so, sd, stm = o[perm], dd[perm], tm[perm]
            walk_only = chip_smoke.time_ms(lambda: walk(so, sd, stm), 5)
            total = chip_smoke.time_ms(sorted_walk, 5)
            out.append(dict(case=case, obits=obits, dbits=dbits,
                            unsorted_ms=plain_ms, sorted_total_ms=total,
                            sorted_walk_ms=walk_only))
            print(f"bvh_walk sort {case} ({obits}, {dbits}): unsorted "
                  f"{plain_ms:.4f} ms, sort + walk + scatter {total:.4f} "
                  f"ms (walk {walk_only:.4f} ms)", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="culled,warp")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--against", default=None)
    ap.add_argument("--count-sass", default=None, metavar="FILE",
                    help="print the brute kernel's loops of a saved "
                         "cuobjdump -sass listing and exit (no device)")
    args = ap.parse_args()
    if args.count_sass:
        with open(args.count_sass) as f:
            for loop in sass_loops(f.read()):
                print(json.dumps(loop))
        return 0
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
    if args.sass:
        sass_dump()
    dev = torch.device("cuda", 0)
    report = {"card": card}
    for phase in filter(None, args.phases.split(",")):
        report[phase] = getattr(chip_smoke, f"{phase}_phase")(dev)
    if args.against and "brute" in args.phases.split(","):
        report["brute_builds"] = brute_builds(dev, args.against)
    if args.against and "bvh" in args.phases.split(","):
        report["walk_builds"] = walk_builds(dev, args.against)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "torch_kernel_check.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
