"""Chip smoke test of the PyTorch/CUDA port (kajiya_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each kernel (B brute Woop,
C culled Woop, W image warp, S per-tile shift, and the BVH walk of scenes
above 262,144 triangles) against its plain PyTorch version on the card at
the shapes the 1080p frame and the path tracer give it (timing both with
CUDA events; the walk on six wavefronts of the 1,228,802-triangle city40,
bit for bit with its visit and test counts, its front-to-back closest hits
also held against the skip-link walk's), checks the GPU path against the
CPU path on small frames of every path (the default and path-tracer frames
also forced through the BVH route; the super-resolution frame shown 1.5
times its render size; the CPU side rendered in worker processes while the
card runs the kernel phases), then renders at 1920x1080, on the cornell
box (32 triangles, brute kernel B) and on the 196,610-triangle procedural
city (culled kernel C), and on city40 (the BVH walk; 2 default and 2
path-tracer frames, its set-up timed: scene tables, native BVH build, trace
scene; every instance moved before the second default frame, which refits
the BVH, its `tlas_refit` range timed and its launches counted):
- 2 frames of the raster + sun-shadow path;
- 4 frames of the diffuse-GI path (SSAO, sorted secondary-ray wavefront,
  ReSTIR temporal + spatial, resolve);
- 4 frames of the default frame (`RenderConfig(width=1920, height=1080)`:
  that plus the irradiance cache, RTR with mesh-light specular on cornell,
  the pre-exposure split, TAA with the Halton jitter and motion blur);
- 2 progressive frames of the reference path tracer
  (`render_frame_reference`: 16 bounces, 1 spp, the gaussian pixel filter);
- 2 frames of the default frame with the last four options on (traced
  g-buffer, world radiance cache, depth of field, an IBL sky from an .hdr
  panorama the script writes);
- the textured path, the default frame on textured scenes: 4 frames of the
  textured cornell (a 32x32 checker Lanczos-resized to 128) and 2 of the
  textured city, an asset scene the script writes (three building glTFs with
  2048^2 base colour, metallic-roughness and normal maps, one with a 1024^2
  emissive map, a ground GLB with a 4096x2048 RGBA data-URI PNG, and a .ron
  placing them as the procedural city does: 196,610 triangles) and loads
  with `apps.view.build_scene`, its bake timed, and 2 each of the same city
  with its maps written in the mixed formats (JPEG, BC5 / BC7 DDS, 16-bit
  PNG), in the legacy formats (32-bit RLE TGA base colours, 24-bit BMP
  normal maps, 256-colour GIF metallic-roughness maps, a lossless WebP
  emissive map) and as TIFFs (LZW tiled base colours with horizontal
  differencing, deflate planar normal maps, big-endian 16-bit PackBits
  metallic-roughness maps, a raw emissive map with Orientation 6) and in
  the formats art and game pipelines emit (4-channel PackBits PSD base
  colours, RLE SGI normal maps, 24-bit RLE PCX metallic-roughness maps, a
  QOI emissive map) and as TIFFs of the later codecs (zstd tiled base
  colours with differencing, zstd 16-bit planar big-endian normal maps,
  ThunderScan 4-bit grey metallic-roughness maps, a CCITT Group 4 bilevel
  emissive window mask) and in PIL's smaller plugins (LZW LAB TIFF base
  colours, 24-bit RLE Sun raster normal maps, XPM metallic-roughness maps
  of at most 256 colours, an ICNS emissive map whose best member is a
  1024^2 PNG), each bake timed by format,
with the launch counters set to 0 just before each path and read just after,
each map of the mixed, legacy, TIFF, studio, TIFF-codec and plugin cities
decoded on the host
equal to the texels its writer reports (the JPEGs within JPEG_PSNR_DB, the
LAB maps to the SHA-256 PIL gave for them), the
committed WebP fixtures (tests/data/webp/: lossy, lossy with alpha,
lossless, animated), TIFF fixtures (tests/data/tiff/: JPEG-in-TIFF YCbCr
2x2, LZMA, the floating-point predictor, CMYK, BigTIFF, tiles, CCITT RLE /
RLEW / Group 3 / Group 4, zstd, ThunderScan, old-style JPEG 4:2:0 and 4:4:4,
LAB; SGILog what the bake turns white), studio
fixtures (tests/data/studio/: BLP1 JPEG
and palette, BLP2 palette, DXT1 / 3 / 5, FTEX raw and DXT1, PSD CMYK,
indexed and bitmap, PCX of 2 and 4 bit planes and 8-bit palette, DCX, PFM,
16-bit PGM, a LAB PSD; BLP2 raw BGRA, which PIL cannot decode, must raise
what the bake turns white) and plugin fixtures (tests/data/plugins/: LAB
TIFFs and PSDs, ICNS, GBR, IPTC, XBM, XPM, Sun rasters, MSP, XV thumbnail,
IMT, PIXAR) decoded on the host to the RGBA digests PIL gave for them,
and the host syncs of each frame counted (the textured frames may make no
more than the untextured default frames of the same geometry). Then the
oracle datum (the port's hybrid frame against its path tracer on cornell at
64x48, held to tests/test_oracle.py's bounds), two runs of the headless
viewer in a subprocess (the path tracer on cornell; one building glTF of
the textured city through the bake cache), and the apps a user starts: the
live viewer (`apps.stream` on the city at 1920x1080: /snap, MJPEG parts of
/stream, four /set requests with `last_error` null throughout, and the
emissive multiplier on a cornell server), `apps.hello`, and hot reload
(`core/reload.py` in a copy of the package: a pass module and kernel W's
source edited, the kernel library rebuilt and W held to its plain
version). Last, the sharded phase (kajiya_tpu_torch/parallel/): four ranks
started with torch.multiprocessing share the card over gloo (NCCL refuses
two ranks on one card; each rank's bands of CUDA tensors are staged through
pinned host buffers), rank 0 builds each scene and `distribute_scene` sends
it to the others (bit for bit, by digest), and they render tile-sharded
frames at 1920x1080 on cornell (kernel B) and on the city (kernel C) in
bands of 272, 272, 272 and 264 rows, each rank launching B or C, W and S
(its counts held to `expected_launches`): 2 of the GI path, held to the
same frames on the whole card at GI_FRAME_TOL (state planes relative to
max(1, |value|)), 3 jittered frames of the default frame (as `Renderer`
resolves it: mesh-light specular on cornell; the full irradiance cache,
whose tables every rank holds whole), 2 of the options frame (the default
frame with the traced g-buffer, the full world radiance cache, its atlas
split over the ranks' probes, and depth of field) and 3 of temporal
super-resolution (the default frame rendered at 1280x720 and shown at
1920x1080, the output planes in bands of their own), whose gathered
outputs and every state plane must equal the whole card's bit for bit, as
must every rank's irradiance-cache tables; every frame's collective log is
held to `check_sharding_quality`; one (2, 2) multi-host GI frame of
the city is held to the four-tile frame, and the city's 1080p camera rays
through `shard_rays_pt` (16 bounces) to `path_trace`. A rank that fails
fails the run with its traceback. Prints one JSON line of the sharded phase
(backend, bands; per path and scene the frame ms, launches and collectives
by kind per rank and frame, the whole card's frame ms, inter-host bytes;
wall time) and one of per-kernel numbers; the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": 1}}.
Any failed check raises, so the exit code is not 0 and no result is printed.
Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

import torch

WIDTH, HEIGHT = 1920, 1080
N_FRAMES = {"raster": 2, "gi": 4, "default": 4,   # frames per scene of each
            "refpt": 2, "options": 2, "textured": 4}  # path
PT_BOUNCES = 16
T_TOL = 2e-5          # t agreement where the kernel and plain ids agree
ID_AGREE = 0.999      # fraction of rays whose triangle ids agree
WARP_TOL = 1e-6       # warp kernel vs plain sampler, absolute
# GPU path vs CPU path of the small frame: per-pixel bound, fraction of
# pixels within it, mean abs bound; and the fraction of pixels whose primary
# triangle ids agree. The kernels agree bit for bit with their plain versions,
# but the plain PyTorch ops around them (cos/sin/exp/log, summation order)
# round differently on the card by an ulp or so; that flips the occasional
# sun ray that grazes an edge, and the a-trous filter spreads each flip over
# a 15 x 15 neighbourhood.
FRAME_TOL = (1e-3, 0.97, 5e-4)
HIT_AGREE = 0.995
# The GI path adds decisions that one ulp flips (reservoir takes, geometry
# and occlusion gates, shadow rays at secondary hits); a flipped lane changes
# its whole payload and the spatial passes, the resolve and the temporal
# filter spread it. Bounds per output: fraction of pixels within 5e-3, and
# the mean absolute difference (an H100 run showed >= 0.9986 and <= 2.4e-5).
GI_FRAME_TOL = (5e-3, 0.97, 1e-3)
# The path tracer's small frames: one ulp can send a path elsewhere at any of
# its 16 bounces, and a path that differs differs by its whole radiance
# (the emitter is 20), so the mean bound is looser than the GI frame's.
PT_FRAME_TOL = (5e-3, 0.97, 1e-2)
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20
OPS_PER_VISIT = 30    # fp32 ops per ray x triangle Woop test
# the BVH walk's own fp32 arithmetic (csrc/bvh.cu, compares not counted):
# the slab test of a node visit, 6 subtractions, 6 multiplications and 10
# min / max; a Moller-Trumbore triangle test, two crosses (9 each), four
# dot products (5 each), 3 subtractions, 3 multiplications, 1 division and
# the u + v addition
OPS_PER_NODE = 22
OPS_PER_MT_TEST = 46
# the front-to-back walk against the skip-link walk: at most 1 ray in
# 100,000 may pick another triangle, each a valid hit of its ray within
# ORDER_T_TOL max(1, |t|) of the other (rays with two hits within rounding
# of each other, where a box test's rounding hides one at one t_best and
# not at another)
ORDER_DIFF_SHARE = 1e-5
ORDER_T_TOL = 1e-5
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_ms(fn, reps, graph=False):
    """Mean device time of fn() over `reps` calls, after one warm-up. With
    `graph` the calls are captured into one CUDA graph and a replay is
    timed: a kernel of a few tens of microseconds ends before the host has
    enqueued the next eager call, so an eager loop would time the host."""
    fn()
    torch.cuda.synchronize()
    run, n = fn, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run, n = g.replay, 1
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_cold_ms(make_call, nbytes, reps=20):
    """Mean device time of a launch whose inputs are not in the L2:
    `make_call()` returns a call closed over its own copy of the inputs
    (`nbytes` read and written a call). Enough copies are made to span twice
    the card's L2, the launches cycle through them inside one CUDA graph and
    every launch's output is kept, so no launch finds what an earlier one
    left in the L2."""
    copies = max(2, -(-2 * L2_BYTES // nbytes))
    calls = [make_call() for _ in range(copies)]
    for call in calls:
        call()
    torch.cuda.synchronize()
    outs = []
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for k in range(reps):
            outs.append(calls[k % copies]())
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(stop) / reps


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the irradiance cache and the world radiance cache of the small GPU-vs-CPU
# frames (the defaults trace 16,384 x 4 and 196,608 rays a frame, which the
# CPU path would take minutes over on the city)
SMALL_IRCACHE = dict(max_entries=4096, active_budget=1024)
SMALL_WRC = dict(grid=(4, 2, 4), probe_res=8)
# the temporal super-resolution factor of the "superres" path: a 1280x720
# render shown at 1920x1080, where output rows fall between render rows
SUPERRES = 1.5


def slice_cfg(width, height, path="raster", small_ircache=False):
    """The configuration of a ported path: "raster" (raster + sun shadows),
    "gi" (that plus SSAO, RTDGI and ReSTIR GI), "default" (the default
    `RenderConfig`, every default flag on; "textured" is the same frame on
    textured scenes), "options" (that plus the traced g-buffer, the world
    radiance cache and depth of field; the IBL sky is the Renderer's),
    "superres" (the default frame rendered at width x height and shown
    SUPERRES times larger by TAA's temporal super-resolution, as the
    viewer's `--temporal-upsampling 1.5` does) or "refpt" (the default
    config, which the path tracer's frame reads for its size and
    exposure)."""
    from kajiya_tpu_torch.frame import RenderConfig
    from kajiya_tpu_torch.renderers.ircache import IrcacheConfig
    from kajiya_tpu_torch.renderers.wrc import WrcConfig

    if path in ("default", "textured", "options", "superres", "refpt"):
        kw = ({"ircache": IrcacheConfig(**SMALL_IRCACHE)} if small_ircache
              else {})
        if path == "options":
            kw.update(primary="trace", use_wrc=True, use_dof=True)
            if small_ircache:
                kw.update(wrc=WrcConfig(**SMALL_WRC))
        if path == "superres":
            kw.update(temporal_upsampling=SUPERRES)
        return RenderConfig(width=width, height=height, **kw)
    gi = path == "gi"
    return RenderConfig(width=width, height=height, primary="raster",
                        sun_soft_shadows=True, use_ssao=gi, use_rtdgi=gi,
                        use_restir_gi=gi, secondary_full_shading=True,
                        use_rtr=False, use_taa=False, use_ircache=False,
                        use_motion_blur=False)


SCENES = {
    # name: (scene factory, eye, forward, per-frame eye step)
    "cornell": (lambda p: p.cornell_box(), (0.0, 0.0, 2.4), (0.0, 0.0, -1.0),
                (0.01, 0.005, 0.0)),
    "city": (lambda p: p.city(n=16, subdiv=8), (0.0, 14.0, 28.0),
             (0.0, -0.45, -1.0), (0.05, 0.0, -0.05)),
    # the largest scene the brute route serves: 9 x 768 + 2 = 6,914
    # triangles (BRUTE_FORCE_MAX_TRIS is 8,192), no cluster tables, so every
    # trace goes to kernel B; from 9 units out and 4 up, looking slightly
    # down the middle street, the nine buildings fill most of the screen
    # (camera rays at 64x48: 87% hit a building, 5% the ground, 8% miss)
    "city3": (lambda p: p.city(n=3, subdiv=8), (0.0, 4.0, 9.0),
              (0.0, -0.15, -1.0), (0.02, 0.0, -0.02)),
    # the BVH route at the scale of the reference's battle.ron:
    # city(n=40), 40 x 40 x 768 + 2 = 1,228,802 triangles (above
    # CULLED_BRUTE_MAX_TRIS, so every trace goes to the BVH walk), seen as
    # the city is, from 2.5 times as far and with 2.5 times its step
    "city40": (lambda p: p.city(n=40, subdiv=8), (0.0, 36.0, 69.0),
               (0.0, -0.45, -1.0), (0.125, 0.0, -0.125)),
    # the textured cornell: a checker on the floor; every trace goes to B
    "tcornell": (lambda p: p.textured_cornell_box(), (0.0, 0.0, 2.4),
                 (0.0, 0.0, -1.0), (0.01, 0.005, 0.0)),
    # "tcity" (the textured asset city, n=16), "tcity4" (n=4, the small
    # frames' version), "tcityfmt" (the mixed-format asset city, n=16:
    # JPEG, BC5 / BC7 DDS and 16-bit PNG maps), "tcitylegacy" /
    # "tcitylegacy4" (the legacy-format asset city, n=16 / n=4 with 256^2
    # maps: RLE TGA, BMP, GIF and lossless WebP maps) and "tcitytiff" /
    # "tcitytiff4" (the TIFF-textured asset city, n=16 / n=4 with 256^2
    # maps) and "tcitystudio" / "tcitystudio4" (the studio-format asset
    # city: PSD, SGI, PCX and QOI maps) and "tcitycodec" / "tcitycodec4"
    # (the TIFF-codec city: zstd, ThunderScan and CCITT Group 4 maps) and
    # "tcityplugins" / "tcityplugins4" (the plugin city: LAB TIFF, RLE Sun
    # raster, XPM and ICNS maps) are added by main once `asset_scenes`
    # wrote them
}
# the scenes each path renders at 1080p, and a cap on the frames of a scene
# (city3 shows kernel B at the brute route's limit on the two paths that
# trace the most through it)
PATH_SCENES = {"raster": ("cornell", "city"), "gi": ("cornell", "city"),
               "default": ("cornell", "city", "city3", "city40"),
               "refpt": ("cornell", "city", "city3", "city40"),
               "options": ("cornell", "city"),
               "textured": ("tcornell", "tcity", "tcityfmt", "tcitylegacy",
                            "tcitytiff", "tcitystudio", "tcitycodec",
                            "tcityplugins")}
FRAME_CAP = {"city3": 2, "tcity": 2, "tcityfmt": 2, "tcitylegacy": 2,
             "tcitytiff": 2, "tcitystudio": 2, "tcitycodec": 2,
             "tcityplugins": 2, "city40": 2}
# the untextured scene of the same geometry, whose default frames the
# textured frames' host syncs are held to
UNTEXTURED = {"tcornell": "cornell", "tcity": "city", "tcityfmt": "city",
              "tcitylegacy": "city", "tcitytiff": "city",
              "tcitystudio": "city", "tcitycodec": "city",
              "tcityplugins": "city"}
# the decoded JPEG maps of the mixed-format city against the arrays they
# encode (quality 85, 4:2:0): format_phase reads 42.2-48.8 dB
JPEG_PSNR_DB = 35.0
# the scenes whose frames on a path move every instance once, by MOVE,
# before frame MOVE_FRAME (`Renderer.set_transforms`), so that a counted
# frame refits the BVH inside its `tlas_refit` range
MOVED = {"default": ("city40",)}
MOVE, MOVE_FRAME = (0.05, 0.0, 0.0), 1
# the format cities `asset_scenes` writes, as (formats, directory under the
# root), and the scene name of each (a city of SMALL_FORMATS also has a
# small version, its name with a "4" added)
CITIES = (("mixed", "fmt"), ("legacy", "legacy"), ("tiff", "tiff"),
          ("studio", "studio"), ("tiffcodec", "codec"),
          ("plugins", "plugins"))
CITY_SCENES = {"mixed": "tcityfmt", "legacy": "tcitylegacy",
               "tiff": "tcitytiff", "studio": "tcitystudio",
               "tiffcodec": "tcitycodec", "plugins": "tcityplugins"}
# the small frames' legacy, TIFF, studio, TIFF-codec and plugin cities:
# their maps at 256^2, since a 64x48 frame needs no more, and two bakes of
# the full maps would cost ~25 s on an NVIDIA H100 80GB HBM3 host at
# 700.00 W
SMALL_FORMATS = ("legacy", "tiff", "studio", "tiffcodec", "plugins")


def asset_scenes(root):
    """Write the textured city's assets under `root` (scene/assets.py) and
    return the SCENES entries "tcity" (n=16, 196,610 triangles, seen as the
    city is) and "tcity4" (n=4, the small frames' scene), each loaded
    through the viewer's `build_scene` from its .ron, "tcityfmt" (the
    mixed-format city under `root/fmt`, n=16, seen as the city is) and
    "tcitylegacy" (the legacy-format city under `root/legacy`, n=16) and
    "tcitylegacy4" (n=4, its maps at 256^2, the small frames' scene), and
    likewise "tcitytiff" / "tcitytiff4" (the TIFF-textured city under
    `root/tiff`), "tcitystudio" / "tcitystudio4" (the studio-format city
    under `root/studio`), "tcitycodec" / "tcitycodec4" (the TIFF-codec
    city under `root/codec`) and "tcityplugins" / "tcityplugins4" (the
    plugin city under `root/plugins`), with the mixed, legacy, TIFF,
    studio, TIFF-codec and plugin maps written: {file path: (map, RGBA its
    file decodes to, or None for a JPEG or a LAB TIFF)}."""
    from kajiya_tpu_torch.scene import assets

    def write(job):
        formats, sub = job
        if sub is None:
            return assets.write_city_assets(root)
        if sub.endswith("_small"):
            return assets.write_city_assets(
                os.path.join(root, sub), map_size=256, emissive_size=128,
                ground_size=(256, 512), formats=formats)
        return assets.write_city_assets(os.path.join(root, sub),
                                        formats=formats)

    # the cities are written on threads: their zlib, LZW and numpy work
    # runs outside the interpreter lock (55.6 s one after another, 14.2 s on
    # seven threads, on an 8-core x86-64 host)
    t0 = time.perf_counter()
    jobs = [("png", None)] + list(CITIES) + [(f, f"{f}_small")
                                             for f in SMALL_FORMATS]
    with ThreadPoolExecutor(max_workers=8) as pool:
        written = dict(zip(jobs, pool.map(write, jobs)))
    maps = {}
    for formats, sub in CITIES:
        sub_root = os.path.join(root, sub)
        assets.write_city_ron(sub_root, n=16, name=f"city{sub}")
        maps.update({os.path.join(sub_root, "meshes", k): v
                     for k, v in written[formats, sub].items()})
    for n in (16, 4):
        assets.write_city_ron(root, n=n, name=f"city{n}")
    for formats in SMALL_FORMATS:
        assets.write_city_ron(os.path.join(root, f"{formats}_small"), n=4,
                              name=f"city{formats}4")
    log(f"the textured cities' assets written in "
        f"{time.perf_counter() - t0:.1f} s under {root}")
    return asset_scene_entries(root), maps


def asset_scene_entries(root):
    """The SCENES entries of the asset cities that `asset_scenes` wrote
    under `root`, each loaded through the viewer's `build_scene` from its
    .ron (a process of its own rebuilds them from `root` alone)."""
    from kajiya_tpu_torch.apps.view import build_scene

    _, eye, fwd, step = SCENES["city"]
    near = (0.0, 8.0, 14.0)

    def scene(ron, at):
        path = os.path.join(root, ron)
        return (lambda p: build_scene(path), at, fwd, step)

    entries = {"tcity": scene("scenes/city16.ron", eye),
               "tcity4": scene("scenes/city4.ron", near)}
    for formats, sub in CITIES:
        entries[CITY_SCENES[formats]] = scene(
            f"{sub}/scenes/city{sub}.ron", eye)
    for formats in SMALL_FORMATS:
        entries[CITY_SCENES[formats] + "4"] = scene(
            f"{formats}_small/scenes/city{formats}4.ron", near)
    return entries


def format_phase(maps):
    """The mixed-format, legacy-format, TIFF and studio cities' maps decoded
    on the host by the port's decoders: each DDS map (BC5 normals, BC7
    metallic-roughness), the 16-bit PNG, every legacy map (RLE TGA, BMP,
    GIF, lossless WebP), every TIFF map (LZW tiles with differencing,
    deflate planar strips, big-endian 16-bit PackBits, raw with an
    Orientation), every studio map (PackBits PSD, RLE SGI, RLE PCX, QOI) and
    every TIFF-codec map (zstd RGB tiles with differencing, zstd 16-bit
    planar big-endian, ThunderScan 4-bit grey, a CCITT Group 4 mask) and
    every plugin map but the LAB ones (RLE Sun raster, XPM, ICNS with a PNG
    member) equal the texels their writer reports, bit for bit; each JPEG
    base colour is within JPEG_PSNR_DB of the map it encodes; each LAB base
    colour (converted as LittleCMS does) has the SHA-256 that PIL gave for
    that very map (tests/data/plugins/manifest.json, "city/..."). The
    bytes themselves are held to PIL in the CPU tests (this host has no
    PIL). Any failed decode raises."""
    import hashlib

    from kajiya_tpu_torch.scene import (dds, jpeg, lab, raster, textures,
                                        tiff, webp)

    # the host decoders are built first: each decode ms leaves out g++
    # (raster.library holds the PCX, SGI, PackBits, QOI and DXT loops too)
    t0 = time.perf_counter()
    for build in (jpeg.decoder_library, dds.bcn_library, raster.library,
                  webp.library, tiff.library, tiff.zstd_library, lab.nodes):
        build()
    with open(os.path.join(REPO, "tests", "data", "plugins",
                           "manifest.json")) as f:
        pil_digests = {k: v for k, v in json.load(f).items()
                       if v.get("city_map")}
    log(f"host decoders built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for path, (img, want) in sorted(maps.items()):
        t0 = time.perf_counter()
        got = textures._decode_image(path)
        ms = (time.perf_counter() - t0) * 1e3
        # the city's folder and the file: the TIFF and TIFF-codec cities
        # share their maps' names
        name = os.path.join(os.path.basename(os.path.dirname(os.path.dirname(
            path))), os.path.basename(path))
        rec = dict(ms=ms, bytes=os.path.getsize(path),
                   shape=list(got.shape))
        city_map = "city/" + os.path.basename(path)
        if want is None and path.endswith(".tif"):
            digest = hashlib.sha256(got.tobytes()).hexdigest()
            pil = pil_digests[city_map]
            if list(got.shape) != pil["shape"] or \
                    digest != pil["rgba_sha256"]:
                raise AssertionError(f"{name}: LAB map digest {digest}, "
                                     f"PIL's {pil['rgba_sha256']}")
            rec.update(pil_sha256_equal=True)
        elif want is None:
            mse = float(((got[..., :3].astype(np.float64) - img) ** 2).mean())
            psnr = 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))
            if not psnr >= JPEG_PSNR_DB:
                raise AssertionError(f"{name}: PSNR {psnr:.2f} dB < "
                                     f"{JPEG_PSNR_DB}")
            rec.update(psnr_db=float(psnr))
        elif not np.array_equal(got, want):
            bad = int((got != want).any(-1).sum())
            raise AssertionError(f"{name}: {bad} texels differ from the "
                                 "writer's")
        else:
            rec.update(exact=True)
        out[name] = rec
        log(f"format {name}: {rec}")
    return out


def fixture_phase(kind):
    """The committed fixtures of tests/data/<kind>/ (made by
    tools/make_<kind>_fixtures.py) decoded on the host by the port: each
    one's RGBA must have the shape and SHA-256 that PIL gave where the
    fixtures were made (manifest.json); one marked "unported" must raise
    NotImplementedError. This holds WebP's lossy VP8 path, its alpha and
    the animation container, TIFF's JPEG-in-TIFF, LZMA, floating-point
    predictor, CMYK, BigTIFF and tiles, the studio formats the studio
    city does not carry, and LAB, ICNS and the small plugins, on a machine
    without PIL. One marked "white" (a file PIL cannot decode) must raise
    what the bake turns white (OSError or ValueError); the plugin city's
    LAB maps ("city_map") are format_phase's."""
    import hashlib

    from kajiya_tpu_torch.scene import textures

    root = os.path.join(REPO, "tests", "data", kind)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, want in sorted(manifest.items()):
        if want.get("city_map"):
            continue
        t0 = time.perf_counter()
        if want.get("white"):
            try:
                textures._decode_image(os.path.join(root, name))
            except (OSError, ValueError) as e:
                out[name] = dict(white=str(e)[:80])
                log(f"{kind} fixture {name}: {out[name]}")
                continue
            raise AssertionError(f"{kind} fixture {name} decoded; PIL "
                                 "cannot, and the bake turns it white")
        if want.get("unported"):
            try:
                textures._decode_image(os.path.join(root, name))
            except NotImplementedError as e:
                out[name] = dict(unported=str(e)[:80])
                log(f"{kind} fixture {name}: {out[name]}")
                continue
            raise AssertionError(f"{kind} fixture {name} decoded; the port "
                                 "should raise NotImplementedError")
        got = textures._decode_image(os.path.join(root, name))
        ms = (time.perf_counter() - t0) * 1e3
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        if list(got.shape) != want["shape"] or digest != want["rgba_sha256"]:
            raise AssertionError(f"{kind} fixture {name}: shape "
                                 f"{list(got.shape)} digest {digest}, PIL's "
                                 f"{want['shape']} {want['rgba_sha256']}")
        out[name] = dict(ms=ms, bytes=want["bytes"], shape=want["shape"],
                         sha256_equal=True)
        log(f"{kind} fixture {name}: {out[name]}")
    return out


def webp_phase():
    """The WebP fixtures against PIL's digests (fixture_phase)."""
    return fixture_phase("webp")


def tiff_phase():
    """The TIFF fixtures against PIL's digests (fixture_phase)."""
    return fixture_phase("tiff")


def studio_phase():
    """The studio fixtures (BLP, FTEX, PSD, PCX, DCX, PFM, 16-bit PGM)
    against PIL's digests (fixture_phase)."""
    return fixture_phase("studio")


def plugin_phase():
    """The plugin fixtures (LAB TIFF and PSD, ICNS, GBR, IPTC, XBM, XPM,
    SUN, MSP, XV thumbnail, IMT, PIXAR) against PIL's digests
    (fixture_phase)."""
    return fixture_phase("plugins")


def _lookup(owner, name):
    return owner[name] if isinstance(owner, dict) else getattr(owner, name)


def _assign(owner, name, value):
    if isinstance(owner, dict):
        owner[name] = value
    else:
        setattr(owner, name, value)


class Stopwatch:
    """Seconds spent in named functions while active: each, a module
    attribute or a dict entry, is wrapped for the duration and restored
    after (as pt_wavefront records the path tracer's traces)."""

    def __init__(self, **targets):
        self.targets = targets           # label -> (module or dict, name)
        self.seconds = dict.fromkeys(targets, 0.0)
        self.errors = []                 # (label, exception) raised inside

    def __enter__(self):
        self.saved = {}
        for label, (mod, name) in self.targets.items():
            fn = _lookup(mod, name)
            self.saved[label] = fn

            def timed(*a, _fn=fn, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                except Exception as e:
                    self.errors.append((_label, repr(e)))
                    raise
                finally:
                    self.seconds[_label] += time.perf_counter() - t0
            _assign(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for label, (mod, name) in self.targets.items():
            _assign(mod, name, self.saved[label])


class DeviceSpans:
    """Device ms of each call of one module function while active, from
    CUDA events recorded around it (no host wait; read with `ms()` after a
    synchronize)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.events = mod, name, []

    def __enter__(self):
        self.fn = getattr(self.mod, self.name)

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return self.fn(*a, **k)
            finally:
                stop.record()
                self.events.append((start, stop))
        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)

    def ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def move_instances(r, shift):
    """Translate every instance of the Renderer `r`'s scene by `shift`
    through `set_transforms`; the next draw refits."""
    xf = r.ts.gpu.xforms.clone()
    xf[:, :, 3] += torch.tensor(shift, dtype=xf.dtype, device=xf.device)
    r.set_transforms(xf)


def profiled_kernels(fn):
    """fn() once under torch.profiler (CUDA activity): the count and the
    summed device ms of the kernels, copies and sets it launched."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def refit_record(r, frame_ms, root_before):
    """The refit a moved frame made on the BVH route: the root box must be
    the exact bounds of the moved triangles (min / max are exact) and must
    have moved, and the walk kernel's tables must be a pack of it. One more
    refresh of the same trace scene, and one refit alone, under
    torch.profiler give the launches and the kernel ms of the frame's
    `tlas_refit` range and of `refit_bvh` in it."""
    from kajiya_tpu_torch import frame as frame_mod
    from kajiya_tpu_torch.rt.bvh import refit_bvh

    ts = r.ts
    v0, e1, e2 = ts.tris
    pts = torch.cat([v0, v0 + e1, v0 + e2])
    root = torch.stack([ts.bvh.node_min[0], ts.bvh.node_max[0]])
    if not torch.equal(root, torch.stack([pts.amin(0), pts.amax(0)])):
        raise AssertionError(f"refit: root {root.tolist()} is not the bounds "
                             "of the moved triangles")
    if torch.equal(root, root_before):
        raise AssertionError("refit: the root box did not move")
    # the walk kernel's tables after the move == a pack from scratch of a
    # fresh refit to the moved triangles (a tree from before the packed
    # tables, which tools/torch_frame_ab.sh may drive, has none)
    if getattr(ts, "walk_tables", None) is not None:
        from kajiya_tpu_torch.rt.bvh import pack_walk_tables

        fresh = pack_walk_tables(refit_bvh(ts.bvh, r.levels["levels"], v0,
                                           e1, e2), ts.tris)
        # compared as int32 bits: the int words are NaN patterns as floats
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(ts.walk_tables, fresh)):
            raise AssertionError("refit: the packed walk tables differ from "
                                 "a pack of a fresh refit")
    n, k_ms = profiled_kernels(lambda: frame_mod.refresh_trace_scene(
        ts.gpu, ts.bvh, r.levels))
    n_refit, refit_ms = profiled_kernels(lambda: refit_bvh(
        ts.bvh, r.levels["levels"], v0, e1, e2))
    return dict(frame=MOVE_FRAME, move=MOVE, device_span_ms=frame_ms,
                launches=n, kernel_ms=k_ms, refit_bvh_launches=n_refit,
                refit_bvh_kernel_ms=refit_ms,
                levels=len(r.levels["levels"]), nodes=ts.bvh.num_nodes)


def views(eye, fwd, step, n, width, height, device, jitter=False):
    """The views of `n` frames from frame index 0; `jitter` adds the TAA
    sub-pixel jitter of each frame, as a caller of the default frame does."""
    from kajiya_tpu_torch.core.camera import make_view_constants
    from kajiya_tpu_torch.frame import jitter_for_frame

    out, prev = [], None
    for k in range(n):
        e = tuple(eye[i] + k * step[i] for i in range(3))
        prev = make_view_constants(e, fwd, width=width, height=height,
                                   jitter=jitter_for_frame(k, jitter),
                                   prev=prev, device=device)
        out.append(prev)
    return out


# ----------------------------------------------------------------------------
# Kernel phases
# ----------------------------------------------------------------------------

def compare_hits(name, k_out, p_out, any_hit, live=None):
    t_k, tri_k = k_out[0], k_out[1]
    t_p, tri_p = p_out[0], p_out[1]
    if live is not None:
        t_k, tri_k, t_p, tri_p = t_k[live], tri_k[live], t_p[live], tri_p[live]
    occ_k, occ_p = tri_k >= 0, tri_p >= 0
    mismatch = int((occ_k != occ_p).sum())
    if any_hit:
        if mismatch:
            raise AssertionError(f"{name}: {mismatch} occlusion mismatches")
        return 0.0
    if mismatch:
        raise AssertionError(f"{name}: {mismatch} hit/miss mismatches")
    same = tri_k == tri_p
    agree = float(same[occ_p].float().mean()) if bool(occ_p.any()) else 1.0
    if agree < ID_AGREE:
        raise AssertionError(f"{name}: triangle ids agree on {agree:.6f}")
    both = same & occ_p
    err = 0.0
    for a, b in ((t_k, t_p), (k_out[2], p_out[2]), (k_out[3], p_out[3])):
        if live is not None and a.shape != both.shape:
            a, b = a[live], b[live]
        if bool(both.any()):
            err = max(err, float((a[both] - b[both]).abs().max()))
    if err > T_TOL:
        raise AssertionError(f"{name}: max |t|,|u|,|v| error {err}")
    return err


def ircache_rays(gb, eye, dev):
    """The irradiance cache's entry wavefront of a 1080p frame at the
    default `IrcacheConfig`: entries allocated from the frame's query
    points, then frame 1's rays (fresh uniform-sphere directions), 16,384 x
    4 of them, traced unsorted as the frame traces them."""
    from kajiya_tpu_torch.frame import ircache_queries
    from kajiya_tpu_torch.renderers import ircache

    cfg = ircache.IrcacheConfig()
    st = ircache.init_state(cfg, device=dev)
    q_pos, q_mask = ircache_queries(gb, HEIGHT, WIDTH)
    st = ircache.allocate(st, ircache.build_grid(st, eye, cfg), q_pos, q_mask,
                          eye, 0, cfg)
    rays = ircache.entry_rays(st, 1, cfg)
    return rays["org"].contiguous(), rays["dir"].contiguous()


def pt_wavefront(ts, view, bounce):
    """The closest-hit wavefront of the reference path tracer's bounce
    `bounce` (0 = camera rays) of frame 0 at 1080p: (org, dir, tmax) as
    `path_trace` hands them to the trace, ended paths with tmax 0."""
    from kajiya_tpu_torch.renderers import reference

    calls = []
    trace = reference.scene_trace_closest

    def record(ts_, org, d, **kw):
        calls.append((org, d, kw["t_max"]))
        return trace(ts_, org, d, **kw)

    reference.scene_trace_closest = record
    try:
        reference.render_sample(ts, view, WIDTH, HEIGHT, 0,
                                num_bounces=bounce + 1)
    finally:
        reference.scene_trace_closest = trace
    org, d, tmax = calls[bounce]
    return org.contiguous(), d.contiguous(), tmax.contiguous()


def compare_exact(name, k_out, p_out, any_hit):
    """Kernel B against its plain version: the same bits in t, tri, u and v
    for every ray (closest hit), the same occlusion mask (any-hit, whose
    contract is tri >= 0 only). Returns the largest |t|, |u|, |v|
    difference where both hit the same triangle: 0.0 when it passes."""
    occ_k, occ_p = k_out[1] >= 0, p_out[1] >= 0
    mismatch = int((occ_k != occ_p).sum())
    if mismatch:
        raise AssertionError(f"{name}: {mismatch} hit/miss mismatches")
    if any_hit:
        return 0.0
    same = (k_out[1] == p_out[1]) & occ_p
    err = 0.0
    if bool(same.any()):
        err = max(float((k_out[i][same] - p_out[i][same]).abs().max())
                  for i in (0, 2, 3))
    bad = [k for k, a, b in zip("t tri u v".split(), k_out, p_out)
           if not torch.equal(a, b)]
    if bad:
        n_ids = int((k_out[1] != p_out[1]).sum())
        raise AssertionError(f"{name}: {', '.join(bad)} differ from the plain "
                             f"version ({n_ids} ids, max error {err})")
    return err


def brute_inputs(dev, name):
    """Kernel B's six wavefronts of a 1080p frame on one scene, as case ->
    (org, dir, tmax, t_min, any_hit), and the scene's trace tables."""
    from kajiya_tpu_torch.core.camera import camera_rays
    from kajiya_tpu_torch.ops import woop_cuda as wc
    from kajiya_tpu_torch.renderers import gbuffer, rtdgi, rtr, shadows
    from kajiya_tpu_torch.scene import procedural
    from kajiya_tpu_torch.scene.scene import build_gpu_scene
    from kajiya_tpu_torch.world import build_trace_scene

    make, eye, fwd, _ = SCENES[name]
    ts, _ = build_trace_scene(build_gpu_scene(make(procedural), device=dev),
                              device=dev)
    if ts.woop.get("cmin") is not None:
        raise AssertionError(f"{name}: has cluster tables, not routed to B")
    view = views(eye, fwd, (0, 0, 0), 1, WIDTH, HEIGHT, dev)[0]
    org, d = (x.reshape(-1, 3).contiguous()
              for x in camera_rays(view, WIDTH, HEIGHT))
    gb = gbuffer.raster_gbuffer(ts, view, WIDTH, HEIGHT)
    sorg, sdir, _need = shadows.sun_shadow_rays(ts, gb, 0)
    corg, cdir, _rng = rtdgi.candidate_rays(rtdgi.half_gbuffer(gb), 0)
    rorg, rdir, _pdf, _rng = rtr.reflection_rays(gb, 0)
    worg, wdir = torch.cat([corg, rorg]), torch.cat([cdir, rdir])
    iorg, idir = ircache_rays(gb, view.eye_position, dev)
    porg, pdir, ptmax = pt_wavefront(ts, view, 2)

    def rays(o, dd, tm=None):
        o, dd = o.contiguous(), dd.contiguous()
        return o, dd, wc.ray_tmax(o, None) if tm is None else tm

    cases = {"primary_closest": (*rays(org, d), 1e-4, False),
             "shadow_any_hit": (*rays(sorg, sdir), shadows.RAY_EPS, True),
             "gi_candidates_closest": (*rays(corg, cdir), 1e-4, False),
             "gi_rtr_closest": (*rays(worg, wdir), 1e-4, False),
             "ircache_closest": (*rays(iorg, idir), 1e-4, False),
             "pt_bounce2_closest": (*rays(porg, pdir, ptmax), 1e-4, False)}
    return ts, cases


def brute_phase(dev):
    """Kernel B on the scenes the brute route serves, cornell (32 triangles,
    one shared-memory tile) and city3 (6,914, the route's limit): 1080p
    camera rays (closest), the sun shadow rays (any-hit), the half-res GI
    candidate rays (closest, divergent), the default frame's shared
    wavefront (GI candidates + reflection rays, closest), the irradiance
    cache's entry wavefront (closest) and the path tracer's bounce-2
    wavefront (closest; ended paths are dead lanes). Each must equal the
    plain version bit for bit (any-hit: the occlusion mask). On city3 the
    plain version is timed once, on the call that is compared."""
    from kajiya_tpu_torch.ops import woop_cuda as wc

    cases = []
    for name in ("cornell", "city3"):
        ts, inputs = brute_inputs(dev, name)
        rows, rows24 = ts.woop["coef_rows"], ts.woop["coef_rows24"]
        # the bound counts the scene's triangles; the table's zero rows that
        # pad it to whole blocks are tested too, and can never be hit
        n_tris = int(ts.gpu.num_triangles)
        plain_reps = 3 if n_tris <= 256 else 0
        for case, (o, dd, tm, t_min, any_hit) in inputs.items():
            k_out = wc.brute_launch(rows24, o, dd, tm, t_min, any_hit)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            p_out = wc.brute_plain(rows, o, dd, tm, t_min)
            stop.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(stop)
            err = compare_exact(f"woop_brute/{name}/{case}", k_out, p_out,
                                any_hit)
            # a checking launch: the pairs visited, kept by the rejects and
            # tested exactly (warp-wide); it must return the same bits
            counts = torch.zeros((3,), dtype=torch.int64, device=dev)
            c_out = wc.brute_launch(rows24, o, dd, tm, t_min, any_hit,
                                    counts=counts)
            if not all(torch.equal(a, b) for a, b in zip(c_out, k_out)):
                raise AssertionError(f"woop_brute/{name}/{case}: the checking "
                                     "launch differs")
            visited, kept, exact = (int(x) for x in counts.tolist())
            ms = time_ms(lambda: wc.brute_launch(rows24, o, dd, tm, t_min,
                                                 any_hit), 20, graph=True)
            if plain_reps:
                plain_ms = time_ms(lambda: wc.brute_plain(rows, o, dd, tm,
                                                          t_min), plain_reps)
            r = o.shape[0]
            live = tm > t_min
            # the tests this run needs: dead lanes (tmax <= t_min) none, a
            # live closest-hit ray every triangle, a live any-hit ray the
            # triangles up to its first hit in index order (the plain
            # version gives the closest; the kernel's tri is that first hit)
            if any_hit:
                visits = torch.where(k_out[1] >= 0, k_out[1].long() + 1,
                                     n_tris)
            else:
                visits = torch.full_like(tm, n_tris, dtype=torch.int64)
            visits = float(torch.where(live, visits, 0).sum())
            # the kernel's own count walks the table's padded rows as well
            rows_walked = torch.where(
                k_out[1] >= 0, k_out[1].long() + 1, rows.shape[0]) \
                if any_hit else torch.full_like(tm, rows.shape[0],
                                                dtype=torch.int64)
            want = int(torch.where(live, rows_walked, 0).sum())
            if visited != want:
                raise AssertionError(f"woop_brute/{name}/{case}: the kernel "
                                     f"visited {visited} pairs, expected "
                                     f"{want}")
            bytes_moved = r * (24 + 4 + 16) + n_tris * wc.N_COEF * 4
            b_ms, b_by = bound(bytes_moved, OPS_PER_VISIT * visits)
            cases.append(dict(
                case=f"{name}/{case}", scene=name, rays=r, tris=n_tris,
                table_rows=rows.shape[0],
                live_rays=int(live.sum()), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                visits=visits, ps_per_test=ms * 1e9 / max(visits, 1.0),
                kept_share=kept / max(visited, 1),
                exact_share=exact / max(visited, 1)))
            log(f"woop_brute/{name}/{case}: err {err} kernel {ms:.4f} ms "
                f"plain {plain_ms:.3f} ms bound {b_ms:.5f} ms ({b_by}); "
                f"{cases[-1]['live_rays']} live of {r}, "
                f"{cases[-1]['ps_per_test']:.3f} ps a test; rejects kept "
                f"{cases[-1]['kept_share']:.4f} of the visited pairs, the "
                f"warps tested {cases[-1]['exact_share']:.4f} exactly")
    return cases


def culled_batches(dev):
    """Kernel C's cases on the city at 1080p, as name -> (CulledBatch, t_min,
    any_hit), and the things the sorted wavefronts' overhead and the
    unsorted wavefronts' cull are timed on: for each sorted case its
    unsorted rays and their tmax, and the rays of each unsorted case."""
    from kajiya_tpu_torch.ops import raysort
    from kajiya_tpu_torch.ops import woop_cuda as wc
    from kajiya_tpu_torch.core.camera import camera_rays
    from kajiya_tpu_torch.ops.tiling import tile_order
    from kajiya_tpu_torch.renderers import (gbuffer, raster, rtdgi, rtr,
                                            shadows, wrc)
    from kajiya_tpu_torch.scene import procedural
    from kajiya_tpu_torch.scene.scene import build_gpu_scene
    from kajiya_tpu_torch.world import build_trace_scene

    make, eye, fwd, _ = SCENES["city"]
    ts, _ = build_trace_scene(build_gpu_scene(make(procedural), device=dev),
                              device=dev)
    view = views(eye, fwd, (0, 0, 0), 1, WIDTH, HEIGHT, dev)[0]
    gb = gbuffer.raster_gbuffer(ts, view, WIDTH, HEIGHT)
    sorg, sdir, _need = shadows.sun_shadow_rays(ts, gb, 0)
    corg0, cdir0, _rng = rtdgi.candidate_rays(rtdgi.half_gbuffer(gb), 0)
    # the default frame's shared wavefront: GI candidates, then the
    # reflection rays, sorted as one batch
    rorg, rdir, _pdf, _rng = rtr.reflection_rays(gb, 0)
    # the path tracer's bounce-2 wavefront, ended paths as dead lanes
    unsorted = {"gi_sorted_closest": (corg0, cdir0, None),
                "gi_rtr_sorted_closest": (torch.cat([corg0, rorg]),
                                          torch.cat([cdir0, rdir]), None),
                "pt_bounce2_sorted_closest": pt_wavefront(ts, view, 2)}
    rb = raysort.SORT_RAY_BLOCK
    srt = {}
    for case, (o, dd, tm) in unsorted.items():
        perm = raysort.sort_permutation(ts.woop, o, dd)
        srt[case] = (o[perm], dd[perm], None if tm is None else tm[perm])
    iorg, idir = ircache_rays(gb, view.eye_position, dev)
    # the traced g-buffer's camera rays in 64x128 screen tiles, and the
    # world radiance cache's probe texels (default config, unsorted)
    corg, cdir = camera_rays(view, WIDTH, HEIGHT)
    worg, wdir = wrc.probe_rays(wrc.WrcConfig(), dev)
    plain_rays = {"ircache_closest": (iorg, idir),
                  "traced_primary_closest": (
                      tile_order(corg).reshape(-1, 3).contiguous(),
                      tile_order(cdir).reshape(-1, 3).contiguous()),
                  "wrc_probes_closest": (worg.contiguous(),
                                         wdir.contiguous())}
    batches = {
        "raster_closest": (raster.raster_batch(ts, view, WIDTH, HEIGHT),
                           1e-4, False),
        "shadow_any_hit": (wc.prepare_culled(
            ts.woop, tile_order(sorg.reshape(HEIGHT, WIDTH, 3)).reshape(-1, 3),
            tile_order(sdir.reshape(HEIGHT, WIDTH, 3)).reshape(-1, 3)),
            shadows.RAY_EPS, True),
        **{case: (wc.prepare_culled(ts.woop, *srt[case][:2],
                                    t_max=srt[case][2], rb=rb), 1e-4, False)
           for case in srt},
        "gi_sorted_closest_rb512": (wc.prepare_culled(
            ts.woop, *srt["gi_sorted_closest"][:2], rb=512), 1e-4, False),
        **{case: (wc.prepare_culled(ts.woop, *rays),
                  1e-3 if case == "wrc_probes_closest" else 1e-4, False)
           for case, rays in plain_rays.items()},
    }
    return batches, (ts, unsorted, srt, rb, plain_rays)


def culled_phase(dev):
    """Kernel C: city, 1080p raster block lists (closest), beam-culled sun
    shadow rays (any-hit) and the half-res GI candidate rays as the frame
    traces them: key-sorted, in 128-ray chunks, most of them divergent
    (closest), the default frame's wavefront of those rays and the
    half-res reflection rays, sorted together (closest), and the irradiance
    cache's 65,536-ray entry wavefront, traced unsorted in 512-ray chunks as
    the default frame traces it (closest), the path tracer's bounce-2
    wavefront (sorted, 128-ray chunks, ended paths dead), the traced
    g-buffer's tiled camera rays and the world radiance cache's 196,608
    probe rays (unsorted, 512-ray chunks; closest). The plain version walks
    the same lists. Also times the sort and the beam cull that each sorted
    wavefront pays before the kernel, the cull of each unsorted one, and
    the sorted wavefront in 512-ray chunks (a check against the 128-ray
    chunks' hits and a time beside theirs, not a frame call). A checking
    launch per case counts the ray x block pairs the kernel's per-ray walk
    tested; it must equal the plain version's count, sets the bound's work
    (30 operations x 128 triangles a pair) and is reported as a share of
    the pairs the chunk-level walk covers."""
    from kajiya_tpu_torch.ops import raysort
    from kajiya_tpu_torch.ops import woop_cuda as wc

    batches, (ts, unsorted, srt, rb, plain_rays) = culled_batches(dev)
    not_frame = ("gi_sorted_closest_rb512",)
    plain_outs = {}
    overhead = {}
    for case, (o, dd, _tm) in unsorted.items():
        so, sd, stm = srt[case]
        b = batches[case][0]
        coherent = wc._chunk_beams(b.org, b.d, b.tmax, b.n_chunks, rb)[5]
        overhead[case] = {
            "sort_ms": time_ms(lambda: raysort.sort_permutation(
                ts.woop, o, dd), 5),
            "cull_ms": time_ms(lambda: wc.prepare_culled(
                ts.woop, so, sd, t_max=stm, rb=rb), 5),
            "coherent_chunk_share": float(coherent.float().mean()),
            "live_rays": int((b.tmax > 1e-4).sum())}
        log(f"{case} wavefront: {b.n_rays} rays "
            f"({overhead[case]['live_rays']} live), {b.n_chunks} chunks of "
            f"{rb}, {overhead[case]['coherent_chunk_share']:.3f} coherent; "
            f"sort {overhead[case]['sort_ms']:.3f} ms, cull "
            f"{overhead[case]['cull_ms']:.3f} ms")
    for case, (o, dd) in plain_rays.items():
        overhead[case] = {"cull_ms": time_ms(
            lambda: wc.prepare_culled(ts.woop, o, dd), 5)}
    cases = []
    for case, (b, t_min, any_hit) in batches.items():
        tested = torch.zeros((1,), dtype=torch.int64, device=dev)
        k_out = wc.culled_launch(b, t_min, any_hit, True, tested=tested)
        if case in not_frame:
            # the chunk size enters no result: the same rays in other chunks
            # must find what the frame's chunks found (checked against that
            # case's plain version, whose walk is not repeated here)
            p128 = tuple(x[:b.n_rays] for x in plain_outs["gi_sorted_closest"])
            err = compare_hits(f"woop_culled/{case}",
                               tuple(x[:b.n_rays] for x in k_out), p128, False)
            ms = time_ms(lambda: wc.culled_launch(b, t_min, any_hit, True), 10)
            live = int((b.tmax > t_min).sum())
            cases.append(dict(case=case, rays=b.org.shape[0],
                              chunks=b.n_chunks, rb=b.rb, frame_call=False,
                              mean_listed=float(b.count.float().mean()),
                              tested_pairs_per_live_ray=int(tested) / live,
                              max_abs_err=err, ms=ms))
            log(f"woop_culled/{case}: err {err} kernel {ms:.4f} ms; mean "
                f"listed {cases[-1]['mean_listed']:.1f} blocks/chunk, "
                f"{cases[-1]['tested_pairs_per_live_ray']:.2f} blocks tested "
                f"per live ray")
            continue
        walked, ray_walked = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out = wc.culled_plain(b, t_min, any_hit, True,
                                chunks_per_step=1024 * 512 // b.rb,
                                visits=walked, ray_visits=ray_walked)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain_outs[case] = p_out
        err = compare_hits(f"woop_culled/{case}", k_out, p_out, any_hit)
        # the kernel's exhaustive walk (no bound, no box test) must return
        # what its per-ray walk returns
        x_out = wc.culled_launch(b, t_min, any_hit, False)
        same = (torch.equal(x_out[1] >= 0, k_out[1] >= 0) if any_hit else
                all(torch.equal(a, c) for a, c in zip(x_out, k_out)))
        if not same:
            raise AssertionError(f"woop_culled/{case}: the per-ray walk "
                                 "differs from the exhaustive walk")
        ms = time_ms(lambda: wc.culled_launch(b, t_min, any_hit, True), 10)
        walked = torch.cat(walked)
        live = (b.tmax.reshape(-1, b.rb) > t_min).sum(dim=1)
        pairs = float((walked * live).sum())    # ray x block, chunk walk
        ray_pairs = int(torch.cat(ray_walked).sum())
        if int(tested) != ray_pairs:
            raise AssertionError(f"woop_culled/{case}: the kernel tested "
                                 f"{int(tested)} ray x block pairs, the "
                                 f"plain per-ray walk {ray_pairs}")
        # the bound counts the tests this run's data needs: the ray x block
        # pairs of the per-ray walk (plain count, equal to the kernel's)
        visits = float(ray_pairs) * wc.CULL_TB
        r = b.org.shape[0]
        bytes_moved = (r * (28 + 16) + b.blist.numel() * 8
                       + b.coef.numel() * 4)
        b_ms, b_by = bound(bytes_moved, OPS_PER_VISIT * visits)
        # the same count for the chunk-level walk, whose pairs the per-ray
        # walk thins out (information, no bound: the kernel beats it)
        chunk_ms = OPS_PER_VISIT * pairs * wc.CULL_TB / PEAK_FP32 * 1e3
        cases.append(dict(case=case, rays=r, chunks=b.n_chunks, rb=b.rb,
                          **overhead.get(case, {}),
                          mean_listed=float(b.count.float().mean()),
                          mean_walked=float(walked.float().mean()),
                          tested_share=ray_pairs / max(pairs, 1.0),
                          tested_pairs_per_live_ray=ray_pairs / max(
                              int(live.sum()), 1),
                          chunk_walk_ops_ms=chunk_ms,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, visits=visits))
        log(f"woop_culled/{case}: err {err} kernel {ms:.4f} ms plain "
            f"{plain_ms:.1f} ms bound {b_ms:.5f} ms ({b_by}); mean listed "
            f"{cases[-1]['mean_listed']:.1f} walked "
            f"{cases[-1]['mean_walked']:.1f} blocks/chunk, tested "
            f"{cases[-1]['tested_share']:.4f} of the walked ray x block "
            f"pairs")
    return cases


def warp_inputs(dev):
    """Kernel W's cases at the frame's shapes, on a reprojection-like uv
    field (pixel centers plus a smooth motion of a few pixels): at 1080p
    1-channel nearest (prev depth), 3-channel bilinear (shadow moments +
    history length), 4-channel bilinear (GI and RTR history + length) and
    9-channel bilinear (TAA's packed history fetch); at half res 13-channel
    nearest (the ReSTIR GI temporal fetch of the packed reservoirs) and
    11-channel nearest (RTR's); at quarter res 4-channel nearest (each of
    the 8 motion-blur taps). Yields (case, img, uv, bilinear)."""
    from kajiya_tpu_torch.core import img as im

    g = torch.Generator(device=dev).manual_seed(0)
    for case, h, w, c, bilinear in (
            ("nearest_c1", HEIGHT, WIDTH, 1, False),
            ("bilinear_c3", HEIGHT, WIDTH, 3, True),
            ("bilinear_c4", HEIGHT, WIDTH, 4, True),
            ("bilinear_c9", HEIGHT, WIDTH, 9, True),
            ("nearest_c13_half", HEIGHT // 2, WIDTH // 2, 13, False),
            ("nearest_c11_half", HEIGHT // 2, WIDTH // 2, 11, False),
            ("nearest_c4_quarter", HEIGHT // 4, WIDTH // 4, 4, False)):
        uv = im.pixel_uv(h, w, device=dev)
        yy, xx = uv[..., 1], uv[..., 0]
        motion = torch.stack([torch.sin(6.0 * yy + 2.0 * xx),
                              torch.cos(5.0 * xx - 3.0 * yy)], dim=-1) * 3.0
        uv = (uv + motion / torch.tensor([w, h], device=dev)).contiguous()
        img = torch.rand((h, w, c), generator=g, device=dev)
        yield (case, (img[..., 0].contiguous() if c == 1 else img), uv,
               bilinear, h * w)


def superres_lattices(dev):
    """The nearest lattices of TAA's super-resolution at 1280x720 shown at
    1920x1080, as `renderers/taa.py` builds them: (case, source size, uv):
    the base source pixel of every output pixel (the 27-channel fetch of
    the unjitter's pre-shifted taps), the output pixel lattice (the resizes
    to the output) and the render pixel lattice (the resize to the render
    res)."""
    from kajiya_tpu_torch.core import img as im

    h, w = round(HEIGHT / SUPERRES), round(WIDTH / SUPERRES)
    ox = (torch.arange(WIDTH, dtype=torch.float32, device=dev) + 0.5)
    oy = (torch.arange(HEIGHT, dtype=torch.float32, device=dev) + 0.5)
    bx, by = torch.floor(ox * (w / WIDTH)), torch.floor(oy * (h / HEIGHT))
    base_uv = torch.stack([((bx + 0.5) / w)[None].expand(HEIGHT, WIDTH),
                           ((by + 0.5) / h)[:, None].expand(HEIGHT, WIDTH)],
                          dim=-1).contiguous()
    return ((("nearest_c27", 27), (h, w), base_uv),
            (("to_out_c4", 4), (h, w), im.pixel_uv(HEIGHT, WIDTH, device=dev)),
            (("to_out_c1", 1), (h, w), im.pixel_uv(HEIGHT, WIDTH, device=dev)),
            (("to_render_c8", 8), (HEIGHT, WIDTH), im.pixel_uv(h, w,
                                                              device=dev)))


def superres_warp_inputs(dev):
    """Kernel W's cases of the super-resolution frame at 1080p output:
    TAA's 27-channel fetch of the unjitter's taps (render -> output), the
    resize of the closest velocity, validity and bounds (4 channels) and of
    the input probability (1) to the output, and that of the history,
    variance and velocity (8) to the render res. Yields (case, img, uv,
    bilinear, source pixels read: a resize to a coarser lattice reads only
    the pixels it picks)."""
    g = torch.Generator(device=dev).manual_seed(3)
    for (case, c), (h, w), uv in superres_lattices(dev):
        img = torch.rand((h, w, c), generator=g, device=dev)
        if c == 1:
            img = img[..., 0].contiguous()
        iy = torch.floor(uv[..., 1] * h).clamp(0, h - 1)
        ix = torch.floor(uv[..., 0] * w).clamp(0, w - 1)
        read = int(torch.unique(iy).numel()) * int(torch.unique(ix).numel())
        yield f"superres_{case}", img, uv, False, read


def warp_phase(dev):
    """Kernel W on the cases of `warp_inputs` and `superres_warp_inputs`
    against the plain sampler, with `grid_sample` timed beside it as the
    yardstick. Before those, small check-only cases launch the instances of
    the kernel that no frame shape reaches: float2 elements (C = 2, 6),
    float4 with several elements a pixel (C = 16) and the run-time divisor
    (C = 5, 20), on a uv grid of another size than the image with taps off
    every edge; and the sharded frames' band calls (gathered sources, and
    super-resolution's windows)."""
    import torch.nn.functional as F

    from kajiya_tpu_torch.ops import warp_cuda

    cases = []
    g = torch.Generator(device=dev).manual_seed(2)
    for c in (2, 5, 6, 16, 20):
        img = torch.randn((45, 200, c), generator=g, device=dev)
        uv = torch.rand((37, 333, 2), generator=g, device=dev) * 1.1 - 0.05
        for bilinear in (False, True):
            case = f"check_{'bilinear' if bilinear else 'nearest'}_c{c}"
            err = float((warp_cuda.warp_launch(img, uv, bilinear)
                         - warp_cuda.warp_plain(img, uv, bilinear)).abs().max())
            if not err <= WARP_TOL:
                raise AssertionError(f"warp/{case}: max error {err}")
            cases.append(dict(case=case, pixels=37 * 333, channels=c,
                              frame_call=False, max_abs_err=err))
    # the sharded frame's calls: a band's uv (the second of four 1080p
    # bands, 272 rows, at the plane's resolution) into a gathered
    # whole-frame source: the reprojected depth, the GI / RTR history, TAA's
    # packed history, RTR's packed half-res reservoirs and motion blur's
    # quarter-res taps
    for c, bilinear, k in ((1, False, 1), (4, True, 1), (9, True, 1),
                           (11, False, 2), (4, False, 4)):
        h, w = HEIGHT // k, WIDTH // k
        uv = torch.rand((272 // k, w, 2), generator=g, device=dev)
        img = torch.rand((h, w, c), generator=g, device=dev)
        res = {1: "", 2: "_half", 4: "_quarter"}[k]
        case = f"band_{'bilinear' if bilinear else 'nearest'}_c{c}{res}"
        err = float((warp_cuda.warp_launch(img, uv, bilinear)
                     - warp_cuda.warp_plain(img, uv, bilinear)).abs().max())
        if not err <= WARP_TOL:
            raise AssertionError(f"warp/{case}: max error {err}")
        cases.append(dict(case=case, pixels=uv.shape[0] * w, channels=c,
                          frame_call=False, max_abs_err=err))
    # the super-resolution frame's band calls: the second of four output
    # bands (rows 272-544 of 1080) fetched through the kernel from the
    # window of source rows it reaches (`img.warp_nearest_rows`), equal to
    # the plain fetch of the whole source; the render band 176-368 of 720
    # for the resize to the render res
    from kajiya_tpu_torch.core import img as im
    from kajiya_tpu_torch.renderers.taa import _rows_reached

    for (case, c), (h, w), uv in superres_lattices(dev):
        to_render = case.startswith("to_render")
        a, b = (176, 368) if to_render else (272, 544)
        ub = uv[a:b]
        lo, hi = _rows_reached(a, b, h / uv.shape[0], h,
                               reach=1 if c == 27 else 0)
        img = torch.rand((h, w, c), generator=g, device=dev)
        k_out = im.warp_nearest_rows(img[lo:hi], lo, h, ub)
        p_out = warp_cuda.warp_plain(img, ub, False)
        err = float((k_out - p_out).abs().max())
        if not err <= WARP_TOL:
            raise AssertionError(f"warp/band_superres_{case}: max error "
                                 f"{err}")
        cases.append(dict(case=f"band_superres_{case}", pixels=ub.numel() // 2,
                          channels=c, frame_call=False, max_abs_err=err))
    log("warp check-only cases: max error",
        max(x["max_abs_err"] for x in cases))
    for case, img, uv, bilinear, src_read in (list(warp_inputs(dev))
                                              + list(superres_warp_inputs(
                                                  dev))):
        c = 1 if img.ndim == 2 else img.shape[2]
        k_out = warp_cuda.warp_launch(img, uv, bilinear)
        p_out = warp_cuda.warp_plain(img, uv, bilinear)
        torch.cuda.synchronize()
        err = float((k_out - p_out).abs().max())
        if not err <= WARP_TOL:
            raise AssertionError(f"warp/{case}: max error {err}")
        n = uv.numel() // 2
        # uv + output + the source pixels read, once
        bytes_moved = n * 8 + n * c * 4 + src_read * c * 4

        def kernel(img=img, uv=uv, bilinear=bilinear):
            img, uv = img.clone(), uv.clone()
            return lambda: warp_cuda.warp_launch(img, uv, bilinear)

        # yardstick only: one PyTorch call computing the same sampling
        # (border padding = clamp addressing); the port never calls it
        def library(img=img, uv=uv, c=c, bilinear=bilinear):
            src = (img[None, None] if c == 1 else img.permute(2, 0, 1)[None]
                   ).clone(memory_format=torch.contiguous_format)
            grid = (uv * 2.0 - 1.0)[None].contiguous()
            mode = "bilinear" if bilinear else "nearest"
            return lambda: F.grid_sample(src, grid, mode=mode,
                                         padding_mode="border",
                                         align_corners=False)

        # L2-cold (rotated input copies): the number the row reports; the
        # frame's passes stream several such planes between two calls
        ms = time_cold_ms(kernel, bytes_moved)
        lib_ms = time_cold_ms(library, bytes_moved)
        hot_ms = time_ms(kernel(), 50, graph=True)
        lib_hot_ms = time_ms(library(), 50, graph=True)
        eager_ms = time_ms(kernel(), 50)
        plain_ms = time_ms(lambda: warp_cuda.warp_plain(img, uv, bilinear), 10)
        b_ms, b_by = bound(bytes_moved, 0.0)
        cases.append(dict(case=case, pixels=n, channels=c, max_abs_err=err,
                          ms=ms, l2_hot_ms=hot_ms, eager_loop_ms=eager_ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          library_l2_hot_ms=lib_hot_ms, bound_ms=b_ms,
                          bound_by=b_by))
        log(f"warp/{case}: err {err} kernel {ms:.4f} ms L2-cold, "
            f"{hot_ms:.4f} hot (eager loop {eager_ms:.4f}) plain "
            f"{plain_ms:.3f} ms grid_sample {lib_ms:.4f} cold, "
            f"{lib_hot_ms:.4f} hot; bound {b_ms:.5f} ms")
    return cases


def tileshift_phase(dev):
    """Kernel S: the packed 20-channel half-res reservoir plane with the
    per-tile tap offsets of a real frame (spatial pass 0, tap 6: the widest
    radius), and a ragged small plane with offsets beyond the clip range.
    Pure data movement: the kernel must equal the plain gather bit for bit."""
    from kajiya_tpu_torch.ops import tileshift_cuda as tsc
    from kajiya_tpu_torch.renderers import restir_gi

    g = torch.Generator(device=dev).manual_seed(1)
    hh, hw = HEIGHT // 2, WIDTH // 2
    dy_s, dx_s = restir_gi.spatial_offsets(hh, hw, 1, 0, dev)
    nty, ntx = tsc.tile_grid(45, 200)
    wild = torch.randint(-200, 201, (2, nty * ntx), generator=g, device=dev,
                         dtype=torch.int32)
    # the sharded frame's call: the second of four 1080p bands (half-res
    # rows [136, 272)) with 12 halo rows each side and 4 zero rows above,
    # which start the window on the tile grid (rows 120-284), and the
    # offsets of its tiles
    nty_f, ntx_f = tsc.tile_grid(hh, hw)
    t0 = 120 // tsc.TH
    win_tiles = slice(t0, t0 + tsc.tile_grid(164, hw)[0])
    band_dy, band_dx = (o.reshape(-1, nty_f, ntx_f)[6, win_tiles].reshape(-1)
                        .contiguous() for o in (dy_s, dx_s))
    cases = []
    for case, shape, dy, dx in (
            ("restir_plane_c20", (hh, hw, 20), dy_s[6], dx_s[6]),
            ("restir_band_window_c20", (164, hw, 20), band_dy, band_dx),
            ("ragged_clipped_c20", (45, 200, 20), wild[0], wild[1]),
            ("ragged_2d", (45, 200), wild[1], wild[0])):
        img = torch.randn(shape, generator=g, device=dev)
        k_out = tsc.tile_shift_launch(img, dy, dx)
        p_out = tsc.tile_shift_plain(img, dy, dx)
        torch.cuda.synchronize()
        err = float((k_out - p_out).abs().max())
        if err != 0.0 or not torch.equal(k_out, p_out):
            raise AssertionError(f"tile_shift/{case}: differs from the plain "
                                 f"gather, max error {err}")
        if case != "restir_plane_c20":
            # the band window and the small shapes are checks only
            cases.append(dict(case=case, shape=list(shape), max_abs_err=err,
                              frame_call=False))
            continue
        if int(dy.abs().max()) == 0 and int(dx.abs().max()) == 0:
            raise AssertionError("tile_shift: the frame's offsets are all 0")
        bytes_moved = 2 * img.numel() * 4 + 2 * dy.numel() * 4

        def kernel(img=img, dy=dy, dx=dx):
            img = img.clone()
            return lambda: tsc.tile_shift_launch(img, dy, dx)

        # yardstick only: the plain version's last line, one advanced-index
        # gather, with its clamped indices built beforehand
        def library(img=img, dy=dy, dx=dx):
            img = img.clone()
            iy, ix = tsc.shift_indices(img, dy, dx)
            return lambda: img[iy, ix]

        ms = time_cold_ms(kernel, bytes_moved)
        lib_ms = time_cold_ms(library, bytes_moved)
        hot_ms = time_ms(kernel(), 50, graph=True)
        lib_hot_ms = time_ms(library(), 50, graph=True)
        eager_ms = time_ms(kernel(), 50)
        plain_ms = time_ms(lambda: tsc.tile_shift_plain(img, dy, dx), 10)
        b_ms, b_by = bound(bytes_moved, 0.0)
        cases.append(dict(case=case, shape=list(shape), max_abs_err=err,
                          ms=ms, l2_hot_ms=hot_ms, eager_loop_ms=eager_ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          library_l2_hot_ms=lib_hot_ms, bound_ms=b_ms,
                          bound_by=b_by))
        log(f"tile_shift/{case}: err {err} kernel {ms:.4f} ms L2-cold, "
            f"{hot_ms:.4f} hot (eager loop {eager_ms:.4f}) plain "
            f"{plain_ms:.3f} ms gather {lib_ms:.4f} cold, {lib_hot_ms:.4f} "
            f"hot; bound {b_ms:.5f} ms ({b_by})")
    return cases


def bvh_inputs(dev):
    """The BVH walk's six wavefronts on city40 at 1080p, as case -> (org,
    dir, tmax, t_min, any_hit, max_steps), and the scene's trace scene:
    camera rays (closest), sun shadows from the raster g-buffer's hits
    (any-hit), the default frame's shared wavefront of half-res GI
    candidates and reflection rays (closest), the path tracer's bounce-2
    wavefront with its ended paths as dead lanes (closest), the camera rays
    capped at 64 node visits, and the shared wavefront with seeded per-ray
    limits in [0, 20)."""
    from kajiya_tpu_torch.core.camera import camera_rays
    from kajiya_tpu_torch.ops.woop_cuda import ray_tmax
    from kajiya_tpu_torch.renderers import gbuffer, rtdgi, rtr, shadows
    from kajiya_tpu_torch.scene import procedural
    from kajiya_tpu_torch.scene.scene import build_gpu_scene
    from kajiya_tpu_torch.world import build_trace_scene

    make, eye, fwd, _ = SCENES["city40"]
    ts, _ = build_trace_scene(build_gpu_scene(make(procedural), device=dev),
                              device=dev)
    if ts.woop is not None or ts.bvh is None:
        raise AssertionError("city40: not routed to the BVH walk")
    view = views(eye, fwd, (0, 0, 0), 1, WIDTH, HEIGHT, dev)[0]
    org, d = (x.reshape(-1, 3).contiguous()
              for x in camera_rays(view, WIDTH, HEIGHT))
    gb = gbuffer.raster_gbuffer(ts, view, WIDTH, HEIGHT)
    sorg, sdir, _need = shadows.sun_shadow_rays(ts, gb, 0)
    corg, cdir, _rng = rtdgi.candidate_rays(rtdgi.half_gbuffer(gb), 0)
    rorg, rdir, _pdf, _rng = rtr.reflection_rays(gb, 0)
    worg, wdir = (torch.cat([corg, rorg]).contiguous(),
                  torch.cat([cdir, rdir]).contiguous())
    porg, pdir, ptmax = pt_wavefront(ts, view, 2)
    g = torch.Generator(device=dev).manual_seed(3)
    wtmax = torch.rand((worg.shape[0],), generator=g, device=dev) * 20.0

    def inf(o):
        return ray_tmax(o, None)

    sorg, sdir = sorg.contiguous(), sdir.contiguous()
    cases = {"camera_closest": (org, d, inf(org), 1e-4, False, None),
             "sun_shadow_any_hit": (sorg, sdir, inf(sorg), shadows.RAY_EPS,
                                    True, None),
             "gi_rtr_closest": (worg, wdir, inf(worg), 1e-4, False, None),
             "pt_bounce2_closest": (porg, pdir, ptmax, 1e-4, False, None),
             "camera_closest_max_steps64": (org, d, inf(org), 1e-4, False,
                                            64),
             "gi_rtr_closest_per_ray_tmax": (worg, wdir, wtmax, 1e-4, False,
                                             None)}
    return ts, cases


def ordered_differences(case, o_out, s_out, org, d, tris, t_min, tmax):
    """The front-to-back walk (`o_out`) against the skip-link walk
    (`s_out`) on one closest-hit wavefront. The two may pick different
    triangles only where a ray has two hits within rounding of each other:
    at most ORDER_DIFF_SHARE of the rays may differ in tri, and on each
    such ray both answers must be valid hits of it (Moller-Trumbore valid,
    t_min < t < t_max, the returned t) with |t_o - t_s| <= ORDER_T_TOL
    max(1, |t|). Returns (rays that differ, largest |t_o - t_s|)."""
    from kajiya_tpu_torch.rt.trace import _tri_intersect

    diff = o_out[1] != s_out[1]
    n_diff = int(diff.sum())
    if n_diff == 0:
        return 0, 0.0
    idx = diff.nonzero()[:, 0]
    o, dd, tm = org[idx], d[idx], tmax[idx]
    v0, e1, e2 = tris
    for label, out in (("front-to-back", o_out), ("skip-link", s_out)):
        tri, t_got = out[1][idx], out[0][idx]
        safe = torch.clamp(tri, min=0).long()
        t, _u, _v, ok = _tri_intersect(o, dd, v0[safe], e1[safe], e2[safe])
        good = (tri >= 0) & ok & (t > t_min) & (t < tm) & (t == t_got)
        if not bool(good.all()):
            raise AssertionError(
                f"bvh_walk/{case}: {int((~good).sum())} of the {n_diff} rays "
                f"on which the walks differ have no valid {label} hit")
    t_o, t_s = o_out[0][idx], s_out[0][idx]
    dt = (t_o - t_s).abs()
    worst = float(dt.max())
    if not bool((dt <= ORDER_T_TOL * torch.clamp(t_s.abs(), min=1.0)).all()):
        raise AssertionError(f"bvh_walk/{case}: the walks' t differ by up to "
                             f"{worst} where their triangles differ")
    if n_diff > ORDER_DIFF_SHARE * org.shape[0]:
        raise AssertionError(f"bvh_walk/{case}: {n_diff} of {org.shape[0]} "
                             "rays differ between the front-to-back and the "
                             "skip-link walk")
    return n_diff, worst


def bvh_phase(dev):
    """The BVH walk kernel against its plain version on city40's six
    wavefronts (`bvh_inputs`), each on the whole wavefront: t, tri, u, v and
    the per-ray node visits and triangle tests must be the same bits (a
    checking launch returns the counts; the launch the frame makes, without
    them, must return the same hits). The plain version is
    `walk_ordered_plain` for the four closest-hit cases without a cap, which
    the kernel walks front to back, and `walk_plain` for the any-hit and the
    capped case (the skip-link walk). The front-to-back result is also held
    against `walk_plain`'s (`ordered_differences`). Both are timed with CUDA
    events (the plain version once, on the compared call). The bound is
    the kernel's own work: OPS_PER_NODE fp32 operations a box test and
    OPS_PER_MT_TEST a triangle test, summed over its counts of the rays,
    over the fp32 peak, against the bytes of reading each input once (rays,
    limits, and the packed tables that walk reads: the node records for the
    skip-link walk; the root's node record and the pair records for the
    front-to-back walk; the leaf records for both) and writing each output
    once. The skip-link yardstick, `walk_plain`'s visits and tests on the
    same rays at the same rates (what the walk did before it went front to
    back), stays beside it as `yardstick_ops_bound_ms`. No PyTorch call
    computes a BVH walk, so the library time is none. The capped and the
    per-ray-limit cases are checks, not frame calls: the kernel line does
    not sum them."""
    from kajiya_tpu_torch.ops import bvh_cuda
    from kajiya_tpu_torch.rt.trace import walk_ordered_plain, walk_plain

    ts, inputs = bvh_inputs(dev)
    bvh, tris = ts.bvh, ts.tris
    nodes, leaves, pairs = ts.walk_tables
    cases = []
    for case, (o, dd, tm, t_min, any_hit, cap) in inputs.items():
        ordered = not any_hit and cap is None

        def launch(counts=False):
            return bvh_cuda.walk_launch(bvh, tris, ts.walk_tables, o, dd,
                                        t_min, tm, any_hit, cap,
                                        counts=counts)

        def skip_link():
            return walk_plain(bvh, tris, o, dd, t_min, tm, any_hit, cap,
                              counts=True)

        k_out = launch(counts=True)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        p_out = (walk_ordered_plain(bvh, tris, o, dd, t_min, tm, counts=True)
                 if ordered else skip_link())
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        names = "t tri u v visits tests".split()
        bad = [n for n, a, b in zip(names, k_out, p_out)
               if not torch.equal(a, b)]
        hit = k_out[1] >= 0
        err = max(float((k_out[i] - p_out[i]).abs().max()) for i in (0, 2, 3))
        if bad or err != 0.0:
            raise AssertionError(
                f"bvh_walk/{case}: {', '.join(bad)} differ from the plain "
                f"version ({int((k_out[1] != p_out[1]).sum())} ids, max "
                f"|t|,|u|,|v| error {err})")
        f_out = launch()
        if not all(torch.equal(a, b) for a, b in zip(f_out, k_out)):
            raise AssertionError(f"bvh_walk/{case}: the launch without "
                                 "counts differs from the checking launch")
        ms = time_ms(launch, 5)
        s_out = skip_link() if ordered else p_out
        n_diff, diff_t = (ordered_differences(case, k_out, s_out, o, dd,
                                              tris, t_min, tm)
                          if ordered else (0, 0.0))
        visits, tests = k_out[4].long(), k_out[5].long()
        n_visits, n_tests = int(visits.sum()), int(tests.sum())
        y_visits, y_tests = int(s_out[4].sum()), int(s_out[5].sum())
        r = o.shape[0]
        live = tm > t_min
        read = ((nodes[:1], pairs, leaves) if ordered
                else (nodes, leaves))
        bytes_moved = r * (28 + 16) + sum(x.numel() * 4 for x in read)
        ops = float(OPS_PER_NODE * n_visits + OPS_PER_MT_TEST * n_tests)
        yardstick = float(OPS_PER_NODE * y_visits + OPS_PER_MT_TEST * y_tests)
        b_ms, b_by = bound(bytes_moved, ops)
        vq = torch.quantile(visits.float(), torch.tensor(
            [0.5, 0.99], device=dev)).tolist()
        cases.append(dict(
            case=case, rays=r, live_rays=int(live.sum()),
            frame_call=not case.startswith(("camera_closest_max",
                                            "gi_rtr_closest_per")),
            walk="front-to-back" if ordered else "skip-link",
            hit_share=float(hit.float().mean()), max_steps=cap,
            nodes=bvh.num_nodes, tris=tris[0].shape[0], visits=n_visits,
            tests=n_tests, skip_link_visits=y_visits,
            skip_link_tests=y_tests, ops=ops, yardstick_ops=yardstick,
            mean_visits=n_visits / r, p50_visits=vq[0], p99_visits=vq[1],
            max_visits=int(visits.max()), mean_tests=n_tests / r,
            skip_link_mean_visits=y_visits / r,
            skip_link_mean_tests=y_tests / r,
            rays_differing_from_skip_link=n_diff,
            max_t_diff_from_skip_link=diff_t,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, ops_bound_ms=bound(0.0, ops)[0],
            yardstick_ops_bound_ms=bound(0.0, yardstick)[0],
            bytes_bound_ms=bound(bytes_moved, 0.0)[0], library_ms=None,
            ps_per_step=ms * 1e9 / max(n_visits + n_tests, 1),
            ps_per_yardstick_step=ms * 1e9 / max(y_visits + y_tests, 1)))
        c = cases[-1]
        log(f"bvh_walk/{case} ({c['walk']}): err {err} kernel "
            f"{ms:.4f} ms plain {plain_ms:.1f} ms bound {b_ms:.5f} ms "
            f"({b_by}; skip-link yardstick "
            f"{c['yardstick_ops_bound_ms']:.5f} ms); "
            f"{r} rays ({c['live_rays']} live, "
            f"{c['hit_share']:.3f} hit), visits mean "
            f"{n_visits / r:.1f} p50 {vq[0]:.0f} p99 {vq[1]:.0f} max "
            f"{int(visits.max())}, tests mean {n_tests / r:.1f}; skip-link "
            f"visits {y_visits / r:.1f} tests {y_tests / r:.1f}; "
            f"{n_diff} rays differ from the skip-link walk (|dt| <= "
            f"{diff_t})")
    return cases


# ----------------------------------------------------------------------------
# Frame phases
# ----------------------------------------------------------------------------

def counting_syncs(step):
    """step(), and the operations in it that made the host wait for the
    card (`torch.cuda.set_sync_debug_mode("warn")` warns once for each: a
    read of a device value, a blocking copy), counted per source line."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
        if "synchronizing CUDA operation" in str(w.message))
    return out, sites


def write_panorama(path, seed=0):
    """A 256x512 lat-long .hdr sky written with the port's RGBE writer: a
    blue gradient with seeded cloud noise and a small bright sun."""
    from kajiya_tpu_torch.sky.ibl import write_hdr

    rs = np.random.default_rng(seed)
    h, w = 256, 512
    v = (np.arange(h) + 0.5)[:, None] / h
    u = (np.arange(w) + 0.5)[None, :] / w
    sky = np.stack([0.3 + 0.5 * v, 0.5 + 0.4 * v, 1.0 + 0.2 * v], -1)
    sky = sky * (1.0 + 0.3 * rs.random((h, w, 1)))
    sun = np.exp(-(((u - 0.3) * 40.0) ** 2 + ((v - 0.25) * 20.0) ** 2))
    write_hdr(path, (sky + 200.0 * sun[..., None]).astype(np.float32))


class PathRun:
    """One ported path on one scene: `step(view)` renders a frame through
    the entry points a user calls (`Renderer.draw`; for the path tracer
    `render_frame_reference` on the Renderer's trace scene, as the viewer's
    reference mode does), failing if the frame failed."""

    def __init__(self, path, make, dev, width, height, ibl=None,
                 small_ircache=False, brute_max_tris=None):
        from kajiya_tpu_torch.frame import Renderer, init_reference_state
        from kajiya_tpu_torch.scene import procedural
        from kajiya_tpu_torch.world import build_trace_scene

        self.path = path
        self.cfg = slice_cfg(width, height, path, small_ircache)
        self.r = Renderer(make(procedural), self.cfg, device=dev,
                          ibl=ibl if path == "options" else None)
        if brute_max_tris is not None:
            # the route forced where the trace scene is built, as a user
            # of build_trace_scene forces it
            self.r.ts, self.r.levels = build_trace_scene(
                self.r.gpu, device=dev, brute_max_tris=brute_max_tris)
        self.ref_state = (init_reference_state(self.cfg, device=dev)
                          if path == "refpt" else None)

    def step(self, view):
        from kajiya_tpu_torch.frame import render_frame_reference

        if self.path == "refpt":
            self.ref_state, out = render_frame_reference(
                self.r.ts, self.ref_state, view, self.cfg,
                num_bounces=PT_BOUNCES)
            return out
        out = self.r.draw(view)
        if self.r._last_error is not None:
            raise RuntimeError(f"{self.path}: frame failed: "
                               f"{self.r._last_error}")
        return out

    def views(self, eye, fwd, step, n, dev):
        """A progressive path tracer keeps its camera still; the hybrid
        paths move it (and the default frames jitter it for TAA)."""
        w, h = self.cfg.width, self.cfg.height
        if self.path == "refpt":
            return views(eye, fwd, (0.0, 0.0, 0.0), n, w, h, dev)
        return views(eye, fwd, step, n, w, h, dev,
                     jitter=self.path in ("default", "options", "superres",
                                          "textured"))


FRAME_KEYS = {
    "raster": ("final", "lit", "shadow"),
    "gi": ("final", "lit", "shadow", "diffuse_gi", "ssao"),
    "default": ("final", "lit", "shadow", "diffuse_gi", "ssao",
                "reflections", "taa"),
    "options": ("final", "lit", "shadow", "diffuse_gi", "ssao",
                "reflections", "taa"),
    "refpt": ("final", "lit"),
}
FRAME_KEYS["textured"] = FRAME_KEYS["superres"] = FRAME_KEYS["default"]
# the scenes of each path's small GPU-vs-CPU frames ("city" is city(n=4))
REF_SCENES = {"textured": ("tcornell", "tcity4", "tcitylegacy4",
                          "tcitytiff4", "tcitystudio4", "tcitycodec4",
                          "tcityplugins4")}
# the paths whose small frames are also rendered on the BVH route, forced
# with brute_max_tris=0
BVH_REF_PATHS = ("default", "refpt")


def route_of(ts):
    """The trace route of a trace scene: "bvh" (no Woop tables), "culled"
    (cluster tables, kernel C) or "brute" (kernel B)."""
    if ts.woop is None:
        return "bvh"
    return "culled" if ts.woop.get("cmin") is not None else "brute"


# the small GPU-vs-CPU frames' CPU side runs in REF_WORKERS processes of
# REF_THREADS torch threads each, while the card runs the kernel phases (one
# after another on the host they took 129 s without the textured scenes,
# on an 8-core x86-64 host)
REF_WORKERS, REF_THREADS = 3, 2
REF_SIZE = (64, 48)


def reference_runs():
    """The small frames' runs: (path, tolerances, brute_max_tris or None,
    frames, scene name)."""
    runs = [(path, tols, None) for path, tols in (
        ("raster", FRAME_TOL), ("gi", GI_FRAME_TOL), ("default", GI_FRAME_TOL),
        ("options", GI_FRAME_TOL), ("superres", GI_FRAME_TOL),
        ("refpt", PT_FRAME_TOL), ("textured", GI_FRAME_TOL))]
    runs += [(path, GI_FRAME_TOL if path == "default" else PT_FRAME_TOL, 0)
             for path in BVH_REF_PATHS]
    for path, tols, brute_max in runs:
        n = {"raster": 3, "refpt": 2}.get(path, 4)
        for name in REF_SCENES.get(path, ("cornell", "city")):
            yield path, tols, brute_max, n, name


def reference_frames(dev, ibl, path, brute_max, n, name):
    """The small frames of one run on `dev`: the last frame's outputs and
    the texture pages."""
    make, eye, fwd, step = SCENES[name]
    if name == "city":
        make = lambda p: p.city(n=4, subdiv=8)      # noqa: E731
        eye, fwd = (0.0, 8.0, 14.0), (0.0, -0.45, -1.0)
    run = PathRun(path, make, dev, *REF_SIZE, ibl=ibl, small_ircache=True,
                  brute_max_tris=brute_max)
    if brute_max is not None and route_of(run.r.ts) != "bvh":
        raise AssertionError(f"{path}/{name}: not on the BVH route")
    for v in run.views(eye, fwd, step, n, dev):
        o = run.step(v)
    return o, run.r.gpu.tex_pages


def page_digest(pages):
    """SHA-256 of a texture page tensor, with its dtype and shape (None for
    a scene without textures)."""
    import hashlib

    if pages is None:
        return None
    a = pages.cpu().contiguous()
    return (str(a.dtype), tuple(a.shape),
            hashlib.sha256(a.numpy().tobytes()).hexdigest())


def reference_cpu(root, ibl, path, brute_max, n, name):
    """The CPU side of one run of the small frames, in a worker process:
    the compared planes, the primary hit mask and the pages' digest."""
    torch.set_num_threads(REF_THREADS)
    SCENES.update(asset_scene_entries(root))
    o, pages = reference_frames(torch.device("cpu"), ibl, path, brute_max,
                                n, name)
    return ({k: o[k] for k in FRAME_KEYS[path]},
            None if path == "refpt" else o["gbuffer"]["hit"],
            page_digest(pages))


def start_reference_cpu(root, ibl):
    """Start the CPU side of every run of the small frames in worker
    processes; returns the pool and {run: future}. The cities go first, as
    they take the longest."""
    pool = ProcessPoolExecutor(REF_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    runs = sorted(reference_runs(), key=lambda r: "cornell" in r[4])
    return pool, {(path, brute_max, name): pool.submit(
        reference_cpu, root, ibl, path, brute_max, n, name)
        for path, _tols, brute_max, n, name in runs}


def reference_phase(dev, ibl, cpu_side):
    """The GPU path (kernels) against the CPU path (plain versions) on a
    small frame of each scene, for every ported path: three frames (four on
    the GI, default, options and super-resolution paths, so that frame 3
    validates live reservoirs and the cache's stored rays; two progressive
    frames of the path tracer) at 64x48 (the super-resolution path shown at
    96x72) from the same views; the default, options and super-resolution
    paths with the small irradiance cache (and the options path with the
    small world radiance cache); the textured path on the textured cornell
    and the textured asset city at n=4 (its 2048^2 PNG maps, and 256^2
    legacy-format, TIFF, studio, TIFF-codec and plugin maps), whose texture
    pages on the card must equal the CPU's byte for byte; the default and
    path-tracer frames again on the BVH route (`brute_max_tris=0`; "+bvh"
    in the names), where the CPU path runs `walk_plain`. The CPU side comes
    from `cpu_side` (`start_reference_cpu`'s futures). Every comparison is
    made and logged before a failure is raised."""
    worst, failed = {}, []
    for path, tols, brute_max, n, name in reference_runs():
        tol, min_frac, max_mean = tols
        o, pages = reference_frames(dev, ibl, path, brute_max, n, name)
        planes, hit, digest = cpu_side[path, brute_max, name].result()
        if brute_max is not None:
            name = f"{name}+bvh"
        if path == "textured" and page_digest(pages) != digest:
            failed.append(f"{path}/{name}: texture pages on the card "
                          "differ from the CPU's")
        if path != "refpt":
            same = float((o["gbuffer"]["hit"].cpu() == hit).float().mean())
            if same < HIT_AGREE:
                failed.append(f"{path}/{name}: GPU vs CPU hit masks "
                              f"agree on {same}")
        for k in FRAME_KEYS[path]:
            if k == "shadow" and path != "raster":
                continue
            a, b = o[k].cpu(), planes[k]
            diff = (a - b).abs()
            frac = float((diff <= tol).float().mean())
            mean = float(diff.mean())
            worst[f"{path}/{name}/{k}"] = (frac, mean)
            if not bool(torch.isfinite(a).all()) or frac < min_frac \
                    or mean > max_mean:
                failed.append(f"{path}/{name}/{k}: GPU vs CPU frac "
                              f"{frac} mean {mean}")
    log("GPU vs CPU small frames (fraction within tolerance, mean abs "
        "diff):", worst)
    if failed:
        raise AssertionError("; ".join(failed))
    return worst


def expected_launches(path, route, emissive, n_frames):
    """Kernel launches of `n_frames` frames from a fresh state (frame index
    0 onwards) on a scene of the trace route `route` (`route_of`: "brute"
    sends every trace to B, "culled" to C, "bvh" to the BVH walk, one
    launch a trace call as well) and with or without emissive triangles.
    Per frame, the traces go through B, C or the walk:
    primaries + sun shadows; on the GI path also the candidate rays, their
    sun-NEE and light-NEE shadow rays and, on every third frame, the
    validation rays + their sun-NEE. The default path traces the candidate
    and reflection rays as one wavefront (+ its two NEE batches, + the
    validation of both passes' reservoirs as one batch + its sun-NEE every
    third frame), and adds the irradiance cache's entry wavefront + its
    sun-NEE and light-NEE batches, and where the scene has emissive
    triangles the 2 shadow batches of the mesh-light specular (the textured
    path is the default path on textured scenes). The options path is the
    default path with traced primaries (one trace, as the raster's one)
    and the world radiance cache's probe rays + their sun-NEE batch (no
    light NEE there); the super-resolution path is the default path with
    TAA's 4 resizes and fetches between the render and output resolutions
    (below). The path tracer traces 3 wavefronts a bounce (closest
    hit, sun NEE, light NEE; without emissive triangles the light-NEE
    wavefront is all dead lanes, and still launched) for 16 bounces. W: prev depth + shadow
    moments; on the GI path also the SSAO history, the ReSTIR temporal
    fetch, the occlusion march of spatial pass 1 (4 taps x 2 samples) and
    the GI history; the default path adds the RTR reservoir fetch and
    history, TAA's packed history fetch (its other fetches are resizes,
    which do not run at temporal_upsampling 1) and the 8 motion-blur taps;
    under super-resolution TAA adds the resize of the closest velocity,
    validity and bounds to the output, that of the history, variance and
    velocity to the render res, that of the input probability to the
    output, and the 27-channel fetch of the unjitter's taps. S: the 7 + 4
    taps of the two ReSTIR spatial passes. The path tracer launches neither
    W nor S."""
    kernel = {"brute": "woop_brute", "culled": "woop_culled",
              "bvh": "bvh_walk"}[route]

    def trace_counts(traces):
        return {k: traces if k == kernel else 0
                for k in ("woop_brute", "woop_culled", "bvh_walk")}

    if path == "refpt":
        return {**trace_counts(3 * PT_BOUNCES * n_frames), "warp": 0,
                "tile_shift": 0}
    superres = path == "superres"
    if path in ("textured", "superres"):    # the default frame, on textured
        path = "default"                    # scenes or shown larger
    gi = path in ("gi", "default", "options")
    validations = len(range(0, n_frames, 3)) if gi else 0
    per_frame = {"raster": 2, "gi": 5, "default": 8,
                 "options": 10}[path]
    if path in ("default", "options") and emissive:
        per_frame += 2
    traces = per_frame * n_frames + 2 * validations
    return {**trace_counts(traces),
            "warp": ({"raster": 2, "gi": 13, "default": 24,
                      "options": 24}[path] + 4 * superres) * n_frames,
            "tile_shift": 11 * n_frames if gi else 0}


def frame_phase(dev, path, ibl):
    """Frames at 1920x1080 on one ported path, per scene of PATH_SCENES,
    counters set to 0 just before and read just after each scene's frames,
    and the host syncs of each frame counted (those of the last frame per
    source line). On the textured path the scene's load and texture bake
    are timed: the decode and resize of each image, the whole host bake
    (decode, resize, pack, mips) and the upload."""
    from kajiya_tpu_torch import frame as frame_mod
    from kajiya_tpu_torch.ops import _native
    from kajiya_tpu_torch.rt import bvh as bvh_mod
    from kajiya_tpu_torch.scene import lab
    from kajiya_tpu_torch.scene import scene as scene_mod
    from kajiya_tpu_torch.scene import textures

    result = {}
    for name in PATH_SCENES[path]:
        make, eye, fwd, step = SCENES[name]
        n_frames = min(N_FRAMES[path], FRAME_CAP.get(name, N_FRAMES[path]))
        t0 = time.perf_counter()
        with Stopwatch(decode=(textures, "_decode_image"),
                       decode_jpeg=(textures._DECODERS, "JPEG"),
                       decode_dds=(textures._DECODERS, "DDS"),
                       decode_png=(textures._DECODERS, "PNG"),
                       decode_tga=(textures._DECODERS, "TGA"),
                       decode_bmp=(textures._DECODERS, "BMP"),
                       decode_gif=(textures._DECODERS, "GIF"),
                       decode_webp=(textures._DECODERS, "WEBP"),
                       decode_tiff=(textures._DECODERS, "TIFF"),
                       decode_psd=(textures._DECODERS, "PSD"),
                       decode_sgi=(textures._DECODERS, "SGI"),
                       decode_pcx=(textures._DECODERS, "PCX"),
                       decode_qoi=(textures._DECODERS, "QOI"),
                       decode_sun=(textures._DECODERS, "SUN"),
                       decode_xpm=(textures._DECODERS, "XPM"),
                       decode_icns=(textures._DECODERS, "ICNS"),
                       lab_transform=(lab, "to_rgba"),
                       resize=(textures, "_resize"),
                       bake=(textures, "bake_texture_pages"),
                       pages=(textures, "build_texture_pages"),
                       gpu_scene=(scene_mod, "build_gpu_scene"),
                       bvh_native=(bvh_mod, "build_bvh_native"),
                       trace_scene=(frame_mod, "build_trace_scene")) as watch:
            run = PathRun(path, make, dev, WIDTH, HEIGHT, ibl=ibl)
            torch.cuda.synchronize()
        r = run.r
        setup_s = time.perf_counter() - t0
        setup = {k: watch.seconds[k] for k in ("gpu_scene", "bvh_native",
                                               "trace_scene")}
        bake = None
        if path == "textured":
            sec = watch.seconds
            # the bake turns a source it cannot decode white: here every
            # source is valid, so any decode that raised fails the run
            if watch.errors:
                raise AssertionError(f"{path}/{name}: decodes failed "
                                     f"{watch.errors}")
            bake = dict(decode_s=sec["decode"],
                        decode_jpeg_s=sec["decode_jpeg"],
                        decode_dds_s=sec["decode_dds"],
                        decode_png_s=sec["decode_png"],
                        decode_tga_s=sec["decode_tga"],
                        decode_bmp_s=sec["decode_bmp"],
                        decode_gif_s=sec["decode_gif"],
                        decode_webp_s=sec["decode_webp"],
                        decode_tiff_s=sec["decode_tiff"],
                        decode_psd_s=sec["decode_psd"],
                        decode_sgi_s=sec["decode_sgi"],
                        decode_pcx_s=sec["decode_pcx"],
                        decode_qoi_s=sec["decode_qoi"],
                        decode_sun_s=sec["decode_sun"],
                        decode_xpm_s=sec["decode_xpm"],
                        decode_icns_s=sec["decode_icns"],
                        lab_transform_s=sec["lab_transform"],
                        resize_s=sec["resize"],
                        pack_mips_s=sec["bake"] - sec["decode"]
                        - sec["resize"],
                        upload_s=sec["pages"] - sec["bake"],
                        bake_s=sec["pages"], build_gpu_scene_s=sec["gpu_scene"],
                        setup_s=setup_s,
                        atlas_mib=r.gpu.tex_pages.numel() / 2 ** 20,
                        textures=int(r.gpu.page_sub.shape[0]) - 1)
            log(f"bake {path}/{name}: {bake}")
        vs = run.views(eye, fwd, step, n_frames, dev)
        moved = name in MOVED.get(path, ()) and n_frames > MOVE_FRAME
        root_before = (torch.stack([r.ts.bvh.node_min[0],
                                    r.ts.bvh.node_max[0]]).clone()
                       if moved else None)
        _native.reset_launches()
        times, syncs = [], []
        with DeviceSpans(frame_mod, "refresh_trace_scene") as refreshes:
            for i, v in enumerate(vs):
                if moved and i == MOVE_FRAME:
                    move_instances(r, MOVE)
                t0 = time.perf_counter()
                out, sync_sites = counting_syncs(lambda: run.step(v))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                syncs.append(sum(sync_sites.values()))
        counts = dict(_native.launches)
        if len(refreshes.events) != int(moved):
            raise AssertionError(f"{path}/{name}: {len(refreshes.events)} "
                                 "trace scene refreshes in the frames")
        final = out["final"]
        if tuple(final.shape) != (HEIGHT, WIDTH, 3):
            raise AssertionError(f"{name}: final shape {tuple(final.shape)}")
        for k in FRAME_KEYS[path]:
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{path}/{name}: non-finite {k}")
        mean = float(final.mean())
        if mean <= 0.01:
            raise AssertionError(f"{path}/{name}: final mean {mean}")
        extra = {}
        if path not in ("raster", "refpt"):
            gi_mean = float(out["diffuse_gi"].mean())
            m_max = float(r.state["gi_res_M"].max())
            if gi_mean <= 1e-3 or float(out["diffuse_gi"].min()) < 0.0:
                raise AssertionError(f"{name}: diffuse GI mean {gi_mean}")
            if m_max <= 1.0:
                raise AssertionError(f"{name}: reservoirs never merged "
                                     f"(max M {m_max})")
            extra = dict(gi_mean=gi_mean, reservoir_m_max=m_max,
                         ssao_mean=float(out["ssao"].mean()))
        if path in ("default", "options", "textured"):
            refl = out["reflections"]
            if float(refl.min()) < 0.0:
                raise AssertionError(f"{name}: negative reflections")
            live = r.state["ircache_valid"]
            n_live = int(live.sum())
            if n_live <= 0:
                raise AssertionError(f"{name}: the irradiance cache is empty")
            sh_abs = float(r.state["ircache_sh"][live].abs().sum())
            if path in ("default", "textured") and sh_abs <= 0.0:
                raise AssertionError(f"{name}: the live cache entries' SH is "
                                     f"all zero after {n_frames} frames")
            extra.update(reflections_mean=float(refl.mean()),
                         ircache_live=n_live, ircache_sh_abs_sum=sh_abs,
                         rtr_res_m_max=float(r.state["rtr_res_M"].max()),
                         pre_mult=float(r.state["pre_mult"]))
        if path == "options":
            atlas = r.state["wrc_atlas"]
            if float(atlas.max()) <= 0.0:
                raise AssertionError(f"{name}: the radiance cache is dark")
            extra.update(wrc_atlas_mean=float(atlas.mean()),
                         primary_hit_frac=float(
                             out["gbuffer"]["hit"].float().mean()))
        if path == "textured":
            # the textures reach the g-buffer: an untextured scene has one
            # albedo per material, a textured one many more
            gb = out["gbuffer"]
            n_albedo = int(torch.unique(gb["albedo"][gb["hit"]].reshape(-1, 3),
                                        dim=0).shape[0])
            n_mat = int(r.gpu.mat_base_color.shape[0])
            if n_albedo <= 4 * n_mat:
                raise AssertionError(f"{name}: {n_albedo} distinct albedos "
                                     f"for {n_mat} materials")
            extra.update(distinct_albedo=n_albedo, bake=bake)
        if moved:
            extra.update(tlas_refit=refit_record(
                r, refreshes.ms()[0], root_before))
            log(f"tlas_refit {path}/{name} (frame {MOVE_FRAME}, every "
                f"instance moved by {MOVE}): {extra['tlas_refit']}, host "
                f"syncs of that frame {syncs[MOVE_FRAME]}")
        if path == "refpt":
            samples = float(run.ref_state["refpt_samples"])
            if samples != n_frames:
                raise AssertionError(f"{name}: {samples} PT samples")
            extra.update(lit_mean=float(out["lit"].mean()),
                         refpt_samples=samples)
        want = expected_launches(path, route_of(r.ts),
                                 int(r.gpu.num_lights) > 0, n_frames)
        if counts != want:
            raise AssertionError(f"{path}/{name}: launches {counts}, "
                                 f"expected {want}")
        result[name] = dict(frame_ms=times, median_ms=statistics.median(times),
                            launches=counts, host_syncs=syncs,
                            last_frame_sync_sites=dict(sync_sites),
                            final_mean=mean, route=route_of(r.ts),
                            tris=int(r.gpu.num_triangles), setup_s=setup_s,
                            setup_parts_s=setup, **extra)
        if path != "refpt":
            result[name]["hit_frac"] = float(
                out["gbuffer"]["hit"].float().mean())
        log(f"frame {path}/{name}: {int(r.gpu.num_triangles)} tris "
            f"({route_of(r.ts)} route), setup {setup_s:.1f} s (scene tables "
            f"{setup['gpu_scene']:.2f} s, trace scene "
            f"{setup['trace_scene']:.2f} s, of which the native BVH build "
            f"{setup['bvh_native']:.2f} s), frame ms "
            f"{[round(t, 2) for t in times]}, "
            f"launches {counts}, host syncs per frame {syncs}, final mean "
            f"{mean:.4f} {extra}")
    return result


def oracle_phase(dev):
    """The oracle datum on the card: the port's hybrid frame (16 frames)
    against the port's path tracer (48 progressive frames, 5 bounces, no
    pixel filter) on cornell at 64x48, as `tests/test_oracle.py` renders
    the pair, held to that test's bounds (tests/test_torch_oracle.py)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_oracle import BOUNDS, converged_pair, oracle_metrics

    t0 = time.perf_counter()
    metrics = oracle_metrics(*converged_pair(dev))
    metrics["seconds"] = time.perf_counter() - t0
    log("oracle datum (hybrid vs path tracer, cornell 64x48):", metrics)
    for name, (lo, hi) in BOUNDS.items():
        if not lo < metrics[name] < hi:
            raise AssertionError(f"oracle {name} {metrics[name]} outside "
                                 f"({lo}, {hi})")
    return metrics


def viewer_phase(tmp):
    """Two runs of the headless viewer, each in its own process as a user
    starts it: the path tracer on cornell, and the hybrid frame on one
    building glTF of the textured city (four maps) through the bake cache,
    kept in `tmp`. Each PNG must carry the asked size in its header, and
    the second run must leave its mesh in the cache."""
    from kajiya_tpu_torch.apps.view import read_png_header

    runs = {}
    cache = os.path.join(tmp, "bake_cache")
    for name, args in (
            ("pt", ["--mode", "reference", "--spp", "2"]),
            ("gltf", ["--scene", os.path.join(tmp, "meshes", "b1.gltf"),
                      "--frames", "2", "--camera", "2.5", "1.5", "2.5",
                      "-0.5", "-0.1", "-0.5"])):
        out = os.path.join(tmp, f"{name}.png")
        cmd = [sys.executable, "-m", "kajiya_tpu_torch.apps.view", *args,
               "--width", "320", "--height", "180", "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600,
                              env={**os.environ, "KAJIYA_TPU_CACHE": cache})
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"viewer ({name}) exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        header = read_png_header(out)
        if header != (320, 180, 8, 2):
            raise AssertionError(f"viewer ({name}) PNG header {header}")
        log(f"viewer ({name}): {proc.stdout.strip()} ({seconds:.1f} s with "
            "start-up)")
        runs[name] = {"seconds": seconds, "png": list(header),
                      "stdout": proc.stdout.strip()}
    if not any(f.endswith(".mesh.npz") for f in os.listdir(cache)):
        raise AssertionError("the viewer left no mesh in the bake cache")
    return runs


# ----------------------------------------------------------------------------
# The live viewer, hello and hot reload, each run as a user starts it
# ----------------------------------------------------------------------------

STREAM_REQUESTS = ("use_rtr=false", "show=ssao", "sun=30,40", "emissive=2")
STREAM_PARTS = 8          # /stream parts read (and timed) at 1080p


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class StreamServer:
    """`python -m kajiya_tpu_torch.apps.stream` in its own process on a free
    localhost port, its output in `tmp`; stopped on exit."""

    def __init__(self, tmp, name, args):
        self.port = free_port()
        self.log_path = os.path.join(tmp, f"stream_{name}.log")
        self.cmd = [sys.executable, "-m", "kajiya_tpu_torch.apps.stream",
                    *args, "--port", str(self.port)]
        self.name = name

    def __enter__(self):
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, stdout=self._log,
                                     stderr=subprocess.STDOUT)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._log.close()

    def get(self, path, timeout=60):
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=timeout) as r:
            return r.read()

    def json(self, path):
        return json.loads(self.get(path))

    def wait(self, ready, timeout=600):
        """Poll /status until `ready(status)`; fail if the server died, the
        time ran out or a frame failed."""
        import urllib.error

        t_end = time.perf_counter() + timeout
        while True:
            if self.proc.poll() is not None:
                with open(self.log_path) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"stream server ({self.name}) exited "
                                   f"{self.proc.returncode}:\n{tail}")
            try:
                st = self.json("/status")
                if st["last_error"] is not None:
                    raise AssertionError(f"stream ({self.name}): frame "
                                         f"failed: {st['last_error']}")
                if ready(st):
                    return st
            except (urllib.error.URLError, ConnectionError):
                pass
            if time.perf_counter() > t_end:
                raise TimeoutError(f"stream server ({self.name}) not ready "
                                   f"in {timeout} s")
            time.sleep(0.2)

    def newer_frames(self, n=2):
        """Wait until `n` more frames were presented: the second one began
        after every request made before this call."""
        n0 = self.json("/status")["frames"]
        return self.wait(lambda s: s["frames"] >= n0 + n)

    def stream_parts(self, n):
        """Read `n` parts of /stream: [(arrival time, JPEG bytes, frames
        presented by then)]."""
        import urllib.request

        parts = []
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/stream", timeout=60) as r:
            if "multipart/x-mixed-replace" not in r.headers["Content-Type"]:
                raise AssertionError(f"/stream: {r.headers['Content-Type']}")
            while len(parts) < n:
                if r.readline() != b"--frame\r\n":
                    raise AssertionError("/stream: no part boundary")
                headers = {}
                while (line := r.readline().strip()):
                    k, v = line.decode().split(":", 1)
                    headers[k.strip().lower()] = v.strip()
                if headers.get("content-type") != "image/jpeg":
                    raise AssertionError(f"/stream part headers {headers}")
                body = r.read(int(headers["content-length"]))
                r.readline()
                parts.append((time.perf_counter(), body,
                              self.json("/status")["frames"]))
        return parts


def stream_phase(tmp):
    """The live viewer as a user starts it: `python -m
    kajiya_tpu_torch.apps.stream --scene city --width 1920 --height 1080`
    on the card. /snap must be a 1920x1080 PNG and each /stream part a
    1920x1080 JFIF (the port's own SOF0 parse). Then the requests of
    STREAM_REQUESTS in turn, each followed by newer frames with
    `last_error` null (`use_rtr=false` rebuilds the frame). The city has no
    emitter, so a second, short server on cornell (640x360), started after
    the city's has stopped so that the city's numbers have the card to
    themselves, shows that `/set?emissive=2` moves the frame: its emissive
    g-buffer plane brightens.
    Logged: frame ms (wall, the server's), JPEG encode ms and bytes of a
    1080p part (the server's, and timed here on the /snap frame), /snap's
    PNG encode ms, and /stream parts a second. Each server's kernel
    launches (counted from 0 in its own process, read from /status before
    it stops) must include every kernel of its route; they stay in this
    phase's record and are not added to the kernels line."""
    from kajiya_tpu_torch.apps.view import read_png_header
    from kajiya_tpu_torch.scene.jpeg import encode_jpeg, read_jpeg_header
    from kajiya_tpu_torch.scene.png import decode_png

    t0 = time.perf_counter()
    rec = {"requests": {}, "launches": {}}
    with StreamServer(tmp, "city", ["--scene", "city", "--width", "1920",
                                    "--height", "1080"]) as city:
        st = city.wait(lambda s: s["frames"] >= 2)
        rec["start_s"] = time.perf_counter() - t0
        snap = city.get("/snap")
        snap_path = os.path.join(tmp, "stream_snap.png")
        with open(snap_path, "wb") as f:
            f.write(snap)
        if read_png_header(snap_path) != (WIDTH, HEIGHT, 8, 2):
            raise AssertionError(f"/snap header {read_png_header(snap_path)}")
        parts = city.stream_parts(STREAM_PARTS)
        st = city.json("/status")
        for _, body, _ in parts:
            if read_jpeg_header(body) != (WIDTH, HEIGHT, 3):
                raise AssertionError(f"/stream part {read_jpeg_header(body)}")
        span = parts[-1][0] - parts[0][0]
        rec.update(
            parts=len(parts), parts_per_s=(len(parts) - 1) / span,
            frames_per_s=(parts[-1][2] - parts[0][2]) / span,
            jpeg_bytes=[len(b) for _, b, _ in parts],
            server_encode=st["encode"], frame_ms_wall=st["frame_ms_wall"],
            snap_png_bytes=len(snap))
        rgb = decode_png(snap)[..., :3].copy()
        enc = []
        for _ in range(5):
            t1 = time.perf_counter()
            encode_jpeg(rgb)
            enc.append((time.perf_counter() - t1) * 1e3)
        rec["jpeg_encode_ms_here"] = enc
        for q in STREAM_REQUESTS:
            r = city.json(f"/set?{q}")
            if "error" in r:
                raise AssertionError(f"/set?{q}: {r}")
            st = city.newer_frames()
            rec["requests"][q] = {"reply": r,
                                  "frame_ms_wall": st["frame_ms_wall"]}
        if st["config"]["use_rtr"] is not False or st["show"] != "ssao":
            raise AssertionError(f"/set not applied: {st}")
        st = city.json("/status")
        rec["server_encode_end"] = st["encode"]
        rec["launches"]["city"] = st["launches"]
    with StreamServer(tmp, "cornell", ["--scene", "cornell_box"]) as corn:
        corn.wait(lambda s: s["frames"] >= 2)
        corn.json("/set?show=gbuffer.emissive")
        corn.newer_frames()
        before = decode_png(corn.get("/snap"))[..., :3].astype(int)
        corn.json("/set?emissive=2")
        st_c = corn.newer_frames()
        after = decode_png(corn.get("/snap"))[..., :3].astype(int)
        brighter = int((after > before).any(-1).sum())
        if brighter == 0 or (after < before).any():
            raise AssertionError("cornell: /set?emissive=2 did not brighten "
                                 "the emissive plane")
        rec["cornell_emissive_pixels_brighter"] = brighter
        rec["cornell_frame_ms_wall"] = st_c["frame_ms_wall"]
        rec["launches"]["cornell"] = corn.json("/status")["launches"]
    # each server counts from 0 in its own process: every kernel of its
    # scene's route must have run in its frames
    for sc, route in (("city", "woop_culled"), ("cornell", "woop_brute")):
        got = rec["launches"][sc]
        if min(got[k] for k in (route, "warp", "tile_shift")) <= 0:
            raise AssertionError(f"stream ({sc}): launches {got}")
    rec["seconds"] = time.perf_counter() - t0
    log(f"stream: city 1080p frame {rec['frame_ms_wall']} ms wall (server), "
        f"{rec['frames_per_s']:.2f} frames/s; /stream "
        f"{rec['parts_per_s']:.2f} parts/s, JPEG {rec['server_encode']}"
        f" (server), {statistics.median(enc):.1f} ms here for "
        f"{rec['jpeg_bytes'][-1]} bytes; requests {rec['requests']}; "
        f"cornell emissive x2 brightened {brighter} px; "
        f"{rec['seconds']:.1f} s")
    return rec


def hello_phase(tmp):
    """`python -m kajiya_tpu_torch.apps.hello` in a fresh working directory:
    out/hello.png must be a 640x360 RGB PNG."""
    from kajiya_tpu_torch.apps.view import read_png_header

    work = os.path.join(tmp, "hello")
    os.makedirs(work)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kajiya_tpu_torch.apps.hello"],
                          cwd=work, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"hello exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    header = read_png_header(os.path.join(work, "out", "hello.png"))
    if header != (640, 360, 8, 2):
        raise AssertionError(f"hello PNG header {header}")
    log(f"hello: {proc.stdout.strip()} ({seconds:.1f} s with start-up)")
    return {"seconds": seconds, "png": list(header)}


# run in a copy of the package: hot reload of a pass module and of kernel W
WATCH_SCRIPT = r"""
import json, os, sys, time
import torch
import kajiya_tpu_torch
root = os.path.dirname(os.path.abspath(kajiya_tpu_torch.__file__))
assert root.startswith(os.getcwd()), root
from kajiya_tpu_torch.core.reload import ModuleWatcher
from kajiya_tpu_torch.ops import _native, warp_cuda
import kajiya_tpu_torch.renderers.ssgi

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
img = torch.rand((540, 960, 13), generator=g, device=dev)
uv = torch.rand((540, 960, 2), generator=g, device=dev) * 1.1 - 0.05

def err():
    k = warp_cuda.warp_launch(img, uv, True)
    return float((k - warp_cuda.warp_plain(img, uv, True)).abs().max())

err0 = err()
path0 = _native.library_path()
n0 = _native.launches["warp"]
w = ModuleWatcher()
for rel, line in (("csrc/warp.cu", "// hot reload check\n"),
                  ("renderers/ssgi.py", "# hot reload check\n")):
    p = os.path.join(root, rel)
    with open(p, "a") as f:
        f.write(line)
    t = time.time() + 2
    os.utime(p, (t, t))
t0 = time.perf_counter()
names = w.poll()
poll_s = time.perf_counter() - t0
n1 = _native.launches["warp"]
err1 = err()
print(json.dumps(dict(names=names, poll_s=poll_s, err0=err0, err1=err1,
                      path0=path0, path1=_native.library_path(),
                      build_dir=_native.BUILD_DIR, launches=[n0, n1,
                      _native.launches["warp"]])))
"""


def watch_phase(tmp):
    """Hot reload on the card, in a copy of the package in `tmp`: a
    ModuleWatcher sees an appended comment in the copy's csrc/warp.cu and
    in renderers/ssgi.py; `poll()` must report both, rebuild the kernel
    library into the copy's `_build/` (one nvcc run of the four sources),
    load it in place of the old one and keep the launch counts; kernel W
    from the new library must equal its plain version; the repo's own
    `_build/` must be left as it was."""
    def listing(d):
        return sorted((n, os.stat(os.path.join(d, n)).st_mtime_ns)
                      for n in os.listdir(d)) if os.path.isdir(d) else []

    work = os.path.join(tmp, "watch")
    shutil.copytree(os.path.join(REPO, "kajiya_tpu_torch"),
                    os.path.join(work, "kajiya_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    repo_build = os.path.join(REPO, "kajiya_tpu_torch", "_build")
    before = listing(repo_build)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (work, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", WATCH_SCRIPT], cwd=work,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"watch script exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {"kajiya_tpu_torch.csrc.warp", "kajiya_tpu_torch.renderers.ssgi"}
    if not want <= set(res["names"]):
        raise AssertionError(f"watch: poll reported {res['names']}")
    if res["path1"] == res["path0"] or not res["path1"].startswith(work):
        raise AssertionError(f"watch: library {res['path0']} -> "
                             f"{res['path1']}")
    if not max(res["err0"], res["err1"]) <= WARP_TOL:
        raise AssertionError(f"watch: warp errors {res['err0']}, "
                             f"{res['err1']}")
    n0, n1, n2 = res["launches"]
    if not (n0 >= 1 and n1 == n0 and n2 == n1 + 1):
        raise AssertionError(f"watch: launch counts {res['launches']}")
    if listing(repo_build) != before:
        raise AssertionError("watch: the repo's _build/ changed")
    res["seconds"] = seconds
    log(f"watch: poll reported {res['names']} in {res['poll_s']:.1f} s "
        f"(nvcc of {len(want)} names), W err {res['err1']}, "
        f"{seconds:.1f} s with start-up")
    return res


# ----------------------------------------------------------------------------
# The sharded phase: the tile-sharded GI and default frames, the multi-host
# layout, the sample-sharded path tracer and the scene distribution, on
# SHARDED_RANKS ranks sharing the card over gloo
# ----------------------------------------------------------------------------

SHARDED_RANKS = 4
# the sharded paths, frames per scene of each (the default frame's first
# validates the reservoirs and the cache, the others run TAA, RTR's
# temporal reuse and motion blur on history; the options frame adds the
# traced g-buffer, the world radiance cache and depth of field; the
# super-resolution frame renders 1280x720 and shows 1920x1080) and the
# planes gathered of each
SHARDED_FRAMES = {"gi": 2, "default": 3, "options": 2, "superres": 3}
# the paths whose sharded frames must equal the whole card's bit for bit
SHARDED_EXACT = ("default", "options", "superres")
SHARDED_SCENES = ("cornell", "city")
SHARDED_BACKEND = "gloo"    # NCCL refuses two ranks on one card
SHARDED_KEYS = {path: FRAME_KEYS[path] for path in SHARDED_FRAMES}


def within(a, b, tols, relative=False):
    """(fraction of elements within tols[0], mean abs difference, ok) of a
    against b; `relative` scales the difference by max(1, |b|) (state
    planes that hold world positions and reservoir weights)."""
    tol, min_frac, max_mean = tols
    d = (a.float() - b.float()).abs()
    if relative:
        d = d / torch.clamp(b.float().abs(), min=1.0)
    frac = float((d <= tol).float().mean()) if d.numel() else 1.0
    mean = float(d.mean()) if d.numel() else 0.0
    ok = bool(torch.isfinite(a.float()).all()) and frac >= min_frac \
        and mean <= max_mean
    return frac, mean, ok


def scene_digest(tree):
    """sha256 over the bytes of every tensor of a scene tree, field order."""
    import hashlib

    from kajiya_tpu_torch.parallel.mesh import _skeleton

    leaves = []
    _skeleton(tree, leaves)
    h = hashlib.sha256()
    for t in leaves:
        h.update(repr((tuple(t.shape), t.dtype)).encode())
        if t.numel():
            h.update(t.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
    return h.hexdigest(), len(leaves)


def ircache_digest(state):
    """sha256 over the bytes of a state's irradiance-cache tables."""
    return scene_digest({k: v for k, v in sorted(state.items())
                         if k.startswith("ircache_")})[0]


def sharded_cfg(path, ts, width, height):
    """The sharded path's configuration on a scene whose frames are shown
    at width x height: the default frame and its options as `Renderer`
    resolves them (mesh-light specular where the scene has emissive
    triangles), with the full-size irradiance cache and world radiance
    cache; the super-resolution frame renders SUPERRES times smaller."""
    from dataclasses import replace

    if path == "superres":
        width, height = round(width / SUPERRES), round(height / SUPERRES)
    cfg = slice_cfg(width, height, path)
    if path != "gi" and int(ts.gpu.num_lights) > 0:
        cfg = replace(cfg, use_mesh_light_specular=True)
    return cfg


def sharded_path(name, path, ts, mesh, width, height, dev, sync):
    """SHARDED_FRAMES[path] tile-sharded frames of `path` on this rank
    (launch counters set to 0 just before, read just after, and held to
    `expected_launches`; per frame its ms, its launches and its collectives
    by kind, with the bytes of each label); rank 0 then renders the same
    frames on the whole card and holds the gathered outputs and every
    state plane to them: the paths of SHARDED_EXACT bit for bit (and every
    rank's irradiance-cache tables to the whole card's), the GI frame at
    GI_FRAME_TOL. Returns (entry, failures, the first view, the
    configuration, the gathered outputs of the first frame)."""
    import torch.distributed as dist

    from kajiya_tpu_torch.frame import init_frame_state, render_frame
    from kajiya_tpu_torch.ops import _native
    from kajiya_tpu_torch.parallel import (check_sharding_quality,
                                           collective_summary,
                                           render_frame_sharded)
    from kajiya_tpu_torch.parallel.mesh import gather_frame

    _make, eye, fwd, step = SCENES[name]
    keys = SHARDED_KEYS[path]
    failed = []
    cfg = sharded_cfg(path, ts, width, height)
    vs = views(eye, fwd, step, SHARDED_FRAMES[path], cfg.width, cfg.height,
               dev, jitter=path != "gi")
    st = init_frame_state(cfg, device=dev)
    frames, logs, first, digests = [], [], None, []
    _native.reset_launches()
    for v in vs:
        dist.barrier()
        sync()
        before = dict(_native.launches)
        t0 = time.perf_counter()
        with mesh.comm.recording() as log:
            st, out = render_frame_sharded(ts, st, v, cfg, None, mesh)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        logs.append(log)
        frames.append(dict(
            ms=ms, launches={k: n - before.get(k, 0)
                             for k, n in _native.launches.items()},
            collectives=collective_summary(log)))
        if first is None:
            first = {k: out[k] for k in keys}
        if cfg.use_ircache:
            digests.append(ircache_digest(st))
    launches = dict(_native.launches)
    want = expected_launches(path, route_of(ts), int(ts.gpu.num_lights) > 0,
                             len(vs))
    if launches != want and dev.type == "cuda":
        failed.append(f"{name}/{path}: rank {mesh.index} launches "
                      f"{launches}, expected {want}")
    merged = [e for part in mesh.comm.gather_objects(
        [e for log in logs for e in log]) for e in part]
    # planes counted at the output size, the frame's largest
    summary, problems = check_sharding_quality(merged, cfg.out_height,
                                               cfg.out_width)
    if problems or "halo" not in summary:
        failed.append(f"{name}/{path}: sharding quality {problems} "
                      f"{summary}")
    cache = [e for e in merged if e.ircache]
    if cfg.use_ircache and not cache:
        failed.append(f"{name}/{path}: no collective booked as the cache's")
    all_digests = mesh.comm.gather_objects(digests)
    whole = gather_frame({"out": {k: out[k] for k in keys}, "state": st,
                          "first": first}, mesh, cfg)
    times = [f["ms"] for f in frames]
    entry = dict(frame_ms=times, median_ms=statistics.median(times),
                 launches=launches, frames=frames,
                 collectives=collective_summary(merged),
                 ircache_collectives=collective_summary(cache),
                 collectives_per_frame=len(merged) // len(logs))
    if mesh.index == 0:
        st1 = init_frame_state(cfg, device=dev)
        single_ms, single_digests = [], []
        for v in vs:
            sync()
            t0 = time.perf_counter()
            st1, out1 = render_frame(ts, st1, v, cfg)
            sync()
            single_ms.append((time.perf_counter() - t0) * 1e3)
            if cfg.use_ircache:
                single_digests.append(ircache_digest(st1))
        exact_required = path in SHARDED_EXACT
        if exact_required and any(d != single_digests for d in all_digests):
            failed.append(f"{name}/{path}: ircache tables per rank "
                          f"{all_digests}, whole card {single_digests}")
        cmp, exact, differ = {}, 0, []
        pairs = [(f"out/{k}", whole["out"][k], out1[k], False) for k in keys]
        pairs += [(f"state/{k}", whole["state"][k], st1[k], True)
                  for k in st1]
        for key, a, b, rel in pairs:
            if tuple(a.shape) != tuple(b.shape):
                failed.append(f"{name}/{path}/{key}: shape {tuple(a.shape)} "
                              f"vs {tuple(b.shape)}")
                continue
            same = bool(torch.equal(a, b))
            exact += int(same)
            frac, mean, ok = within(a, b, GI_FRAME_TOL, relative=rel)
            cmp[key] = (frac, mean)
            if not same:
                differ.append(key)
            if not ok or (exact_required and not same):
                failed.append(f"{name}/{path}/{key}: sharded vs whole card "
                              f"bit exact {same} frac {frac} mean {mean}")
        entry.update(single_frame_ms=single_ms,
                     single_median_ms=statistics.median(single_ms),
                     planes_bit_exact=exact, planes=len(pairs),
                     planes_differing=differ,
                     ircache_digests_equal=all(d == single_digests
                                               for d in all_digests),
                     worst=min(cmp.items(), key=lambda kv: kv[1][0]))
        del st1, out1
    dist.barrier()
    return entry, failed, vs[0], cfg, whole["first"]


def sharded_rank(mesh_args, out_dir, device="cuda", size=(WIDTH, HEIGHT)):
    """One rank of the sharded phase (started by `parallel.launch.spawn`).
    Per scene: rank 0 builds the scene and `distribute_scene` sends it to
    the others (held bit for bit by digest); then each path of
    SHARDED_FRAMES (`sharded_path`); on the city one (2, 2) multi-host GI
    frame, held to the four-tile frame. Last, the city's 1080p camera rays
    through `shard_rays_pt` (16 bounces), held by rank 0 to `path_trace`.
    Each rank writes rank<r>.json to out_dir."""
    import torch.distributed as dist

    from kajiya_tpu_torch.core.camera import camera_rays
    from kajiya_tpu_torch.frame import init_frame_state
    from kajiya_tpu_torch.ops import _native
    from kajiya_tpu_torch.parallel import (collective_summary,
                                           distribute_scene, make_mesh,
                                           make_multihost_mesh,
                                           render_frame_multihost,
                                           shard_rays_pt)
    from kajiya_tpu_torch.parallel.mesh import gather_frame
    from kajiya_tpu_torch.renderers.reference import path_trace
    from kajiya_tpu_torch.scene import procedural
    from kajiya_tpu_torch.scene.scene import build_gpu_scene
    from kajiya_tpu_torch.world import build_trace_scene

    rank = mesh_args[0]
    dev = torch.device(device)
    width, height = size
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_start = time.perf_counter()
    if dev.type == "cuda":
        _native.library()
    mesh = make_mesh(device=dev)
    multi = make_multihost_mesh(shape=(2, 2), device=dev)
    band = mesh.band(height, width)
    res = {"rank": rank, "backend": mesh.backend, "band_rows": band.rows,
           "multihost_shape": multi.shape, "scenes": {}}
    failed = []
    ts_city = None
    for name in SHARDED_SCENES:
        make = SCENES[name][0]
        t0 = time.perf_counter()
        ts0 = None
        if rank == 0:
            ts0 = build_trace_scene(build_gpu_scene(make(procedural),
                                                    device=dev),
                                    device=dev)[0]
        ts = distribute_scene(ts0, mesh)
        sync()
        dist_s = time.perf_counter() - t0
        digests = mesh.comm.gather_objects(scene_digest(ts))
        if rank == 0 and digests != [scene_digest(ts0)] * mesh.size:
            failed.append(f"{name}: distribute_scene digests {digests}")
        paths = {}
        for path in SHARDED_FRAMES:
            entry, bad, v0, cfg, first = sharded_path(
                name, path, ts, mesh, width, height, dev, sync)
            failed += bad
            if name == "city" and path == "gi":
                ts_city = ts
                with multi.comm.recording() as mlog:
                    _st, mout = render_frame_multihost(
                        ts, init_frame_state(cfg, device=dev), v0, cfg,
                        None, multi)
                mfinal = gather_frame(mout["final"], multi, cfg)
                merged_m = [e for part in multi.comm.gather_objects(
                    list(mlog)) for e in part]
                entry["multihost"] = dict(
                    collectives=collective_summary(merged_m),
                    inter_host_bytes=sum(e.inter_host_bytes
                                         for e in merged_m))
                if rank == 0:
                    frac, mean, ok = within(mfinal, first["final"],
                                            GI_FRAME_TOL)
                    entry["multihost"].update(
                        bit_exact=bool(torch.equal(mfinal, first["final"])),
                        frac=frac, mean=mean)
                    if not ok:
                        failed.append(f"{name}: multi-host frame vs 4 tiles "
                                      f"frac {frac} mean {mean}")
                del mout, _st
            paths[path] = entry
            del first
        res["scenes"][name] = dict(distribute_s=dist_s,
                                   tensors=digests[0][1], paths=paths)
        del ts, ts0
    # the sample-sharded path tracer on the city's 1080p camera rays
    v = views(*SCENES["city"][1:], 1, width, height, dev)[0]
    org, d = camera_rays(v, width, height)
    org, d = org.reshape(-1, 3), d.reshape(-1, 3)
    seed = torch.arange(org.shape[0], dtype=torch.int64, device=dev)
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    rad = shard_rays_pt(ts_city, org, d, seed, mesh, num_bounces=PT_BOUNCES)
    sync()
    pt = {"sharded_ms": (time.perf_counter() - t0) * 1e3}
    if rank == 0:
        sync()
        t0 = time.perf_counter()
        ref = path_trace(ts_city, org, d, seed, num_bounces=PT_BOUNCES)
        sync()
        frac, mean, ok = within(rad, ref, PT_FRAME_TOL)
        pt.update(single_ms=(time.perf_counter() - t0) * 1e3,
                  bit_exact=bool(torch.equal(rad, ref)),
                  rays_differing=int((rad != ref).any(dim=-1).sum()),
                  frac=frac, mean=mean)
        if not ok:
            failed.append(f"shard_rays_pt vs path_trace frac {frac} "
                          f"mean {mean}")
    res["pt"] = pt
    res["wall_s"] = time.perf_counter() - t_start
    res["failed"] = failed
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    if failed:
        raise AssertionError("; ".join(failed))


def sharded_phase():
    """SHARDED_RANKS ranks of `sharded_rank` on the one card, started with
    `parallel.launch.spawn` over gloo; a rank that fails fails the phase
    with its traceback."""
    from kajiya_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    launch.spawn(sharded_rank, SHARDED_RANKS, args=(out_dir,),
                 backend=SHARDED_BACKEND, timeout_s=900)
    ranks = []
    for r in range(SHARDED_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]

    def path_result(name, path):
        per = [r["scenes"][name]["paths"][path] for r in ranks]
        e0 = per[0]
        return {
            "median_frame_ms_per_rank": [e["median_ms"] for e in per],
            "frame_ms_per_rank": [e["frame_ms"] for e in per],
            "launches_per_rank": [e["launches"] for e in per],
            "frames_per_rank": [e["frames"] for e in per],
            **{k: e0[k] for k in (
                "collectives", "ircache_collectives",
                "collectives_per_frame", "single_frame_ms",
                "single_median_ms", "planes_bit_exact", "planes",
                "planes_differing", "ircache_digests_equal", "worst")},
            **({"multihost": e0["multihost"]} if "multihost" in e0 else {})}

    result = {
        "backend": r0["backend"], "ranks": SHARDED_RANKS,
        "band_rows": r0["band_rows"], "wall_s": time.perf_counter() - t0,
        "scenes": {name: {
            "distribute_s": r0["scenes"][name]["distribute_s"],
            "tensors": r0["scenes"][name]["tensors"],
            "paths": {path: path_result(name, path)
                      for path in SHARDED_FRAMES}}
            for name in SHARDED_SCENES},
        "pt": {**r0["pt"], "sharded_ms_per_rank": [r["pt"]["sharded_ms"]
                                                   for r in ranks]},
    }
    for name in SHARDED_SCENES:
        for path in SHARDED_FRAMES:
            s = result["scenes"][name]["paths"][path]
            log(f"sharded/{name}/{path}: backend {result['backend']}, bands "
                f"{result['band_rows']}, median frame ms per rank "
                f"{s['median_frame_ms_per_rank']} (whole card "
                f"{s['single_median_ms']:.1f}), {s['planes_bit_exact']} of "
                f"{s['planes']} planes bit for bit, worst {s['worst']}, "
                f"collectives {s['collectives']}")
    log(f"sharded/pt: {result['pt']}")
    log(f"sharded phase wall {result['wall_s']:.1f} s")
    return result


PHASE_S = {}


def timed(name, phase, *args):
    """phase(*args), its wall seconds kept in PHASE_S and logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f} s")
    return out


def kernel_entry(name, source, replaces, cases, launches, library):
    """One JSON entry per kernel: the sum over its cases (one launch at each
    shape the frame gives it; a case marked `frame_call=False` is listed but
    not summed), the worst error over all cases, and the launches of the
    main paths' runs summed over paths and scenes."""
    summed = [c for c in cases if c.get("frame_call", True)]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=sum(c["ms"] for c in summed),
        plain_ms=sum(c["plain_ms"] for c in summed),
        bound_ms=sum(c["bound_ms"] for c in summed),
        bound_by=max(summed, key=lambda c: c["bound_ms"])["bound_by"],
        library_ms=(sum(c["library_ms"] for c in summed) if library else None),
        cases=cases)


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    from kajiya_tpu_torch.ops import _native
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    print(card, flush=True)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _native.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    ibl = os.path.join(tmp, "sky.hdr")
    write_panorama(ibl)
    scenes, fmt_maps = asset_scenes(tmp)
    SCENES.update(scenes)
    formats = timed("formats", format_phase, fmt_maps)
    webp_fixtures = timed("webp", webp_phase)
    tiff_fixtures = timed("tiff", tiff_phase)
    studio_fixtures = timed("studio", studio_phase)
    plugin_fixtures = timed("plugins", plugin_phase)
    # the small frames' CPU side runs beside the kernel phases
    pool, cpu_side = start_reference_cpu(tmp, ibl)
    try:
        brute = timed("brute", brute_phase, dev)
        culled = timed("culled", culled_phase, dev)
        warp = timed("warp", warp_phase, dev)
        tileshift = timed("tileshift", tileshift_phase, dev)
        bvh = timed("bvh", bvh_phase, dev)
        timed("reference", reference_phase, dev, ibl, cpu_side)
    finally:
        pool.shutdown(cancel_futures=True)
    frames = {path: timed(f"frames_{path}", frame_phase, dev, path, ibl)
              for path in N_FRAMES}
    # the default frame's passes wait for the card nowhere the GI frame's
    # do not: the same frame indices make the same number of host syncs
    # (from frame 1: a path's first frame also copies the constants it
    # caches on the card, once)
    for sc in PATH_SCENES["default"]:
        if sc in frames["gi"]:
            got, want = (frames[p][sc]["host_syncs"][1:] for p in ("default",
                                                                   "gi"))
            if got != want:
                raise AssertionError(f"default/{sc}: host syncs per frame "
                                     f"{got}, the GI frame's {want}")
        # the path tracer's frame (16 bounces of trace, shade, NEE) waits
        # for the card only where the default frame's post chain does
        pt = frames["refpt"][sc]["last_frame_sync_sites"]
        own = set(pt) - set(frames["default"][sc]["last_frame_sync_sites"])
        if own:
            raise AssertionError(f"refpt/{sc}: host syncs at {sorted(own)}")
    # the BVH route waits for the card nowhere the culled route does not:
    # from frame 1 on, a city40 default frame (frame MOVE_FRAME refits the
    # BVH after its instances moved) makes no more host syncs than the
    # city's default frame of the same index
    got = frames["default"]["city40"]["host_syncs"][1:]
    want = frames["default"]["city"]["host_syncs"][1:len(got) + 1]
    if any(g > w_ for g, w_ in zip(got, want)):
        raise AssertionError(f"default/city40: host syncs per frame {got}, "
                             f"the city's {want}")
    # the texture fetch waits for the card nowhere: from frame 1 on, a
    # textured frame makes no more host syncs than the untextured default
    # frame of the same index on the same geometry
    for sc, plain in UNTEXTURED.items():
        got = frames["textured"][sc]["host_syncs"][1:]
        want = frames["default"][plain]["host_syncs"][1:len(got) + 1]
        if any(g > w_ for g, w_ in zip(got, want)):
            raise AssertionError(f"textured/{sc}: host syncs per frame {got}, "
                                 f"the untextured {plain} frame's {want}")
    log("textured city frame ms", frames["textured"]["tcity"]["frame_ms"],
        "mixed-format city frame ms",
        frames["textured"]["tcityfmt"]["frame_ms"],
        "legacy-format city frame ms",
        frames["textured"]["tcitylegacy"]["frame_ms"],
        "TIFF city frame ms", frames["textured"]["tcitytiff"]["frame_ms"],
        "studio city frame ms",
        frames["textured"]["tcitystudio"]["frame_ms"],
        "TIFF-codec city frame ms",
        frames["textured"]["tcitycodec"]["frame_ms"],
        "plugin city frame ms",
        frames["textured"]["tcityplugins"]["frame_ms"],
        "beside the untextured city's default frame ms",
        frames["default"]["city"]["frame_ms"], "(same call)")
    oracle = timed("oracle", oracle_phase, dev)
    viewer = timed("viewer", viewer_phase, tmp)
    apps = {name: timed(name, phase, tmp) for name, phase in (
        ("stream", stream_phase), ("hello", hello_phase),
        ("watch", watch_phase))}
    shutil.rmtree(tmp, ignore_errors=True)
    sharded = timed("sharded", sharded_phase)

    def launched(kernel):
        n = sum(frames[p][sc]["launches"][kernel]
                for p in frames for sc in frames[p])
        n += sum(per_rank[kernel] for sc in sharded["scenes"].values()
                 for p in sc["paths"].values()
                 for per_rank in p["launches_per_rank"])
        if n <= 0:
            raise AssertionError(f"{kernel} was never launched by a frame")
        return n

    kernels = [
        kernel_entry("woop_brute", "kajiya_tpu_torch/csrc/woop.cu",
                     "kajiya_tpu/ops/woop_pallas.py:31", brute,
                     launched("woop_brute"), False),
        kernel_entry("woop_culled", "kajiya_tpu_torch/csrc/woop.cu",
                     "kajiya_tpu/ops/woop_pallas.py:243", culled,
                     launched("woop_culled"), False),
        kernel_entry("warp", "kajiya_tpu_torch/csrc/warp.cu",
                     "kajiya_tpu/ops/warp_pallas.py:57", warp,
                     launched("warp"), True),
        kernel_entry("tile_shift", "kajiya_tpu_torch/csrc/tileshift.cu",
                     "kajiya_tpu/ops/tileshift_pallas.py:41", tileshift,
                     launched("tile_shift"), True),
        kernel_entry("bvh_walk", "kajiya_tpu_torch/csrc/bvh.cu",
                     "kajiya_tpu/rt/trace.py:78", bvh, launched("bvh_walk"),
                     False),
    ]
    wall_s = time.perf_counter() - t_start
    log(f"chip_smoke wall time {wall_s:.1f} s")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "wall_s": wall_s, "kernels": kernels,
                   "frames": frames, "oracle": oracle, "viewer": viewer,
                   "apps": apps, "formats": formats,
                   "webp_fixtures": webp_fixtures,
                   "tiff_fixtures": tiff_fixtures,
                   "studio_fixtures": studio_fixtures,
                   "plugin_fixtures": plugin_fixtures, "sharded": sharded,
                   "phase_s": PHASE_S}, f, indent=1)
    print(json.dumps({"frames": {
        path: {k: {"median_ms": v["median_ms"], "frame_ms": v["frame_ms"],
                   "tris": v["tris"], "launches": v["launches"],
                   "host_syncs": v["host_syncs"]}
               for k, v in per_scene.items()}
        for path, per_scene in frames.items()}, "oracle": oracle,
        "textured_bake": {sc: v["bake"]
                          for sc, v in frames["textured"].items()},
        "format_decode_ms": {k: v["ms"] for k, v in formats.items()},
        "webp_fixture_ms": {k: v["ms"] for k, v in webp_fixtures.items()},
        "tiff_fixture_ms": {k: v.get("ms") for k, v in
                            tiff_fixtures.items()},
        "studio_fixture_ms": {k: v.get("ms") for k, v in
                              studio_fixtures.items()},
        "plugin_fixture_ms": {k: v.get("ms") for k, v in
                              plugin_fixtures.items()},
        "setup_s": {f"{p}/{sc}": v["setup_parts_s"]
                    for p, per_scene in frames.items()
                    for sc, v in per_scene.items() if sc == "city40"},
        "tlas_refit": {f"{p}/{sc}": v["tlas_refit"]
                       for p, per_scene in frames.items()
                       for sc, v in per_scene.items() if "tlas_refit" in v},
        "stream": {k: apps["stream"][k] for k in (
            "frame_ms_wall", "frames_per_s", "parts_per_s", "server_encode",
            "jpeg_encode_ms_here", "snap_png_bytes", "seconds")},
        "watch_poll_s": apps["watch"]["poll_s"],
        "phase_s": PHASE_S, "wall_s": wall_s}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
