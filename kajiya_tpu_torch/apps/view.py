"""Headless viewer: render a scene to PNG frames (or a progressive PT image).

Port of `kajiya_tpu/apps/view.py`, with its flags plus `--device`: renders
N frames of the hybrid pipeline (temporal passes converge over frames; with
`--watch`, edited modules and kernel sources are reloaded between them), an
animated sequence, or the reference path tracer (one progressive frame per
sample) of a builtin procedural scene, a kajiya `.ron` scene or a
`.gltf` / `.glb` mesh, and writes PNGs through the port's own encoder
(`scene/png.py`; no imaging library is needed).

Usage:
  python -m kajiya_tpu_torch.apps.view --scene cornell_box --width 640 --height 360
  python -m kajiya_tpu_torch.apps.view --scene city --frames 16 -o out/city.png
  python -m kajiya_tpu_torch.apps.view --scene assets/scenes/x.ron -o out/x.png
  python -m kajiya_tpu_torch.apps.view --mode reference --spp 64 -o pt.png
  python -m kajiya_tpu_torch.apps.view --device cpu --width 32 --height 24
"""
from __future__ import annotations

import argparse
import os
import struct
import time
import zlib

import numpy as np

from ..scene.png import PNG_SIGNATURE, encode_png


def build_scene(name_or_path: str):
    """A builtin procedural scene by name, a `.ron` scene or a `.gltf` /
    `.glb` mesh (through the bake cache)."""
    from ..scene import procedural

    if hasattr(procedural, name_or_path):
        return getattr(procedural, name_or_path)()
    if name_or_path.endswith(".ron"):
        from ..scene.scene import load_ron_scene

        return load_ron_scene(name_or_path)
    if name_or_path.endswith((".gltf", ".glb")):
        from ..scene.cache import load_mesh_cached
        from ..scene.scene import Scene

        scene = Scene()
        scene.add_instance(scene.add_mesh(load_mesh_cached(name_or_path)))
        return scene
    raise SystemExit(f"unknown scene: {name_or_path}")


def save_png(path: str, img: np.ndarray):
    """Write an (H, W, 3) float image in [0, 1] as an 8-bit RGB PNG
    (`clip(img, 0, 1) * 255`, truncated)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    px = (np.clip(np.asarray(img, np.float32), 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(px))


def read_png_header(path: str):
    """(width, height, bit_depth, color_type) from a PNG's IHDR chunk;
    raises ValueError for a file that is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    if zlib.crc32(head[12:29]) & 0xFFFFFFFF != struct.unpack(
            ">I", head[29:33])[0]:
        raise ValueError(f"{path}: IHDR checksum mismatch")
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, color


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="cornell_box",
                   help="builtin procedural scene name (cornell_box, city, "
                        "textured_cornell_box, ...), .ron scene, or "
                        ".gltf/.glb mesh")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--temporal-upsampling", type=float, default=1.0)
    p.add_argument("--primary", choices=("trace", "raster"), default="raster",
                   help="primary visibility: coherent trace or the binned "
                        "software rasterizer (RTX-off path)")
    p.add_argument("--rtx-off", action="store_true",
                   help="raster primary + no ray-traced passes (dummy "
                        "shadow / GI / reflection inputs)")
    p.add_argument("--mode", choices=("standard", "reference"),
                   default="standard")
    p.add_argument("--frames", type=int, default=8,
                   help="hybrid frames to accumulate before the final dump")
    p.add_argument("--spp", type=int, default=16, help="reference-mode spp")
    p.add_argument("--camera", type=float, nargs=6,
                   default=(0.0, 0.0, 2.4, 0.0, 0.0, -1.0),
                   metavar=("PX", "PY", "PZ", "DX", "DY", "DZ"))
    p.add_argument("--fov", type=float, default=55.0)
    p.add_argument("--debug-mode", default="none")
    p.add_argument("--ibl", default=None, help=".hdr environment map path")
    p.add_argument("--ev", type=float, default=0.0)
    p.add_argument("--dump-every", type=int, default=0,
                   help="if >0, write every Nth frame")
    p.add_argument("--watch", action="store_true",
                   help="hot reload: rebuild the frame when kajiya_tpu_torch "
                        "modules or CUDA kernel sources are edited (temporal "
                        "state survives, failures keep the last good frame "
                        "and the loaded kernels)")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render an N-frame animated sequence: keyframed "
                        "orbit camera through the smoothed rig, a moving "
                        "sun, and a spinning instance transform")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("-o", "--output", default="out/frame.png")
    args = p.parse_args(argv)

    from ..core.camera import make_view_constants
    from ..frame import (RenderConfig, Renderer, init_reference_state,
                         jitter_for_frame, render_frame_reference)

    scene = build_scene(args.scene)
    kw = dict(primary=args.primary)
    if args.rtx_off:
        # RT off: dummy shadow / GI / reflection inputs; raster primary;
        # screen-space AO stays
        kw = dict(primary="raster", sun_soft_shadows=False,
                  use_rtdgi=False, use_rtr=False, use_ircache=False,
                  use_restir_gi=False)
    cfg = RenderConfig(width=args.width, height=args.height,
                       temporal_upsampling=args.temporal_upsampling,
                       debug_mode=args.debug_mode, ev_shift=args.ev, **kw)
    cam_pos, cam_dir = args.camera[:3], args.camera[3:]

    r = Renderer(scene, cfg, device=args.device, ibl=args.ibl)
    t_start = time.perf_counter()

    if args.mode == "reference":
        state = init_reference_state(cfg, device=r.device)
        view = make_view_constants(cam_pos, cam_dir, fov_y_deg=args.fov,
                                   width=args.width, height=args.height,
                                   device=r.device)
        out = None
        for i in range(args.spp):
            state, out = render_frame_reference(r.ts, state, view, cfg)
            if args.dump_every and (i + 1) % args.dump_every == 0:
                save_png(_seq_path(args.output, i), _host(out["final"]))
        save_png(args.output, _host(out["final"]))
    elif args.animate:
        out = _run_animated(r, args)
    else:
        watcher = None
        if args.watch:
            from ..core.reload import ModuleWatcher

            watcher = ModuleWatcher()
        out = None
        for i in range(args.frames):
            if watcher is not None and watcher.poll():
                r.rebuild()        # JAX's re-trace; a no-op in the port
            view = make_view_constants(
                cam_pos, cam_dir, fov_y_deg=args.fov,
                width=args.width, height=args.height,
                jitter=jitter_for_frame(i), device=r.device)
            out = r.draw(view)
            if args.dump_every and (i + 1) % args.dump_every == 0:
                save_png(_seq_path(args.output, i), _host(out["final"]))
        save_png(args.output, _host(out["final"]))

    dt = time.perf_counter() - t_start
    n = args.spp if args.mode == "reference" else args.frames
    print(f"wrote {args.output} ({n} frames in {dt:.1f}s, "
          f"{dt / max(n, 1) * 1e3:.0f} ms/frame incl. kernel builds)")


def _host(x):
    return x.detach().cpu().numpy()


def _run_animated(r, args):
    """Dynamic-scene demo: a keyframed orbit fed through the smoothed camera
    rig, a sun that swings across the sky, and the first instance spinning
    through `Renderer.set_transforms` (the trace scene is refreshed before
    each frame)."""
    import torch

    from ..core.camera import make_view_constants
    from ..frame import jitter_for_frame
    from .camera_rig import CameraRig
    from .sequence import Sequence

    n = args.animate
    fps = 30.0
    dur = n / fps
    px, py, pz = args.camera[:3]
    rad = float(np.hypot(px, pz)) or 2.4

    def orbit(a):
        p = np.array([rad * np.sin(a), py, rad * np.cos(a)], np.float32)
        d = -p / max(np.linalg.norm(p), 1e-6)
        return p, d

    seq = Sequence()
    for f, ang in ((0.0, 0.0), (0.45, 0.5), (0.75, -0.3), (1.0, 0.2)):
        p, d = orbit(ang)
        sun = np.array([np.sin(2.2 * f - 0.8), 0.8, np.cos(2.2 * f - 0.8)],
                       np.float32)
        seq.add(f * dur, p, d, sun / np.linalg.norm(sun))

    k0 = seq.sample(0.0)
    rig = CameraRig(position=k0.cam_pos,
                    yaw=float(np.arctan2(-k0.cam_dir[0], -k0.cam_dir[2])),
                    pitch=float(np.arcsin(np.clip(k0.cam_dir[1], -1, 1))))
    base_xf = _host(r.ts.gpu.xforms)
    prev_view = None
    out = None
    t_frame = []
    for i in range(n):
        t0 = time.perf_counter()
        k = seq.sample(i / fps)
        rig.target_pos = np.asarray(k.cam_pos, np.float32)
        rig.target_yaw = float(np.arctan2(-k.cam_dir[0], -k.cam_dir[2]))
        rig.target_pitch = float(np.arcsin(np.clip(k.cam_dir[1], -1, 1)))
        pos, fwd = rig.update(1.0 / fps)

        if k.sun_dir is not None:
            r.ts.gpu.sun_direction = torch.as_tensor(
                k.sun_dir, dtype=torch.float32, device=r.device)
        # spin instance 0 about +y
        a = 2.0 * np.pi * i / max(n, 1) * 0.08
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        xf = base_xf.copy()
        xf[0, :, :3] = rot @ base_xf[0, :, :3]
        r.set_transforms(xf)

        view = make_view_constants(
            pos, fwd, fov_y_deg=args.fov, width=args.width,
            height=args.height, jitter=jitter_for_frame(i), prev=prev_view,
            device=r.device)
        out = r.draw(view)
        prev_view = view
        t_frame.append(time.perf_counter() - t0)
        if args.dump_every and (i + 1) % args.dump_every == 0:
            save_png(_seq_path(args.output, i), _host(out["final"]))
    save_png(args.output, _host(out["final"]))
    steady = t_frame[2:] or t_frame
    print(f"animated {n} frames, steady-state "
          f"{1e3 * sum(steady) / len(steady):.0f} ms/frame")
    return out


def _seq_path(path: str, i: int) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}_{i:04d}{ext}"


if __name__ == "__main__":
    main()
