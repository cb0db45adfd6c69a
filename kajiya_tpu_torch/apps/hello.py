"""Minimal embedding example (port of `kajiya_tpu/apps/hello.py`, parity
with `crates/bin/hello/src/main.rs`): build a scene, run the frame loop on
the card, write a PNG.

    python -m kajiya_tpu_torch.apps.hello              # writes out/hello.png
    python -m kajiya_tpu_torch.apps.hello --device cpu
"""
from __future__ import annotations

import argparse

WIDTH, HEIGHT, FRAMES = 640, 360, 8


def main(argv=None):
    from ..core.camera import make_view_constants
    from ..frame import RenderConfig, Renderer, jitter_for_frame
    from ..scene.procedural import cornell_box
    from .view import save_png

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    scene = cornell_box()                       # ~ add_baked_mesh + instance
    r = Renderer(scene, RenderConfig(width=WIDTH, height=HEIGHT),
                 device=args.device)

    out = None
    for i in range(FRAMES):                     # ~ main_loop.run(|ctx| ...)
        view = make_view_constants(
            (0.0, 0.0, 2.4), (0.0, 0.0, -1.0), fov_y_deg=55.0,
            width=WIDTH, height=HEIGHT, jitter=jitter_for_frame(i),
            device=r.device)
        out = r.draw(view)

    save_png("out/hello.png", out["final"].detach().cpu().numpy())
    print("wrote out/hello.png")


if __name__ == "__main__":
    main()
