"""Bake CLI: pre-process glTF scenes into the content-addressed cache (a
copy of `kajiya_tpu/apps/bake.py` over the port's cache, whose files the
JAX package loads too).

Role of `crates/bin/bake` (`bake/src/main.rs:8-28`: `bake --scene X -o name`)
driving `kajiya-asset-pipe::process_mesh_asset`. Here baking = glTF parse +
packing to SoA arrays + .npz cache write (scene/cache.py).

Usage:
  python -m kajiya_tpu_torch.apps.bake --scene assets/meshes/x/scene.gltf
  python -m kajiya_tpu_torch.apps.bake --scene scenes/battle.ron   # bakes all meshes
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", required=True, help=".gltf/.glb mesh or .ron scene")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("-o", "--output-name", default=None,
                   help="optional explicit cache file name")
    args = p.parse_args(argv)

    from ..scene.cache import cache_path, load_mesh_cached, save_packed

    t0 = time.perf_counter()
    targets = []
    if args.scene.endswith(".ron"):
        import os

        from ..scene import ron

        doc = ron.load(args.scene)
        root = os.path.dirname(os.path.dirname(os.path.abspath(args.scene)))
        targets = sorted({os.path.join(root, i["mesh"].lstrip("/"))
                          for i in doc.get("instances", [])})
    else:
        targets = [args.scene]

    for t in targets:
        mesh = load_mesh_cached(t)
        out = args.output_name or cache_path(t)
        if args.output_name:
            save_packed(mesh, out)
        print(f"baked {t}: {mesh.num_triangles} tris, "
              f"{len(mesh.materials)} materials -> {out}")
    print(f"done in {time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
