"""Content-addressed bake cache for packed meshes (port of
`kajiya_tpu/scene/cache.py`: the same .npz layout, key, CACHE_VERSION and
KAJIYA_TPU_CACHE directory, so a file either package bakes loads in the
other).

Role of the reference's flat-binary asset cache (`kajiya-asset/src/mesh.rs`
`def_asset!` Flat twins + `cache/{hash:8.8x}.mesh` files, loaded by mmap,
`mmap.rs:10-23`): baked meshes are stored as .npz of the packed SoA arrays,
keyed by a content hash of the source path + mtime, so repeat loads skip the
glTF parse entirely (numpy mmap_mode gives the same zero-copy behavior the
reference gets from mmap + transmute).
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from .mesh import Material, PackedMesh

CACHE_DIR = os.environ.get("KAJIYA_TPU_CACHE", "cache")

# bump when the baked layout/semantics change (v2: generated tangents)
CACHE_VERSION = 2


def _key(path: str) -> str:
    st = os.stat(path)
    h = hashlib.sha256(
        f"{os.path.abspath(path)}:{st.st_mtime_ns}:{st.st_size}"
        f":v{CACHE_VERSION}".encode()).hexdigest()[:16]
    return h


def cache_path(path: str) -> str:
    return os.path.join(CACHE_DIR, f"{_key(path)}.mesh.npz")


def save_packed(mesh: PackedMesh, out: str):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    mat = np.stack([np.concatenate([
        m.base_color, m.emissive,
        np.asarray([m.metallic, m.roughness], np.float32)])
        for m in mesh.materials])
    mat_tex = np.asarray([[m.base_color_texture, m.mr_texture,
                           m.normal_texture, m.emissive_texture]
                          for m in mesh.materials], np.int32)
    np.savez(out, positions=mesh.positions, normals=mesh.normals,
             uvs=mesh.uvs, tangents=mesh.tangents, colors=mesh.colors,
             indices=mesh.indices,
             material_ids=mesh.material_ids, materials=mat,
             mat_tex=mat_tex,
             # fixed-dtype unicode, NOT object: keeps the cache loadable
             # with allow_pickle=False (tampered caches can't execute code)
             image_paths=np.asarray(list(mesh.image_paths), dtype=np.str_))


def load_packed(path: str) -> PackedMesh:
    z = np.load(path, allow_pickle=False)
    tex = (z["mat_tex"] if "mat_tex" in z.files
           else np.full((len(z["materials"]), 4), -1, np.int32))
    mats = [Material(base_color=row[0:4], emissive=row[4:7],
                     metallic=float(row[7]), roughness=float(row[8]),
                     base_color_texture=int(t[0]), mr_texture=int(t[1]),
                     normal_texture=int(t[2]), emissive_texture=int(t[3]))
            for row, t in zip(z["materials"], tex)]
    paths = (list(z["image_paths"]) if "image_paths" in z.files else [])
    return PackedMesh(positions=z["positions"], normals=z["normals"],
                      uvs=z["uvs"], tangents=z["tangents"],
                      colors=z["colors"], indices=z["indices"],
                      material_ids=z["material_ids"], materials=mats,
                      image_paths=paths)


def load_mesh_cached(path: str) -> PackedMesh:
    """glTF -> PackedMesh through the bake cache (`view` bakes on demand,
    `runtime.rs:603-646`)."""
    from .mesh import load_gltf_mesh

    cp = cache_path(path)
    if os.path.exists(cp):
        return load_packed(cp)
    mesh = load_gltf_mesh(path)
    try:
        save_packed(mesh, cp)
    except OSError:
        pass
    return mesh
