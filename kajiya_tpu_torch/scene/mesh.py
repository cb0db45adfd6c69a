"""Packed SoA mesh + material tables (port of `kajiya_tpu/scene/mesh.py`).

Host-side dense SoA numpy arrays, flattened into device tensors by
`scene.build_gpu_scene`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    """Material table row (cf. `MeshMaterial` in rust-shaders-shared/src/mesh.rs)."""
    base_color: np.ndarray      # (4,)
    emissive: np.ndarray        # (3,)
    metallic: float
    roughness: float
    base_color_texture: int = -1
    mr_texture: int = -1
    normal_texture: int = -1
    emissive_texture: int = -1


@dataclass
class PackedMesh:
    """One mesh in object space, SoA. Triangle-indexed."""
    positions: np.ndarray       # (V, 3) f32
    normals: np.ndarray         # (V, 3) f32
    uvs: np.ndarray             # (V, 2) f32
    tangents: np.ndarray        # (V, 4) f32
    colors: np.ndarray          # (V, 4) f32
    indices: np.ndarray         # (T, 3) u32
    material_ids: np.ndarray    # (T,) u32, per-triangle
    materials: list             # list[Material]
    image_paths: list = field(default_factory=list)

    @property
    def num_triangles(self):
        return self.indices.shape[0]

    @property
    def num_vertices(self):
        return self.positions.shape[0]


def pack_gltf(gltf_scene) -> PackedMesh:
    """Merge a parsed glTF scene's primitives into one PackedMesh
    (counterpart of `pack_triangle_mesh`, `mesh.rs:824-871`)."""
    pos, nrm, uv, tan, col, idx, mat_ids = [], [], [], [], [], [], []
    voffset = 0
    for prim in gltf_scene.primitives:
        pos.append(prim.positions)
        nrm.append(prim.normals)
        uv.append(prim.uvs)
        tan.append(prim.tangents)
        col.append(prim.colors)
        idx.append(prim.indices + voffset)
        mat_ids.append(np.full(len(prim.indices), prim.material, np.uint32))
        voffset += len(prim.positions)
    materials = [
        Material(
            base_color=np.array(m.base_color[:4], np.float32),
            emissive=np.array(m.emissive, np.float32),
            metallic=float(m.metallic),
            roughness=float(m.roughness),
            base_color_texture=m.base_color_texture,
            mr_texture=m.mr_texture,
            normal_texture=m.normal_texture,
            emissive_texture=m.emissive_texture,
        )
        for m in gltf_scene.materials
    ]
    return PackedMesh(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        uvs=np.concatenate(uv).astype(np.float32),
        tangents=np.concatenate(tan).astype(np.float32),
        colors=np.concatenate(col).astype(np.float32),
        indices=np.concatenate(idx).astype(np.uint32),
        material_ids=np.concatenate(mat_ids).astype(np.uint32),
        materials=materials,
        image_paths=list(gltf_scene.image_paths),
    )


def load_gltf_mesh(path: str) -> PackedMesh:
    from .gltf import load_gltf

    return pack_gltf(load_gltf(path))
