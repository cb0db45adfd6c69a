"""Packed SoA mesh + material tables (port of `kajiya_tpu/scene/mesh.py`;
the glTF packer waits for the loaders).

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
