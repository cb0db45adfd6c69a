"""Scene = meshes + instances + sun/sky, and its flattened device tables
(port of `kajiya_tpu/scene/scene.py`).

True instancing as in the JAX package: vertex tables are stored once per
unique mesh in object space; only the per-triangle index tables replicate
per instance. World-space corners are recomputed from the per-instance
transforms (`GpuScene.triangle_corners`).

Textured materials get texture pages (`textures.py`): image sources are
deduplicated across meshes into one atlas, slot 0 white. `load_ron_scene`
reads a kajiya `.ron` scene of glTF meshes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..device import resolve_device
from .mesh import PackedMesh, load_gltf_mesh


@dataclass
class Instance:
    mesh_id: int
    position: np.ndarray
    rotation: np.ndarray  # 3x3
    scale: np.ndarray     # (3,)

    def transform(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.rotation * self.scale[None, :]
        m[:3, 3] = self.position
        return m


@dataclass
class Scene:
    meshes: list = field(default_factory=list)      # list[PackedMesh]
    instances: list = field(default_factory=list)   # list[Instance]
    sun_direction: np.ndarray = field(default_factory=lambda: np.array([0.35, 0.8, 0.5], np.float32))
    sun_color: np.ndarray = field(default_factory=lambda: np.array([1.0, 1.0, 1.0], np.float32))
    sun_intensity: float = 20.0
    sun_angular_radius: float = 0.0093
    emissive_multiplier: float = 1.0

    def add_mesh(self, mesh: PackedMesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_instance(self, mesh_id: int, position=(0, 0, 0), rotation=None,
                     scale=(1, 1, 1)) -> int:
        rot = (np.eye(3, dtype=np.float32) if rotation is None
               else np.asarray(rotation, np.float32))
        self.instances.append(Instance(
            mesh_id=mesh_id, position=np.asarray(position, np.float32),
            rotation=rot, scale=np.asarray(scale, np.float32)))
        return len(self.instances) - 1


@dataclass
class GpuScene:
    """All per-scene device tensors. Geometry is object-space; transforms
    are per instance and may change every frame."""

    verts_obj: torch.Tensor       # (V, 3) f32
    normals_obj: torch.Tensor     # (V, 3) f32
    tangents_obj: torch.Tensor    # (V, 4) f32
    uvs: torch.Tensor             # (V, 2) f32
    tri_idx: torch.Tensor         # (T, 3) int32
    tri_mat: torch.Tensor         # (T,) int32
    tri_inst: torch.Tensor        # (T,) int32
    xforms: torch.Tensor          # (I, 3, 4) f32 current object->world
    xforms_prev: torch.Tensor     # (I, 3, 4) f32 previous frame
    mat_base_color: torch.Tensor  # (M, 4) f32
    mat_emissive: torch.Tensor    # (M, 3) f32
    mat_metallic: torch.Tensor    # (M,) f32
    mat_roughness: torch.Tensor   # (M,) f32
    light_tri: torch.Tensor       # (L,) int32, padded with -1
    num_lights: torch.Tensor      # () int32
    sun_direction: torch.Tensor   # (3,) f32, unit, towards the sun
    sun_radiance: torch.Tensor    # (3,) f32
    sun_angular_radius: torch.Tensor  # () f32
    tex_pages: torch.Tensor | None = None  # (N, s, s + s//2, 4) uint8 atlas
    mat_tex: torch.Tensor | None = None    # (M, 4) int32 slots [base, mr,
    #                                        normal, emissive]
    page_sub: torch.Tensor | None = None   # (P, 4) int32 [page, size, ox, oy]

    @property
    def num_triangles(self):
        return self.tri_idx.shape[0]

    @property
    def device(self):
        return self.verts_obj.device

    def to(self, device):
        def move(x):
            return None if x is None else x.to(device)

        return GpuScene(**{f.name: move(getattr(self, f.name))
                           for f in fields(self)})

    def triangle_corners(self, xforms=None):
        """(v0, e1, e2): (T, 3) world-space corners under the given
        transforms (default current)."""
        xf = (self.xforms if xforms is None else xforms)[self.tri_inst.long()]
        rot, trans = xf[:, :, :3], xf[:, :, 3]
        idx = self.tri_idx.long()

        def tf(p):
            return (rot[:, :, 0] * p[:, None, 0] + rot[:, :, 1] * p[:, None, 1]
                    + rot[:, :, 2] * p[:, None, 2] + trans)

        v0 = tf(self.verts_obj[idx[:, 0]])
        v1 = tf(self.verts_obj[idx[:, 1]])
        v2 = tf(self.verts_obj[idx[:, 2]])
        return v0, v1 - v0, v2 - v0

    def instance_rotations(self):
        """(I, 3, 3) column-normalized rotation part of each transform."""
        r = self.xforms[:, :, :3]
        n = torch.clamp(torch.sqrt((r * r).sum(dim=1, keepdim=True)),
                        min=1e-12)
        return r / n


def build_gpu_scene(scene: Scene, max_lights: int = 4096,
                    with_textures: bool = True, device=None) -> GpuScene:
    """Flatten a host Scene into device tables on `device` (default CUDA;
    raises without it). Texture pages are baked on the host and uploaded
    once (`with_textures=False` leaves every material untextured)."""
    dev = resolve_device(device)
    tri_idx, tri_mat, tri_inst = [], [], []
    materials, mesh_mat_offset, mesh_voff = [], [], []
    voff = 0
    # global texture slot table: image sources deduplicated across meshes
    img_src, img_slot, mat_tex_rows = [], {}, []
    for mesh in scene.meshes:
        mesh_mat_offset.append(len(materials))
        mesh_voff.append(voff)
        voff += mesh.num_vertices
        materials.extend(mesh.materials)
        paths = getattr(mesh, "image_paths", [])
        for m in mesh.materials:
            row = []
            for ti in (m.base_color_texture, m.mr_texture,
                       m.normal_texture, m.emissive_texture):
                if with_textures and 0 <= ti < len(paths):
                    src = paths[ti]
                    if src not in img_slot:
                        img_slot[src] = len(img_src) + 1  # 0 = white page
                        img_src.append(src)
                    row.append(img_slot[src])
                else:
                    row.append(0)
            mat_tex_rows.append(row)

    verts = np.concatenate([m.positions for m in scene.meshes])
    normals = np.concatenate([m.normals for m in scene.meshes])
    tangents = np.concatenate([m.tangents for m in scene.meshes])
    uvs = np.concatenate([m.uvs for m in scene.meshes])

    for inst_id, inst in enumerate(scene.instances):
        mesh = scene.meshes[inst.mesh_id]
        tri_idx.append(mesh.indices.astype(np.int64) + mesh_voff[inst.mesh_id])
        tri_mat.append(mesh.material_ids.astype(np.int64)
                       + mesh_mat_offset[inst.mesh_id])
        tri_inst.append(np.full(mesh.num_triangles, inst_id, np.int32))
    tri_idx = np.concatenate(tri_idx).astype(np.int32)
    tri_mat = np.concatenate(tri_mat).astype(np.int32)

    xf = np.stack([inst.transform()[:3, :] for inst in scene.instances]
                  ).astype(np.float32)
    mat_base = np.stack([m.base_color for m in materials]).astype(np.float32)
    mat_emis = (np.stack([m.emissive for m in materials]).astype(np.float32)
                * scene.emissive_multiplier)
    mat_metal = np.array([m.metallic for m in materials], np.float32)
    mat_rough = np.array([m.roughness for m in materials], np.float32)

    # emissive triangle lights, padded to the actual count rounded up to 8
    is_emissive = (mat_emis[tri_mat] > 0).any(axis=-1)
    light_ids = np.nonzero(is_emissive)[0].astype(np.int32)
    n_lights = min(len(light_ids), max_lights)
    light_tri = np.full(max(8, -(-n_lights // 8) * 8), -1, np.int32)
    light_tri[:n_lights] = light_ids[:n_lights]
    sun_dir = scene.sun_direction / np.linalg.norm(scene.sun_direction)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    tex = {}
    if with_textures and img_src:
        from .textures import build_texture_pages

        tex["tex_pages"], tex["page_sub"] = build_texture_pages(img_src,
                                                                device=dev)
        tex["mat_tex"] = t(np.asarray(mat_tex_rows, np.int32), torch.int32)
    return GpuScene(
        verts_obj=t(verts), normals_obj=t(normals), tangents_obj=t(tangents),
        uvs=t(uvs), tri_idx=t(tri_idx, torch.int32),
        tri_mat=t(tri_mat, torch.int32),
        tri_inst=t(np.concatenate(tri_inst), torch.int32),
        xforms=t(xf), xforms_prev=t(xf.copy()),
        mat_base_color=t(mat_base), mat_emissive=t(mat_emis),
        mat_metallic=t(mat_metal), mat_roughness=t(mat_rough),
        light_tri=t(light_tri, torch.int32),
        num_lights=t(n_lights, torch.int32),
        sun_direction=t(np.asarray(sun_dir, np.float32)),
        sun_radiance=t(np.asarray(scene.sun_color * scene.sun_intensity,
                                  np.float32)),
        sun_angular_radius=t(scene.sun_angular_radius), **tex)


# ----------------------------------------------------------------------------
# RON scene loading (the `view` app's scenes)
# ----------------------------------------------------------------------------

def load_ron_scene(path: str, asset_root: str | None = None) -> Scene:
    """Load a kajiya RON scene. Mesh paths like "/meshes/x/scene.gltf"
    resolve against `asset_root` (default: two levels up from the .ron, the
    assets/ directory)."""
    from . import ron

    doc = ron.load(path)
    if asset_root is None:
        asset_root = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    scene = Scene()
    mesh_cache = {}
    for inst in doc.get("instances", []):
        full = os.path.join(asset_root, inst["mesh"].lstrip("/"))
        if full not in mesh_cache:
            mesh_cache[full] = scene.add_mesh(load_gltf_mesh(full))
        rot = np.eye(3, dtype=np.float32)
        if "rotation" in inst:
            from .gltf import _quat_to_mat3

            q = inst["rotation"]
            rot = _quat_to_mat3(q[0], q[1], q[2], q[3])
        scene.add_instance(
            mesh_cache[full],
            position=np.asarray(inst.get("position", (0, 0, 0)), np.float32),
            rotation=rot,
            scale=np.asarray(inst.get("scale", (1, 1, 1)), np.float32))
    return scene
