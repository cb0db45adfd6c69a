"""Minimal glTF 2.0 / GLB importer (numpy, no external deps; a copy of
`kajiya_tpu/scene/gltf.py`).

Covers the subset the reference's asset layer consumes
(`kajiya-asset/src/mesh.rs:98-445`, `import_gltf.rs`): scene-graph walk with
node TRS/matrix transforms, triangle primitives with POSITION / NORMAL /
TEXCOORD_0 / TANGENT / COLOR_0 attributes, u8/u16/u32 indices,
pbrMetallicRoughness material factors, emissive factor +
KHR_materials_emissive_strength, and winding flip on negative-determinant
transforms. Texture *images* are resolved to file paths / decoded arrays by
`textures.py`; this module only records the references.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class GltfPrimitive:
    positions: np.ndarray          # (V, 3) f32
    normals: np.ndarray            # (V, 3) f32
    uvs: np.ndarray                # (V, 2) f32
    tangents: np.ndarray           # (V, 4) f32
    colors: np.ndarray             # (V, 4) f32
    indices: np.ndarray            # (T, 3) u32
    material: int


@dataclass
class GltfMaterial:
    name: str = ""
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 1.0
    emissive: tuple = (0.0, 0.0, 0.0)
    base_color_texture: int = -1   # image index, -1 = none
    mr_texture: int = -1
    normal_texture: int = -1
    emissive_texture: int = -1
    double_sided: bool = True


@dataclass
class GltfScene:
    primitives: list = field(default_factory=list)   # list[GltfPrimitive] in WORLD space of the gltf scene
    materials: list = field(default_factory=list)    # list[GltfMaterial]
    image_paths: list = field(default_factory=list)  # resolved file paths or data: blobs


def _load_buffers(doc, base_dir, glb_bin):
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_bin)
        elif uri.startswith("data:"):
            buffers.append(np.frombuffer(base64.b64decode(uri.split(",", 1)[1]), np.uint8))
        else:
            from urllib.parse import unquote
            with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                buffers.append(np.frombuffer(f.read(), np.uint8))
    return buffers


def _read_accessor(doc, buffers, idx):
    acc = doc["accessors"][idx]
    count = acc["count"]
    ncomp = _TYPE_COUNT[acc["type"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    if "bufferView" not in acc:
        out = np.zeros((count, ncomp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            out = np.frombuffer(buf[offset:offset + count * itemsize].tobytes(), dtype).reshape(count, ncomp)
        else:
            rows = [np.frombuffer(buf[offset + i * stride: offset + i * stride + itemsize].tobytes(), dtype) for i in range(count)]
            out = np.stack(rows).reshape(count, ncomp)
    if acc.get("normalized") and dtype != np.float32:
        out = out.astype(np.float32) / np.iinfo(dtype).max
    return out


def _node_matrix(node):
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # gltf is column-major
    m = np.eye(4, dtype=np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m[:3, :3] = _quat_to_mat3(x, y, z, w)
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.array(node["scale"], np.float32)[None, :]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _quat_to_mat3(x, y, z, w):
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def load_gltf(path: str) -> GltfScene:
    """Load a .gltf or .glb file into flattened world-space primitives."""
    base_dir = os.path.dirname(path)
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":
            magic, version, length = struct.unpack("<III", f.read(12))
            doc = None
            while f.tell() < length:
                clen, ctype = struct.unpack("<II", f.read(8))
                data = f.read(clen)
                if ctype == 0x4E4F534A:  # JSON
                    doc = json.loads(data)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = np.frombuffer(data, np.uint8)
        else:
            doc = json.load(f)

    buffers = _load_buffers(doc, base_dir, glb_bin)
    out = GltfScene()

    for mat in doc.get("materials", [{}]):
        pbr = mat.get("pbrMetallicRoughness", {})
        emissive = np.array(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = mat.get("extensions", {}).get("KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
        gm = GltfMaterial(
            name=mat.get("name", ""),
            base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
            metallic=pbr.get("metallicFactor", 0.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emissive=tuple(emissive * strength),
            double_sided=mat.get("doubleSided", True),
        )
        def _tex_image(tex_info):
            if tex_info is None:
                return -1
            tex = doc.get("textures", [])[tex_info["index"]]
            return tex.get("source", -1)
        gm.base_color_texture = _tex_image(pbr.get("baseColorTexture"))
        gm.mr_texture = _tex_image(pbr.get("metallicRoughnessTexture"))
        gm.normal_texture = _tex_image(mat.get("normalTexture"))
        gm.emissive_texture = _tex_image(mat.get("emissiveTexture"))
        out.materials.append(gm)
    if not doc.get("materials"):
        out.materials = [GltfMaterial()]

    for img in doc.get("images", []):
        uri = img.get("uri", "")
        if uri and not uri.startswith("data:"):
            from urllib.parse import unquote
            out.image_paths.append(os.path.join(base_dir, unquote(uri)))
        else:
            out.image_paths.append(uri)

    scene = doc["scenes"][doc.get("scene", 0)]

    def visit(node_idx, parent_xform):
        node = doc["nodes"][node_idx]
        xform = parent_xform @ _node_matrix(node)
        if "mesh" in node:
            _emit_mesh(doc, buffers, doc["meshes"][node["mesh"]], xform, out)
        for child in node.get("children", []):
            visit(child, xform)

    for root in scene["nodes"]:
        visit(root, np.eye(4, dtype=np.float32))
    return out


def generate_tangents(pos: np.ndarray, nrm: np.ndarray, uv: np.ndarray,
                      idx: np.ndarray) -> np.ndarray:
    """Per-vertex (V, 4) tangents (xyz + handedness w) from positions/UVs.

    Role of the reference's mikktspace pass (`kajiya-asset/src/mesh.rs:98-445`):
    per-face tangent/bitangent from the UV parameterization, accumulated per
    vertex, Gram-Schmidt orthonormalized against the vertex normal, with
    w = sign of the (T, B, N) basis (Lengyel's method). Degenerate UVs fall
    back to an arbitrary frame so normal mapping stays well-defined."""
    v = len(pos)
    t_acc = np.zeros((v, 3), np.float64)
    b_acc = np.zeros((v, 3), np.float64)

    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    w0, w1, w2 = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
    e1, e2 = (p1 - p0).astype(np.float64), (p2 - p0).astype(np.float64)
    d1, d2 = (w1 - w0).astype(np.float64), (w2 - w0).astype(np.float64)
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r
    b_face = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r
    for c in range(3):
        np.add.at(t_acc, idx[:, c], t_face)
        np.add.at(b_acc, idx[:, c], b_face)

    n = nrm.astype(np.float64)
    # Gram-Schmidt: t orthogonal to n
    t = t_acc - n * (t_acc * n).sum(-1, keepdims=True)
    t_len = np.linalg.norm(t, axis=-1, keepdims=True)
    # fallback frame for vertices with no valid UV gradient
    alt = np.cross(n, np.where(np.abs(n[:, 1:2]) < 0.9,
                               np.array([0.0, 1.0, 0.0]),
                               np.array([1.0, 0.0, 0.0])))
    alt /= np.maximum(np.linalg.norm(alt, axis=-1, keepdims=True), 1e-12)
    t = np.where(t_len > 1e-8, t / np.maximum(t_len, 1e-12), alt)
    w = np.where((np.cross(n, t) * b_acc).sum(-1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, w[:, None]], -1).astype(np.float32)


def _emit_mesh(doc, buffers, mesh, xform, out: GltfScene):
    flip_winding = np.linalg.det(xform[:3, :3]) < 0.0  # cf. mesh.rs winding flip
    normal_xform = np.linalg.inv(xform[:3, :3]).T
    for prim in mesh["primitives"]:
        if prim.get("mode", 4) != 4:  # triangles only
            continue
        attrs = prim["attributes"]
        pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
        nverts = len(pos)
        pos = pos @ xform[:3, :3].T + xform[:3, 3]

        if "NORMAL" in attrs:
            nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            nrm = nrm @ normal_xform.T
        else:
            nrm = np.zeros((nverts, 3), np.float32)
        nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = np.where(nlen > 1e-8, nrm / np.maximum(nlen, 1e-8), np.array([0, 1, 0], np.float32))

        uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32) if "TEXCOORD_0" in attrs else np.zeros((nverts, 2), np.float32)
        tan = _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32) if "TANGENT" in attrs else None
        col = _read_accessor(doc, buffers, attrs["COLOR_0"]).astype(np.float32) if "COLOR_0" in attrs else np.ones((nverts, 4), np.float32)
        if col.shape[1] == 3:
            col = np.concatenate([col, np.ones((nverts, 1), np.float32)], -1)

        if "indices" in prim:
            idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.uint32)
        else:
            idx = np.arange(nverts, dtype=np.uint32)
        idx = idx.reshape(-1, 3)
        if flip_winding:
            idx = idx[:, ::-1]

        if tan is None:
            # the reference generates mikktspace tangents when the asset has
            # none (kajiya-asset/src/mesh.rs:98-445); we use the standard
            # per-face UV-gradient accumulation (Lengyel), which agrees with
            # mikktspace on welded meshes up to per-vertex orthonormalization
            tan = generate_tangents(pos, nrm, uv, idx)

        out.primitives.append(GltfPrimitive(
            positions=pos, normals=nrm.astype(np.float32), uvs=uv, tangents=tan,
            colors=col, indices=np.ascontiguousarray(idx), material=prim.get("material", 0),
        ))
