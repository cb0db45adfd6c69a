"""Procedural test scenes (port of `kajiya_tpu/scene/procedural.py`).

The cornell box mirrors the classic CornellBox-Original the reference ships as
a glTF (`assets/meshes/cornell_box/`), built from code so the test-suite is
hermetic.
"""
from __future__ import annotations

import numpy as np

from .mesh import Material, PackedMesh
from .scene import Scene


def _quad(a, b, c, d):
    """Two CCW triangles for quad corners a,b,c,d (in order around the quad)."""
    verts = np.array([a, b, c, d], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    n = np.cross(verts[1] - verts[0], verts[3] - verts[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    return verts, normals, idx


def _mesh_from_quads(quads, materials, quad_mats):
    pos, nrm, idx, mids = [], [], [], []
    off = 0
    for (v, n, i), m in zip(quads, quad_mats):
        pos.append(v)
        nrm.append(n)
        idx.append(i + off)
        mids.append(np.full(len(i), m, np.uint32))
        off += len(v)
    pos = np.concatenate(pos)
    nverts = len(pos)
    return PackedMesh(
        positions=pos,
        normals=np.concatenate(nrm),
        uvs=np.zeros((nverts, 2), np.float32),
        tangents=np.tile(np.array([1, 0, 0, 1], np.float32), (nverts, 1)),
        colors=np.ones((nverts, 4), np.float32),
        indices=np.concatenate(idx),
        material_ids=np.concatenate(mids),
        materials=materials,
    )


def _mat(color, emissive=(0, 0, 0), metallic=0.0, roughness=1.0):
    return Material(
        base_color=np.array([*color, 1.0], np.float32),
        emissive=np.array(emissive, np.float32),
        metallic=metallic,
        roughness=roughness,
    )


def cornell_box(light_intensity: float = 20.0, box_metallic: float = 0.0,
                box_roughness: float = 0.6) -> Scene:
    """Classic cornell box, interior normals, y-up, 2x2x2 units centered at origin
    floor at y=-1. Camera should look down -Z from around (0, 0, 3.2)."""
    white = _mat((0.73, 0.73, 0.73))
    red = _mat((0.65, 0.05, 0.05))
    green = _mat((0.12, 0.45, 0.15))
    light = _mat((0.0, 0.0, 0.0), emissive=(light_intensity,) * 3)
    boxmat = _mat((0.73, 0.73, 0.73), metallic=box_metallic, roughness=box_roughness)
    materials = [white, red, green, light, boxmat]

    quads = [
        _quad((-1, -1, 1), (1, -1, 1), (1, -1, -1), (-1, -1, -1)),      # floor (+Y normal)
        _quad((-1, 1, -1), (1, 1, -1), (1, 1, 1), (-1, 1, 1)),          # ceiling (-Y)
        _quad((-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1)),      # back (+Z)
        _quad((-1, -1, 1), (-1, -1, -1), (-1, 1, -1), (-1, 1, 1)),      # left red (+X)
        _quad((1, -1, -1), (1, -1, 1), (1, 1, 1), (1, 1, -1)),          # right green (-X)
        _quad((-0.3, 0.995, -0.3), (0.3, 0.995, -0.3), (0.3, 0.995, 0.3), (-0.3, 0.995, 0.3)),  # light (-Y)
        # short box (axis aligned cube at right-front)
        _quad((0.1, -1 + 0.6, -0.2), (0.7, -1 + 0.6, -0.2), (0.7, -1 + 0.6, 0.4), (0.1, -1 + 0.6, 0.4)),   # top
        _quad((0.1, -1, 0.4), (0.7, -1, 0.4), (0.7, -0.4, 0.4), (0.1, -0.4, 0.4)),                          # front
        _quad((0.7, -1, -0.2), (0.1, -1, -0.2), (0.1, -0.4, -0.2), (0.7, -0.4, -0.2)),                      # back
        _quad((0.1, -1, -0.2), (0.1, -1, 0.4), (0.1, -0.4, 0.4), (0.1, -0.4, -0.2)),                        # left
        _quad((0.7, -1, 0.4), (0.7, -1, -0.2), (0.7, -0.4, -0.2), (0.7, -0.4, 0.4)),                        # right
        # tall box (left-back)
        _quad((-0.7, 0.2, -0.6), (-0.1, 0.2, -0.6), (-0.1, 0.2, 0.0), (-0.7, 0.2, 0.0)),
        _quad((-0.7, -1, 0.0), (-0.1, -1, 0.0), (-0.1, 0.2, 0.0), (-0.7, 0.2, 0.0)),
        _quad((-0.1, -1, -0.6), (-0.7, -1, -0.6), (-0.7, 0.2, -0.6), (-0.1, 0.2, -0.6)),
        _quad((-0.7, -1, -0.6), (-0.7, -1, 0.0), (-0.7, 0.2, 0.0), (-0.7, 0.2, -0.6)),
        _quad((-0.1, -1, 0.0), (-0.1, -1, -0.6), (-0.1, 0.2, -0.6), (-0.1, 0.2, 0.0)),
    ]
    quad_mats = [0, 0, 0, 1, 2, 3] + [4] * 5 + [4] * 5
    mesh = _mesh_from_quads(quads, materials, quad_mats)
    scene = Scene(sun_intensity=0.0)
    mid = scene.add_mesh(mesh)
    scene.add_instance(mid)
    return scene


def checker_data_uri(size: int = 32, cells: int = 4,
                     c0=(255, 140, 30), c1=(30, 90, 255)) -> str:
    """A saturated checkerboard PNG as a data URI (hermetic texture source),
    written by the port's encoder."""
    import base64

    from .png import encode_png

    y, x = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((x // cell + y // cell) % 2).astype(bool)
    img = np.empty((size, size, 3), np.uint8)
    img[mask] = np.array(c0, np.uint8)
    img[~mask] = np.array(c1, np.uint8)
    return ("data:image/png;base64,"
            + base64.b64encode(encode_png(img)).decode())


def textured_cornell_box(light_intensity: float = 20.0) -> Scene:
    """Cornell box with a saturated checker albedo texture on the floor
    (its own material, UVs on the floor quad): textured shading on the
    primary hit and on secondary GI bounces, whose bounce light off the
    floor carries the checker's colour."""
    scene = cornell_box(light_intensity=light_intensity)
    mesh = scene.meshes[0]
    # floor quad is first: vertices 0..3 / triangles 0..1 get a dedicated
    # textured material so the other white surfaces stay untextured
    uv = np.zeros_like(mesh.uvs)
    uv[0:4] = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    mesh.uvs = uv
    mesh.image_paths = [checker_data_uri()]
    floor_mat = _mat((1.0, 1.0, 1.0))
    floor_mat.base_color_texture = 0
    mesh.materials.append(floor_mat)
    mids = mesh.material_ids.copy()
    mids[0:2] = len(mesh.materials) - 1
    mesh.material_ids = mids
    return scene


def single_triangle(emissive=(0, 0, 0), color=(0.8, 0.8, 0.8)) -> Scene:
    mesh = PackedMesh(
        positions=np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        normals=np.tile(np.array([0, 0, 1], np.float32), (3, 1)),
        uvs=np.array([[0, 0], [1, 0], [0.5, 1]], np.float32),
        tangents=np.tile(np.array([1, 0, 0, 1], np.float32), (3, 1)),
        colors=np.ones((3, 4), np.float32),
        indices=np.array([[0, 1, 2]], np.uint32),
        material_ids=np.zeros(1, np.uint32),
        materials=[_mat(color, emissive=emissive)],
    )
    scene = Scene()
    scene.add_instance(scene.add_mesh(mesh))
    return scene


def _subdiv_box(s: int):
    """Unit box [0,1]^3, each face an s x s quad grid -> (verts, normals,
    indices). 6*s*s*2 triangles; verts duplicated per face (hard normals)."""
    u = np.linspace(0.0, 1.0, s + 1, dtype=np.float32)
    gu, gv = np.meshgrid(u, u, indexing="ij")
    gu, gv = gu.ravel(), gv.ravel()
    nv = (s + 1) * (s + 1)
    # face-local quad indices
    i0 = (np.arange(s)[:, None] * (s + 1) + np.arange(s)[None, :]).ravel()
    quad = np.stack([i0, i0 + (s + 1), i0 + (s + 1) + 1,
                     i0, i0 + (s + 1) + 1, i0 + 1], axis=1)
    tri = quad.reshape(-1, 3)
    pos, nrm, idx = [], [], []
    for axis in range(3):
        a1, a2 = (axis + 1) % 3, (axis + 2) % 3
        for sign in (0.0, 1.0):
            v = np.empty((nv, 3), np.float32)
            v[:, axis] = sign
            v[:, a1] = gu
            v[:, a2] = gv
            n = np.zeros((nv, 3), np.float32)
            n[:, axis] = 2.0 * sign - 1.0
            idx.append(tri + len(pos) * nv)
            pos.append(v)
            nrm.append(n)
    return (np.concatenate(pos), np.concatenate(nrm),
            np.concatenate(idx).astype(np.uint32))


def city(n: int = 16, subdiv: int = 8, seed: int = 7,
         block: float = 3.0) -> Scene:
    """Battle-scale stand-in: an n x n grid of subdivided-box buildings on a
    ground slab. ONE building mesh, n*n instances with per-instance
    scale/position (true instancing); triangle count = n*n * 6*subdiv^2*2
    (+2 ground). n=16/subdiv=8 ~ 197k tris; n=40 ~ 1.23M tris — the scale
    of the reference's `battle.ron` (whose mesh .bins are absent from this
    mount). Dense mutual occlusion, so front-to-back culling behaves like a
    real interior/city, unlike `random_tri_soup`."""
    rng = np.random.default_rng(seed)
    v, nrm, idx = _subdiv_box(subdiv)
    nverts = len(v)
    mats = [_mat((0.65, 0.62, 0.58), roughness=0.9),
            _mat((0.45, 0.5, 0.55), roughness=0.4, metallic=0.6),
            _mat((0.6, 0.35, 0.3), roughness=0.8)]
    ntri = len(idx)
    mesh = PackedMesh(
        positions=v, normals=nrm,
        uvs=np.zeros((nverts, 2), np.float32),
        tangents=np.tile(np.array([1, 0, 0, 1], np.float32), (nverts, 1)),
        colors=np.ones((nverts, 4), np.float32),
        indices=idx, material_ids=np.zeros(ntri, np.uint32),
        materials=[mats[0]])
    # material variety: three clones of the mesh differing only in material
    meshes = []
    scene = Scene(sun_intensity=12.0)
    for m in mats:
        mm = PackedMesh(**{**mesh.__dict__, "materials": [m]})
        meshes.append(scene.add_mesh(mm))
    ext = n * block * 0.5
    ground = PackedMesh(
        positions=np.array([[-ext, 0, -ext], [ext, 0, -ext],
                            [ext, 0, ext], [-ext, 0, ext]], np.float32),
        normals=np.tile(np.array([0, 1, 0], np.float32), (4, 1)),
        uvs=np.zeros((4, 2), np.float32),
        tangents=np.tile(np.array([1, 0, 0, 1], np.float32), (4, 1)),
        colors=np.ones((4, 4), np.float32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.uint32),
        material_ids=np.zeros(2, np.uint32),
        materials=[_mat((0.35, 0.35, 0.35), roughness=0.95)])
    scene.add_instance(scene.add_mesh(ground))
    for gz in range(n):
        for gx in range(n):
            w = block * rng.uniform(0.35, 0.75)
            h = block * rng.uniform(0.6, 4.0)
            x = (gx + 0.5) * block - ext
            z = (gz + 0.5) * block - ext
            scene.add_instance(meshes[int(rng.integers(3))],
                               position=(x - w / 2, 0.0, z - w / 2),
                               scale=(w, h, w))
    return scene


def random_tri_soup(n_tris: int, seed: int = 0, extent: float = 10.0, tri_size: float = 0.5) -> Scene:
    """Random triangle soup for BVH stress-tests."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n_tris, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-tri_size, tri_size, (n_tris, 3, 3)).astype(np.float32)
    verts = (centers + offsets).reshape(-1, 3)
    n = np.cross(verts[1::3] - verts[0::3], verts[2::3] - verts[0::3])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    mesh = PackedMesh(
        positions=verts,
        normals=np.repeat(n, 3, axis=0).astype(np.float32),
        uvs=np.zeros((len(verts), 2), np.float32),
        tangents=np.tile(np.array([1, 0, 0, 1], np.float32), (len(verts), 1)),
        colors=np.ones((len(verts), 4), np.float32),
        indices=np.arange(len(verts), dtype=np.uint32).reshape(-1, 3),
        material_ids=np.zeros(n_tris, np.uint32),
        materials=[_mat((0.7, 0.7, 0.7))],
    )
    scene = Scene()
    scene.add_instance(scene.add_mesh(mesh))
    return scene
