"""The port's asset loaders against the JAX package's: `ron.loads`, glTF /
GLB import (`load_gltf`: node transforms, winding flip, accessors, data
URIs, materials, generated tangents), `pack_gltf`, `load_ron_scene`, the
bake cache (a file either package bakes loads in the other), the bake CLI
and the viewer's `build_scene`. Tolerance: exact (the same numpy code on
the same bytes)."""
import base64
import json
import os
import struct

import numpy as np
import pytest

from kajiya_tpu.apps import view as view_j
from kajiya_tpu.scene import cache as cache_j
from kajiya_tpu.scene import gltf as gltf_j
from kajiya_tpu.scene import mesh as mesh_j
from kajiya_tpu.scene import ron as ron_j
from kajiya_tpu.scene import scene as scene_j
from kajiya_tpu_torch.apps import bake as bake_t
from kajiya_tpu_torch.apps import view as view_t
from kajiya_tpu_torch.scene import assets
from kajiya_tpu_torch.scene import cache as cache_t
from kajiya_tpu_torch.scene import gltf as gltf_t
from kajiya_tpu_torch.scene import mesh as mesh_t
from kajiya_tpu_torch.scene import ron as ron_t
from kajiya_tpu_torch.scene import scene as scene_t
from kajiya_tpu_torch.scene.png import encode_png

RON_TEXT = """
// a kajiya scene, with the forms the reader accepts
(
    instances: [
        (mesh: "/meshes/rich.gltf", position: (1.5, -2, 3e-1),
         rotation: (0.0, 0.3826834, 0.0, 0.9238795), scale: (2, 2, 2)),
        (mesh: "/meshes/ground.glb"),  // defaults
        (mesh: "/meshes/rich.gltf", position: (-4.25, 0.0, 1E2)),
    ],
    sun: Some((direction: (0.3, 0.9, -0.1), strength: 12.5)),
    flags: [true, false],
    name: "demo \\"city\\"",
    mode: Standard,
)
"""


def _png_uri(img):
    return "data:image/png;base64," + base64.b64encode(
        encode_png(img)).decode()


def _write_rich_gltf(path, rng):
    """A glTF exercising the importer: a node tree with TRS and matrix
    transforms (one mirrored, so its winding flips), u16 and u8 indices, an
    interleaved (strided) accessor, TANGENT and a 3-component COLOR_0 on
    one primitive, normalized u8 UVs and no NORMAL on another, a line
    primitive (skipped), two materials with all four texture slots and the
    emissive-strength extension, an image as a file, a data URI and a
    bufferView (which the JAX loader records as "" and the bake turns
    white), and the buffer as a data URI."""
    blob = bytearray()
    views, accs = [], []

    def add(arr, typ, comp, normalized=False, stride=None):
        arr = np.ascontiguousarray(arr)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        if stride:
            views[-1]["byteStride"] = stride
        blob.extend(arr.tobytes())
        blob.extend(b"\0" * (-len(blob) % 4))
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]) if not stride else
               int(arr.nbytes // stride), "type": typ}
        if normalized:
            acc["normalized"] = True
        accs.append(acc)
        return len(accs) - 1

    nv = 12
    pos = rng.normal(size=(nv, 3)).astype(np.float32)
    nrm = rng.normal(size=(nv, 3)).astype(np.float32)
    uv = rng.uniform(0, 2, (nv, 2)).astype(np.float32)
    tan = np.concatenate([rng.normal(size=(nv, 3)),
                          np.sign(rng.normal(size=(nv, 1)))], -1)
    col = rng.uniform(0, 1, (nv, 3)).astype(np.float32)
    a_pos = add(pos, "VEC3", 5126)
    a_nrm = add(nrm, "VEC3", 5126)
    # interleaved: uv (8 bytes) + 8 bytes of padding per vertex
    inter = np.zeros((nv, 4), np.float32)
    inter[:, :2] = uv
    a_uv = add(inter, "VEC2", 5126, stride=16)
    a_tan = add(tan.astype(np.float32), "VEC4", 5126)
    a_col = add(col, "VEC3", 5126)
    a_i16 = add(rng.integers(0, nv, 18).astype(np.uint16), "SCALAR", 5123)
    a_i8 = add(rng.integers(0, nv, 12).astype(np.uint8), "SCALAR", 5121)
    a_uv8 = add(rng.integers(0, 256, (nv, 2)).astype(np.uint8), "VEC2", 5121,
                normalized=True)
    img_bytes = encode_png(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    views.append({"buffer": 0, "byteOffset": len(blob),
                  "byteLength": len(img_bytes)})
    blob.extend(img_bytes)
    img_dir = os.path.dirname(path)
    with open(os.path.join(img_dir, "rich base.png"), "wb") as f:
        f.write(encode_png(rng.integers(0, 256, (40, 24, 4),
                                        dtype=np.uint8)))
    c, s = np.cos(0.4), np.sin(0.4)
    mirror = np.diag([-1.0, 1.0, 1.0, 1.0])
    mirror[:3, 3] = (0.5, 1.0, -2.0)
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 3]}],
        "nodes": [
            {"translation": [1, 2, 3], "rotation": [0, s, 0, c],
             "scale": [1, 2, 0.5], "children": [1, 2]},
            {"mesh": 0},
            {"matrix": mirror.T.reshape(-1).tolist(), "mesh": 1},
            {"mesh": 1, "translation": [0, -1, 0]},
        ],
        "meshes": [
            {"primitives": [
                {"attributes": {"POSITION": a_pos, "NORMAL": a_nrm,
                                "TEXCOORD_0": a_uv, "TANGENT": a_tan,
                                "COLOR_0": a_col},
                 "indices": a_i16, "material": 0},
                {"attributes": {"POSITION": a_pos}, "indices": a_i8,
                 "mode": 1}]},
            {"primitives": [
                {"attributes": {"POSITION": a_pos,
                                "TEXCOORD_0": a_uv8},
                 "indices": a_i8, "material": 1}]},
        ],
        "materials": [
            {"name": "a", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.5, 0.25, 1.0],
                "metallicFactor": 0.25, "roughnessFactor": 0.6,
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 2},
             "emissiveTexture": {"index": 1},
             "emissiveFactor": [1.0, 0.5, 0.0],
             "extensions": {"KHR_materials_emissive_strength": {
                 "emissiveStrength": 3.0}}},
            {"name": "b", "doubleSided": False},
        ],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": [{"uri": "rich%20base.png"},
                   {"uri": _png_uri(rng.integers(0, 256, (8, 8, 3),
                                                 dtype=np.uint8))},
                   {"bufferView": len(views) - 1, "mimeType": "image/png"}],
        "accessors": accs, "bufferViews": views,
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(bytes(blob)).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.fixture(scope="module")
def asset_root(tmp_path_factory):
    """assets/meshes/{rich.gltf, b*.gltf + .bin, ground.glb} and
    assets/scenes/{demo.ron, city.ron}, maps at 64^2 (ground 32x64)."""
    root = str(tmp_path_factory.mktemp("assets"))
    rng = np.random.default_rng(5)
    assets.write_city_assets(root, map_size=64, emissive_size=32,
                             ground_size=(32, 64))
    _write_rich_gltf(os.path.join(root, "meshes", "rich.gltf"), rng)
    assets.write_city_ron(root, n=2)
    with open(os.path.join(root, "scenes", "demo.ron"), "w") as f:
        f.write(RON_TEXT)
    return root


def _eq(a, b, what):
    # the packages' dataclasses are twins of the same name
    assert type(a).__name__ == type(b).__name__, what
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            _eq(getattr(a, k), getattr(b, k), f"{what}.{k}")
    else:
        assert a == b, (what, a, b)


def test_ron_loads_matches_jax(asset_root):
    doc_t, doc_j = ron_t.loads(RON_TEXT), ron_j.loads(RON_TEXT)
    assert doc_t == doc_j
    assert doc_t["instances"][0]["position"] == (1.5, -2, 0.3)
    assert doc_t["mode"] == "Standard" and doc_t["flags"] == [True, False]
    city = os.path.join(asset_root, "scenes", "city.ron")
    assert ron_t.load(city) == ron_j.load(city)
    with pytest.raises(ValueError):
        ron_t.loads("(a: #)")


@pytest.mark.parametrize("name", ["rich.gltf", "b0.gltf", "b1.gltf",
                                  "ground.glb"])
def test_load_gltf_matches_jax(asset_root, name):
    path = os.path.join(asset_root, "meshes", name)
    gt, gj = gltf_t.load_gltf(path), gltf_j.load_gltf(path)
    _eq(gt.primitives, gj.primitives, "primitives")
    _eq(gt.materials, gj.materials, "materials")
    assert gt.image_paths == gj.image_paths
    _eq(mesh_t.pack_gltf(gt), mesh_j.pack_gltf(gj), "packed")
    _eq(mesh_t.load_gltf_mesh(path), mesh_j.load_gltf_mesh(path), "mesh")
    if name == "rich.gltf":
        assert len(gt.primitives) == 3          # the line primitive skipped
        assert gt.image_paths[0].endswith("rich base.png")
        assert gt.image_paths[1].startswith("data:image/png")
        assert gt.image_paths[2] == ""          # a bufferView image
        assert gt.materials[0].emissive == pytest.approx((3.0, 1.5, 0.0))
    else:
        # no TANGENT attribute: tangents are generated, unit and orthogonal
        tan = gt.primitives[0].tangents
        np.testing.assert_allclose(np.linalg.norm(tan[:, :3], axis=-1), 1.0,
                                   atol=1e-5)


def test_load_ron_scene_matches_jax(asset_root):
    for name in ("demo.ron", "city.ron"):
        path = os.path.join(asset_root, "scenes", name)
        st, sj = scene_t.load_ron_scene(path), scene_j.load_ron_scene(path)
        _eq(st.meshes, sj.meshes, "meshes")
        assert len(st.instances) == len(sj.instances)
        for it, ij in zip(st.instances, sj.instances):
            assert it.mesh_id == ij.mesh_id
            np.testing.assert_array_equal(it.transform(), ij.transform())


def test_city_ron_places_the_procedural_city(asset_root):
    """The written .ron instances its buildings where procedural.city(n=2)
    puts them (same draws), the ground scaled to the grid."""
    from kajiya_tpu_torch.scene import procedural

    st = scene_t.load_ron_scene(os.path.join(asset_root, "scenes",
                                             "city.ron"))
    sp = procedural.city(n=2, subdiv=8)
    assert len(st.instances) == len(sp.instances) == 5
    for it, ip in zip(st.instances[1:], sp.instances[1:]):
        np.testing.assert_array_equal(it.transform(), ip.transform())
    g = st.meshes[st.instances[0].mesh_id]
    world = g.positions * st.instances[0].scale
    np.testing.assert_array_equal(world, sp.meshes[3].positions)
    assert sum(st.meshes[i.mesh_id].num_triangles
               for i in st.instances) == 4 * 768 + 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_files_load_in_both_packages(asset_root, tmp_path, monkeypatch,
                                           writer):
    """The bake cache's key and .npz layout are shared: a mesh either
    package bakes loads in the other, with allow_pickle off."""
    monkeypatch.setattr(cache_t, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache_j, "CACHE_DIR", str(tmp_path))
    path = os.path.join(asset_root, "meshes", "rich.gltf")
    assert cache_t.cache_path(path) == cache_j.cache_path(path)
    assert cache_t.CACHE_VERSION == cache_j.CACHE_VERSION == 2
    first, second = (cache_t, cache_j) if writer == "port" else (cache_j,
                                                                  cache_t)
    baked = first.load_mesh_cached(path)
    cp = first.cache_path(path)
    assert os.path.exists(cp)
    loaded = second.load_mesh_cached(path)       # a cache hit
    _eq(loaded, first.load_packed(cp), "cached mesh")
    for f in ("positions", "normals", "uvs", "tangents", "colors", "indices",
              "material_ids"):
        np.testing.assert_array_equal(getattr(loaded, f), getattr(baked, f))
    assert list(loaded.image_paths) == list(baked.image_paths)
    # the cache keeps material factors as float32
    for ml, mb in zip(loaded.materials, baked.materials):
        assert np.float32(ml.roughness) == np.float32(mb.roughness)
        np.testing.assert_array_equal(ml.emissive,
                                      np.float32(mb.emissive))


def test_bake_cli(asset_root, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cache_t, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache_j, "CACHE_DIR", str(tmp_path))
    ron = os.path.join(asset_root, "scenes", "city.ron")
    bake_t.main(["--scene", ron])
    out = capsys.readouterr().out
    assert out.count("baked ") == len({i["mesh"] for i in
                                       ron_t.load(ron)["instances"]})
    for mesh in ("b0.gltf", "b1.gltf", "b2.gltf", "ground.glb"):
        p = os.path.join(asset_root, "meshes", mesh)
        if os.path.exists(cache_t.cache_path(p)):
            _eq(cache_j.load_packed(cache_t.cache_path(p)),
                cache_t.load_packed(cache_t.cache_path(p)), mesh)


@pytest.mark.parametrize("name", ["scenes/demo.ron", "scenes/city.ron",
                                  "meshes/rich.gltf", "meshes/ground.glb",
                                  "textured_cornell_box"])
def test_view_build_scene_matches_jax(asset_root, tmp_path, monkeypatch,
                                      name):
    monkeypatch.setattr(cache_t, "CACHE_DIR", str(tmp_path / "t"))
    monkeypatch.setattr(cache_j, "CACHE_DIR", str(tmp_path / "j"))
    arg = name if "/" not in name else os.path.join(asset_root, name)
    st, sj = view_t.build_scene(arg), view_j.build_scene(arg)
    assert len(st.meshes) == len(sj.meshes)
    for mt, mj in zip(st.meshes, sj.meshes):
        for f in ("positions", "normals", "uvs", "tangents", "indices",
                  "material_ids"):
            np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
        _eq(mt.materials, mj.materials, "materials")
        if name != "textured_cornell_box":   # the data URIs' encoders differ
            assert list(mt.image_paths) == list(mj.image_paths)
    for it, ij in zip(st.instances, sj.instances):
        np.testing.assert_array_equal(it.transform(), ij.transform())


def test_gpu_scene_textures_match_jax(asset_root):
    """The texture branch of build_gpu_scene: sources deduplicated across
    meshes, slot 0 white, material slot rows, and the atlas, as in JAX (the
    bufferView image of rich.gltf is white in both)."""
    path = os.path.join(asset_root, "scenes", "demo.ron")
    gj = scene_j.build_gpu_scene(scene_j.load_ron_scene(path))
    gt = scene_t.build_gpu_scene(scene_t.load_ron_scene(path), device="cpu")
    for f in ("tex_pages", "mat_tex", "page_sub"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert gt.mat_tex.tolist()[0] == [1, 2, 3, 2]
    un = scene_t.build_gpu_scene(scene_t.load_ron_scene(path),
                                 with_textures=False, device="cpu")
    assert un.tex_pages is None and un.mat_tex is None
    p, s, ox, oy = gt.page_sub[3].tolist()     # the bufferView image
    assert (gt.tex_pages[p, oy:oy + s, ox:ox + s] == 255).all()
