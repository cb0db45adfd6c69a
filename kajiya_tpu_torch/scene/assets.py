"""Textured asset scenes written to disk, for the loaders' whole path
(.ron -> glTF / GLB -> PNG texture pages -> frame) without outside files.

`write_gltf` writes one mesh with one material as a `.gltf` (JSON + `.bin`)
or a `.glb`. `write_city_assets` writes the textured city: three building
meshes (the `subdiv` box of `procedural.city`, per-face planar UVs, no
TANGENT attribute, so the loader generates tangents), each with its own
material and base colour, metallic-roughness and normal maps, the second
also an emissive map; and a ground quad as a `.glb` whose base colour is a
data-URI PNG with varied alpha. `write_city_ron` writes a `.ron` that
instances them as `procedural.city(n, subdiv, seed)` places its buildings.
The PNGs cycle through all five row filters and split their image data
over several IDAT chunks. Everything is made from a seed.

`write_city_assets(..., formats="mixed")` writes the same maps in the
formats a real asset carries (the mixed-format city): each base colour a
baseline 4:2:0 JPEG from the port's encoder, each normal map BC5 and each
metallic-roughness map BC7 (mode 6) in DX10 DDS files, b1's emissive map a
16-bit RGB PNG; the ground stays an 8-bit PNG data URI.
`formats="legacy"` writes them in the formats older game content and
glTF's EXT_texture_webp carry (the legacy-format city): each base colour a
32-bit RLE TGA (bottom-up), each normal map a 24-bit bottom-up BMP, each
metallic-roughness map a 256-colour GIF, b1's emissive map a lossless
WebP; each written by the port itself (`tga.encode_tga_rle`,
`bmp.encode_bmp24`, `gif.encode_gif256`, `webp.encode_vp8l`), which
reports the exact texels its file decodes to. `formats="tiff"` writes every
map as a TIFF (the TIFF-textured city), each in another layout of the
port's writer (`tiff.write_tiff`): base colours LZW with horizontal
differencing in 256 x 256 tiles, normal maps deflate in planar strips,
metallic-roughness maps big-endian 16-bit PackBits, and b1's emissive map
raw with Orientation 6 (stored turned a quarter, so that it decodes to the
map). `formats="studio"` writes them in the formats art and game
pipelines emit (the studio city): each base colour a 4-channel (RGBA,
alpha 255) PackBits PSD, each normal map an 8-bit 3-channel RLE SGI, each
metallic-roughness map a 24-bit 3-plane RLE PCX, b1's emissive map a QOI,
each from the port's writers (`psd.encode_psd`, `sgi.encode_sgi_rle`,
`pcx.encode_pcx_rgb`, `qoi.encode_qoi`). `formats="plugins"` writes them
in PIL's smaller plugins (the plugin city): each base colour an LZW LAB
TIFF with differencing (its samples an integer approximation of the map's
Lab; PIL converts LAB through LittleCMS, so no texels are known here), each
normal map a 24-bit RLE Sun raster, each metallic-roughness map a `P` XPM
of at most 256 colours (the map quantised: roughness to 64 levels), b1's
emissive map an ICNS whose best member is a PNG, beside an `it32` / `t8mk`
pair at 128^2 (`tiff.write_tiff`, `sun.encode_sun_rle`, `xpm.encode_xpm`,
`icns.encode_icns`).
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .bmp import encode_bmp24
from .dds import bc5_blocks, bc7_mode6_blocks, dds_header
from .gif import encode_gif256
from .icns import encode_icns, mask_member, rgb_member
from .pcx import encode_pcx_rgb
from .png import encode_png
from .procedural import _subdiv_box
from .psd import encode_psd
from .qoi import encode_qoi
from .sgi import encode_sgi_rle
from .sun import encode_sun_rle
from .tga import encode_tga_rle
from .tiff import write_tiff
from .webp import encode_vp8l
from .xpm import encode_xpm

BLOCK = 3.0
FILTERS = (0, 1, 2, 3, 4)
IDAT_BYTES = 1 << 20
# the three building materials of procedural.city: base colour, metallic,
# roughness
CITY_MATERIALS = (((0.65, 0.62, 0.58), 0.0, 0.9),
                  ((0.45, 0.5, 0.55), 0.6, 0.4),
                  ((0.6, 0.35, 0.3), 0.0, 0.8))
EMISSIVE_FACTOR = (2.0, 1.7, 1.2)
UV_REPEAT = 4.0       # texture repeats along each face of the unit box


def write_gltf(path: str, positions, normals, uvs, indices, material: dict,
               images: list) -> None:
    """One triangle mesh with one material. `material`: base_color (4),
    metallic, roughness, emissive (3), and texture image indices under
    base_color_texture / mr_texture / normal_texture / emissive_texture.
    `images`: uris (file names beside `path` or data URIs). A `.glb` path
    holds the buffer in its BIN chunk; a `.gltf` writes `<stem>.bin`."""
    arrays = [np.ascontiguousarray(positions, np.float32),
              np.ascontiguousarray(normals, np.float32),
              np.ascontiguousarray(uvs, np.float32),
              np.ascontiguousarray(indices, np.uint32).reshape(-1)]
    views, accessors, blob = [], [], b""
    kinds = (("VEC3", 5126), ("VEC3", 5126), ("VEC2", 5126),
             ("SCALAR", 5125))
    for a, (typ, comp) in zip(arrays, kinds):
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": a.nbytes})
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(a.shape[0]), "type": typ}
        if typ == "VEC3" and not accessors:
            acc.update(min=a.min(0).tolist(), max=a.max(0).tolist())
        accessors.append(acc)
        blob += a.tobytes()
    pbr = {"baseColorFactor": list(material["base_color"]),
           "metallicFactor": material["metallic"],
           "roughnessFactor": material["roughness"]}
    mat = {"pbrMetallicRoughness": pbr,
           "emissiveFactor": list(material.get("emissive", (0, 0, 0)))}
    for key, slot, target in (
            ("base_color_texture", "baseColorTexture", pbr),
            ("mr_texture", "metallicRoughnessTexture", pbr),
            ("normal_texture", "normalTexture", mat),
            ("emissive_texture", "emissiveTexture", mat)):
        if material.get(key, -1) >= 0:
            target[slot] = {"index": material[key]}
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
           "meshes": [{"primitives": [{
               "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
               "indices": 3, "material": 0}]}],
           "materials": [mat],
           "textures": [{"source": i} for i in range(len(images))],
           "images": [{"uri": u} for u in images],
           "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(blob)}]}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".glb"):
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        blob += b"\0" * (-len(blob) % 4)
        body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(blob), 0x004E4942) + blob)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
        return
    stem = os.path.splitext(os.path.basename(path))[0]
    doc["buffers"][0]["uri"] = f"{stem}.bin"
    with open(os.path.join(os.path.dirname(path), f"{stem}.bin"), "wb") as f:
        f.write(blob)
    with open(path, "w") as f:
        json.dump(doc, f)


def _noise(rng, shape, cells):
    """Smooth-ish value noise in [0, 1): a (cells, cells) grid, repeated."""
    h, w = shape
    g = rng.random((cells, cells), dtype=np.float32)
    return np.repeat(np.repeat(g, -(-h // cells), 0), -(-w // cells),
                     1)[:h, :w]


def _facade_maps(rng, size, tint, metallic):
    """(base colour, metallic-roughness, normal) maps of a building facade:
    window cells in a brick-like grid, mortar lines as normal-map grooves."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cell = 16
    fx, fy = (x * cell) % 1.0, (y * cell) % 1.0
    window = (fx > 0.2) & (fx < 0.8) & (fy > 0.25) & (fy < 0.75)
    n = _noise(rng, (size, size), 128)
    shade = np.where(window, 0.35, 0.75 + 0.25 * n)
    base = np.clip(np.asarray(tint, np.float32) * shade[..., None] * 1.3,
                   0, 1)
    mr = np.zeros((size, size, 3), np.float32)
    mr[..., 1] = np.where(window, 0.15, 0.6 + 0.4 * n)
    mr[..., 2] = np.where(window, 0.9, metallic)
    groove = np.minimum(np.minimum(fx, 1 - fx), np.minimum(fy, 1 - fy))
    slope = np.clip(0.05 - groove, 0, None) * 8.0
    nx = slope * np.sign(fx - 0.5)
    ny = slope * np.sign(fy - 0.5)
    nz = np.sqrt(np.clip(1 - nx * nx - ny * ny, 0, 1))
    nrm = np.stack([nx, ny, nz], -1) * 0.5 + 0.5
    return [(np.clip(m, 0, 1) * 255 + 0.5).astype(np.uint8)
            for m in (base, mr, nrm)]


def _png(img):
    return encode_png(img, filters=FILTERS, idat_bytes=IDAT_BYTES)


def lab_samples(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W, 3) uint8 TIFF CIELab samples (L, then
    a and b as signed bytes): luma as L, red - green as a and yellow - blue
    as b, in integers, so that every machine writes the same bytes."""
    c = rgb.astype(np.int32)
    lum = (77 * c[..., 0] + 150 * c[..., 1] + 29 * c[..., 2] + 128) >> 8
    a = np.clip((c[..., 0] - c[..., 1]) * 3 // 4, -128, 127)
    b = np.clip(((c[..., 0] + c[..., 1]) // 2 - c[..., 2]) * 3 // 4, -128,
                127)
    return (np.stack([lum, a, b], -1) & 255).astype(np.uint8)


# ICNS members by the PNG's size: (code, the code of its size's RGB member
# or None)
_ICNS_PNG = {1024: b"ic10", 512: b"ic09", 256: b"ic08", 128: b"ic07"}


def _plugin_map(kind: str, img: np.ndarray):
    """The plugin city's (suffix, bytes, RGBA or None for the LAB map)."""
    want = np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                        np.uint8)], -1)
    if kind == "base":
        return ".tif", write_tiff(lab_samples(img), photometric=8,
                                  compression=5, predictor=2,
                                  rows_per_strip=64), None
    if kind == "normal":
        return ".ras", encode_sun_rle(img), want
    if kind == "mr":
        q = img.copy()
        q[..., 1] &= 0xFC
        code = (q.astype(np.int32) << np.array([16, 8, 0])).sum(-1)
        codes, idx = np.unique(code, return_inverse=True)
        colours = ((codes[:, None] >> np.array([16, 8, 0])) & 255).astype(
            np.uint8)
        if len(colours) > 256:
            raise ValueError(f"{len(colours)} colours for a P XPM")
        want[..., :3] = q
        return ".xpm", encode_xpm(idx.reshape(q.shape[:2]), colours,
                                  bpp=2), want
    small = img[::max(1, img.shape[0] // 128), ::max(1, img.shape[1] // 128)]
    members = [(b"it32", rgb_member(small[:128, :128], it32=True)),
               (b"t8mk", mask_member(np.full((128, 128), 255, np.uint8))),
               (_ICNS_PNG[img.shape[0]], _png(img))]
    return ".icns", encode_icns(members), want


# DXGI formats of the mixed-format city's maps
DXGI_BC5_UNORM, DXGI_BC7_UNORM = 83, 98


def _map_file(kind: str, img: np.ndarray, formats: str):
    """(file suffix, bytes, the RGBA the decoders must give back or None
    where the format is lossy) of one building map."""
    if formats == "png":
        return ".png", _png(img), None
    if formats == "plugins":
        return _plugin_map(kind, img)
    if formats == "tiff":
        want = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        if kind == "base":
            data = write_tiff(img, compression=5, predictor=2,
                              tile=(256, 256))
        elif kind == "normal":
            data = write_tiff(img, compression=8, planar=2,
                              rows_per_strip=64)
        elif kind == "mr":
            data = write_tiff(img.astype(np.uint16) * 257,
                              compression=32773, order=">")
        else:
            data = write_tiff(np.ascontiguousarray(np.rot90(img, 1)),
                              orientation=6)
        return ".tif", data, want
    if formats == "tiffcodec":
        want = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        if kind == "base":
            data = write_tiff(img, compression=50000, predictor=2,
                              tile=(256, 256))
        elif kind == "normal":
            data = write_tiff(img.astype(np.uint16) * 257, compression=50000,
                              planar=2, order=">", rows_per_strip=256)
        elif kind == "mr":
            # roughness as 4-bit grey: glTF reads it from green, metallic
            # from blue, so both take the grey level
            grey = img[..., 1] >> 4
            data = write_tiff(grey, photometric=1, compression=32809, bits=4,
                              rows_per_strip=64)
            want = np.concatenate([np.repeat((grey * 17)[..., None], 3, -1),
                                   want[..., 3:]], -1)
        else:
            # the lit windows as a bilevel mask, white (bit 0 under
            # MinIsWhite) where lit
            lit = img.any(-1)
            data = write_tiff((~lit).astype(np.uint8), photometric=0,
                              compression=4, bits=1, fillorder=2)
            want = np.concatenate([np.repeat(
                np.where(lit, 255, 0).astype(np.uint8)[..., None], 3, -1),
                want[..., 3:]], -1)
        return ".tif", data, want
    if formats == "studio":
        if kind == "base":
            rgba = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
            return (".psd", *encode_psd(rgba))
        suffix, enc = {"normal": (".rgb", encode_sgi_rle),
                       "mr": (".pcx", encode_pcx_rgb),
                       "emissive": (".qoi", encode_qoi)}[kind]
        return (suffix, *enc(img))
    if formats == "legacy":
        suffix, enc = {"base": (".tga", encode_tga_rle),
                       "normal": (".bmp", encode_bmp24),
                       "mr": (".gif", encode_gif256),
                       "emissive": (".webp", encode_vp8l)}[kind]
        return (suffix, *enc(img))
    if kind == "base":
        from .jpeg import encode_jpeg

        return ".jpg", encode_jpeg(img), None
    h, w = img.shape[:2]
    if kind == "normal":
        data, texels = bc5_blocks(img[..., :2])
        want = np.zeros((h, w, 4), np.uint8)
        want[..., :2] = texels
        want[..., 3] = 255
        return ".dds", dds_header(w, h, DXGI_BC5_UNORM) + data, want
    if kind == "mr":
        rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
        data, texels = bc7_mode6_blocks(rgba)
        return ".dds", dds_header(w, h, DXGI_BC7_UNORM) + data, texels
    # the emissive map as 16-bit samples whose high bytes are the map
    want = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return ".png", _png(img.astype(np.uint16) * 257), want


def write_city_assets(root: str, subdiv: int = 8, map_size: int = 2048,
                      emissive_size: int = 1024, ground_size=(2048, 4096),
                      seed: int = 7, formats: str = "png") -> dict:
    """The meshes and maps of the textured city under `root/meshes/`:
    b0.gltf, b1.gltf, b2.gltf (+ .bin and maps at `map_size`^2 RGB, b1
    also an `emissive_size`^2 emissive map) and ground.glb (a unit quad
    whose base colour is a data-URI PNG of `ground_size` (H, W) RGBA).
    `formats`: "png" (every map an 8-bit PNG), "mixed" (JPEG base colour,
    BC5 / BC7 DDS normal and metallic-roughness maps, a 16-bit PNG emissive
    map), "legacy" (RLE TGA base colour, BMP normal, GIF
    metallic-roughness and lossless WebP emissive maps), "tiff" (every
    map a TIFF, each in another layout), "studio" (PSD base colour, SGI
    normal, PCX metallic-roughness and QOI emissive maps) or "tiffcodec"
    (TIFFs of the later codecs: zstd RGB tiles with differencing, zstd
    16-bit planar big-endian normals, ThunderScan 4-bit grey
    metallic-roughness, a CCITT Group 4 bilevel emissive window mask) or
    "plugins" (LAB TIFF base colour, RLE Sun raster normal, XPM
    metallic-roughness and ICNS emissive maps). Returns {file name: (the
    RGB map written, the RGBA its file decodes to, or None for a JPEG, an
    8-bit PNG or a LAB TIFF)} of the building maps."""
    if formats not in ("png", "mixed", "legacy", "tiff", "studio",
                       "tiffcodec", "plugins"):
        raise ValueError(f"formats {formats!r}: 'png', 'mixed', 'legacy', "
                         "'tiff', 'studio', 'tiffcodec' or 'plugins'")
    rng = np.random.default_rng(seed)
    mdir = os.path.join(root, "meshes")
    os.makedirs(mdir, exist_ok=True)
    v, nrm, idx = _subdiv_box(subdiv)
    # per-face planar UVs: the two in-plane coordinates of the unit box
    axis = np.abs(nrm).argmax(-1)
    uv = np.stack([v[np.arange(len(v)), (axis + 1) % 3],
                   v[np.arange(len(v)), (axis + 2) % 3]], -1) * UV_REPEAT
    written = {}
    for k, (tint, metallic, rough) in enumerate(CITY_MATERIALS):
        kinds = ["base", "mr", "normal"]
        maps = _facade_maps(rng, map_size, tint, metallic)
        mat = dict(base_color=(*tint, 1.0), metallic=metallic,
                   roughness=rough, base_color_texture=0, mr_texture=1,
                   normal_texture=2)
        if k == 1:
            s = emissive_size
            y, x = np.mgrid[0:s, 0:s] * (16.0 / s)
            lit = (((x % 1) > 0.2) & ((x % 1) < 0.8) & ((y % 1) > 0.25)
                   & ((y % 1) < 0.75)
                   & (_noise(rng, (s, s), 16) > 0.6))
            em = np.zeros((s, s, 3), np.uint8)
            em[lit] = (255, 214, 150)
            kinds.append("emissive")
            maps.append(em)
            mat.update(emissive=EMISSIVE_FACTOR, emissive_texture=3)
        names = []
        for kind, img in zip(kinds, maps):
            suffix, data, want = _map_file(kind, img, formats)
            names.append(f"b{k}_{kind}{suffix}")
            with open(os.path.join(mdir, names[-1]), "wb") as f:
                f.write(data)
            written[names[-1]] = (img, want)
        write_gltf(os.path.join(mdir, f"b{k}.gltf"), v, nrm, uv, idx, mat,
                   names)

    gh, gw = ground_size
    y, x = np.mgrid[0:gh, 0:gw].astype(np.float32)
    n = _noise(rng, (gh, gw), 256)
    lane = ((x / gw * 32) % 1.0 < 0.04)
    grey = np.where(lane, 0.8, 0.25 + 0.2 * n)
    ground = np.empty((gh, gw, 4), np.uint8)
    ground[..., :3] = (np.stack([grey, grey, grey * 1.05], -1).clip(0, 1)
                       * 255).astype(np.uint8)
    # alpha from 0 to 255 across the image, with noise: low-alpha texels
    # have their colour quantised by the premultiplied resize
    alpha = np.clip(x / gw * 300.0 - 20.0 + 40.0 * (n - 0.5), 0, 255)
    ground[..., 3] = alpha.astype(np.uint8)
    uri = "data:image/png;base64," + base64.b64encode(_png(ground)).decode()
    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32)
    write_gltf(os.path.join(mdir, "ground.glb"), quad,
               np.tile(np.array([0, 1, 0], np.float32), (4, 1)),
               (quad[:, [0, 2]] + 1.0) * 2.0,
               np.array([[0, 2, 1], [0, 3, 2]], np.uint32),
               dict(base_color=(0.35, 0.35, 0.35, 1.0), metallic=0.0,
                    roughness=0.95, base_color_texture=0), [uri])
    return written


def write_city_ron(root: str, n: int = 16, seed: int = 7,
                   name: str = "city") -> str:
    """`root/scenes/<name>.ron`: the ground scaled to the n x n grid and the
    buildings placed as `procedural.city(n, seed=seed)` places them (same
    random draws). Mesh paths resolve two levels up, under `root`."""
    rng = np.random.default_rng(seed)
    ext = n * BLOCK * 0.5
    lines = [f'        (mesh: "/meshes/ground.glb", position: (0.0, 0.0, '
             f'0.0), scale: ({ext!r}, 1.0, {ext!r})),']
    for gz in range(n):
        for gx in range(n):
            w = BLOCK * rng.uniform(0.35, 0.75)
            h = BLOCK * rng.uniform(0.6, 4.0)
            x = (gx + 0.5) * BLOCK - ext
            z = (gz + 0.5) * BLOCK - ext
            k = int(rng.integers(3))
            lines.append(
                f'        (mesh: "/meshes/b{k}.gltf", position: '
                f'({x - w / 2!r}, 0.0, {z - w / 2!r}), scale: ({w!r}, '
                f'{h!r}, {w!r})),')
    path = os.path.join(root, "scenes", f"{name}.ron")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("(\n    instances: [\n" + "\n".join(lines) + "\n    ],\n)\n")
    return path
