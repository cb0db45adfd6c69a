"""JPEG 2000 as the bake meets it: the committed fixtures of
`tests/data/j2k/` against their manifest (PIL's digests, which
`chip_smoke.py::j2k_phase` holds the card's host to), ICNS files whose
best member is a JPEG 2000 codestream or JP2 file, the writer
(`j2k.encode_j2k`: lossless 5/3, one layer, one tile) against PIL's decode
of its files, the JPEG 2000 city's maps (`assets.write_city_assets(...,
formats="j2k")`) against PIL and their writer's texels, and the bake of
that city at the small frames' size (`tcityj2k4`: n = 4, 256^2 maps)
against JAX's `build_texture_pages`, byte for byte, with the scene's
texture tables."""
import collections
import glob
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import assets, icns, j2k, textures
from test_torch_bmp import assert_bake_matches_jax, sweep_outcome
from test_torch_j2k import picture, pil_j2k

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "j2k")
_MANIFEST_PATH = os.path.join(FIXTURES, "manifest.json")
MANIFEST = json.load(open(_MANIFEST_PATH)) if os.path.exists(
    _MANIFEST_PATH) else {}


def test_manifest_lists_every_kind():
    kinds = collections.Counter(n.split("_")[0] for n in MANIFEST)
    assert set(kinds) == {"mode", "res", "tiles", "layers", "prog", "cblk",
                          "opt", "odd", "big", "style", "packets", "jp2",
                          "icns"}
    assert kinds["mode"] == 28 and kinds["style"] == 15
    assert sum(r["bytes"] for r in MANIFEST.values()) < 1_000_000
    assert sorted(n for n, r in MANIFEST.items() if r.get("white")) == [
        "prog_cprl_prec16.j2k"]
    assert sorted(n for n, r in MANIFEST.items() if r.get("unported")) == [
        "style_htj2k_53.j2k"]


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_matches_manifest(name):
    """Each fixture: PIL still gives the manifest's digest, and the port
    the same bytes (white and NotImplementedError where marked)."""
    rec = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == rec["bytes"]
    if rec.get("unported"):
        with pytest.raises(NotImplementedError, match="HTJ2K"):
            textures._decode_image(path)
        return
    if rec.get("white"):
        assert sweep_outcome(data) == "white"
        return
    pil = np.asarray(Image.open(path).convert("RGBA"))
    assert list(pil.shape) == rec["shape"]
    assert hashlib.sha256(pil.tobytes()).hexdigest() == rec["rgba_sha256"]
    np.testing.assert_array_equal(textures._decode_image(path), pil)


@pytest.mark.parametrize("case", ["ic09-j2k", "ic10-jp2", "ic12-small",
                                  "jp2-signature-only", "bad-size",
                                  "cut-member", "png-and-it32"])
def test_icns_members(case):
    """ICNS's JPEG 2000 members (`read_png_or_jpeg2000`): a codestream or
    JP2 file of a size some listed size divides decodes, converted to
    RGBA; a member that only starts with the signature box's payload, one
    of another size, or a cut one whitens (PIL reads members at load
    time)."""
    rng = np.random.default_rng(len(case))
    member = pil_j2k(picture(len(case), 64, 64), "RGBA", no_jp2=True)
    if case == "ic09-j2k":
        members = [(b"ic09", member)]
    elif case == "ic10-jp2":
        members = [(b"ic10", pil_j2k(picture(3, 128, 128), "RGB"))]
    elif case == "ic12-small":
        members = [(b"ic12", pil_j2k(picture(4, 32, 32), "L"))]
    elif case == "jp2-signature-only":
        members = [(b"ic09", b"\x0d\x0a\x87\x0a" + bytes(60))]
    elif case == "bad-size":
        members = [(b"ic09", pil_j2k(picture(5, 60, 64), "RGB",
                                     no_jp2=True))]
    elif case == "cut-member":
        members = [(b"ic09", member[:len(member) // 2])]
    else:
        img = rng.integers(0, 256, (128, 128, 3), np.uint8)
        members = [(b"it32", icns.rgb_member(img, it32=True)),
                   (b"ic07", member)]
    data = icns.encode_icns(members)
    want = "white" if case in ("jp2-signature-only", "bad-size",
                               "cut-member") else "pixels"
    assert sweep_outcome(data) == want


@pytest.mark.parametrize("layout", [
    dict(), dict(jp2=True, levels=6, cblk=64, progression="RPCL",
                 precinct=64),
    dict(levels=2, cblk=16, progression="PCRL", precinct=32),
    dict(levels=0, cblk=4), dict(levels=3, progression="CPRL", precinct=16),
    dict(levels=4, progression="RLCP")])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (33, 17), (100, 37)])
def test_writer_decodes_to_its_texels(shape, mode, layout):
    """`encode_j2k`'s files decode, in PIL and in the port, to exactly the
    texels it reports."""
    img = picture(sum(shape), *shape)
    data, texels = j2k.encode_j2k(img, mode, **layout)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")), texels)
    np.testing.assert_array_equal(j2k.decode_j2k(data), texels)


@pytest.mark.parametrize("layout", ["base", "base-b1"])
def test_writer_at_full_size(layout):
    """The city's two base-colour layouts on a 2048^2 facade map (5
    levels, 32 x 32 code-blocks, LRCP; 7 levels, 64 x 64, RPCL over 256 x
    256 precincts): PIL's decode equals the writer's texels."""
    rgb = assets._facade_maps(np.random.default_rng(7), 2048,
                              (0.8, 0.6, 0.5), 0.1)[0]
    rgba = np.concatenate([rgb, np.full((2048, 2048, 1), 255, np.uint8)], -1)
    kw = dict(levels=7, cblk=64, progression="RPCL", precinct=256) \
        if layout == "base-b1" else {}
    data, texels = j2k.encode_j2k(rgba, "RGBA", jp2=True, **kw)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")), texels)
    np.testing.assert_array_equal(j2k.decode_j2k(data), texels)


@pytest.fixture(scope="module")
def j2k_city(tmp_path_factory):
    """The small frames' JPEG 2000 city, as chip_smoke.py writes
    `tcityj2k4`."""
    root = str(tmp_path_factory.mktemp("tcityj2k4"))
    written = assets.write_city_assets(root, map_size=256, emissive_size=128,
                                       ground_size=(256, 512), formats="j2k")
    return root, written, assets.write_city_ron(root, n=4)


def test_city_maps_as_pil(j2k_city):
    """Every map of the JPEG 2000 city decodes, in PIL and in the port, to
    the texels its writer reports."""
    root, written, _ = j2k_city
    kinds = collections.Counter()
    for name, (_img, want) in sorted(written.items()):
        path = os.path.join(root, "meshes", name)
        pil = np.asarray(Image.open(path).convert("RGBA"))
        np.testing.assert_array_equal(pil, want, err_msg=name)
        np.testing.assert_array_equal(textures._decode_image(path), want,
                                      err_msg=name)
        kinds[os.path.splitext(name)[1]] += 1
    assert kinds == {".jp2": 4, ".j2k": 6}


def test_j2k_city_bake_matches_jax(j2k_city):
    root, _written, _ = j2k_city
    srcs = sorted(glob.glob(os.path.join(root, "meshes", "*_*.*")))
    assert len(srcs) == 10
    atlas_t, sub_t = textures.bake_texture_pages(srcs)
    from kajiya_tpu.scene import textures as tex_j

    atlas_j, sub_j = tex_j.build_texture_pages(srcs)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


def test_j2k_city_texture_tables_match(j2k_city):
    """The whole load (.ron -> glTF -> bake -> scene tables) of
    `tcityj2k4` equals JAX's."""
    from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
    from kajiya_tpu.scene.scene import load_ron_scene as load_ron_j
    from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
    from kajiya_tpu_torch.scene.scene import load_ron_scene as load_ron_t

    ron = j2k_city[2]
    gpu_j = build_gpu_j(load_ron_j(ron))
    gpu_t = build_gpu_t(load_ron_t(ron), device="cpu")
    for f in ("tex_pages", "page_sub", "mat_tex", "tri_mat"):
        np.testing.assert_array_equal(
            np.asarray(getattr(gpu_t, f).cpu()),
            np.asarray(getattr(gpu_j, f)), err_msg=f)


def test_bake_matches_jax():
    """Fixtures of each kind through both bakes."""
    names = ("mode_ycbcr_97.jp2", "tiles_1.jp2", "packets_ppt.j2k",
             "style_all_97.j2k", "jp2_pclr.jp2", "icns_ic09_j2k.icns",
             "mode_i16_53.j2k", "odd_17x33.jp2")
    sources = []
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            sources.append(f.read())
    assert_bake_matches_jax(sources)
