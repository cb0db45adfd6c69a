"""Texture pages of the port (`kajiya_tpu_torch/scene/textures.py`) against
PIL and the JAX package.

Tolerances: the Lanczos resize equals PIL's `Image.resize(..., LANCZOS)`
byte for byte; the atlas and `page_sub` equal the JAX package's byte for
byte; `sample_pages` agrees with JAX's within 1e-6 absolute (float32 blends
of the same texels); the page and tangent checks of `tests/test_textures.py`
hold with that file's own bounds."""
import base64
import io
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kajiya_tpu.scene import textures as tex_j
from kajiya_tpu.scene.gltf import generate_tangents as tangents_j
from kajiya_tpu_torch.scene import textures as tex_t
from kajiya_tpu_torch.scene.gltf import generate_tangents as tangents_t
from kajiya_tpu_torch.scene.png import encode_png


def _pil_resize(img, size):
    return np.asarray(Image.fromarray(img).resize((size, size),
                                                  Image.LANCZOS))


RESIZE_CASES = {
    "rgb_up_32_128": ((32, 32, 3), 128, None),
    "rgb_up_nonsquare": ((40, 64, 3), 128, None),
    "rgb_down_nonsquare": ((300, 200, 3), 256, None),
    "rgb_down_700_512": ((700, 700, 3), 512, None),
    "rgb_odd_17x33": ((17, 33, 3), 128, None),
    "rgba_alpha_0": ((48, 40, 4), 128, 0),
    "rgba_alpha_1": ((48, 40, 4), 128, 1),
    "rgba_alpha_128": ((48, 40, 4), 128, 128),
    "rgba_alpha_255": ((48, 40, 4), 128, 255),
    "rgba_alpha_mixed_down": ((520, 300, 4), 256, "mixed"),
    "rgba_alpha_mixed_up": ((33, 50, 4), 128, "mixed"),
    "rgba_one_axis": ((128, 300, 4), 128, "mixed"),
    "rgba_same_size": ((128, 128, 4), 128, "mixed"),
    "rgb_same_size": ((256, 256, 3), 256, None),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matches_pil(case):
    shape, size, alpha = RESIZE_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if alpha == "mixed":
        img[..., 3] = rng.choice([0, 1, 2, 64, 128, 254, 255], shape[:2])
    elif alpha is not None:
        img[..., 3] = alpha
    got = tex_t._resize(img, size)
    np.testing.assert_array_equal(got, _pil_resize(img, size))
    if shape[:2] == (size, size):
        assert got is not img and np.shares_memory(got, img) is False


def _write_png_pil(path, img):
    Image.fromarray(img).save(path)
    return str(path)


def _data_uri(img):
    return "data:image/png;base64," + base64.b64encode(
        encode_png(img, filters=(0, 1, 2, 3, 4))).decode()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Image sources of every kind the bake meets: PNG files from PIL
    (RGB, RGBA with varied alpha, grey, palette), data URIs from the
    port's encoder, a duplicate, a missing path, a PNG with a bad checksum,
    bytes of no known format and a PNG with corrupt image data (the last
    four turn white)."""
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.default_rng(11)
    rgba = rng.integers(0, 256, (96, 160, 4), dtype=np.uint8)
    rgba[..., 3] = rng.choice([0, 1, 30, 128, 255], (96, 160))
    pal = Image.fromarray(rng.integers(0, 256, (40, 40, 3),
                                       dtype=np.uint8)).quantize(16)
    pal_path = str(d / "pal.png")
    pal.save(pal_path)
    corrupt = bytearray(encode_png(rng.integers(0, 256, (20, 20, 3),
                                                dtype=np.uint8)))
    corrupt[29] ^= 0xFF
    (d / "corrupt.png").write_bytes(bytes(corrupt))
    (d / "unknown.bin").write_bytes(b"not an image at all")
    bad_zlib = bytearray(encode_png(rng.integers(0, 256, (20, 20, 3),
                                                 dtype=np.uint8)))
    i = bad_zlib.index(b"IDAT") + 4
    bad_zlib[i:i + 2] = b"\x78\x00"         # a zlib header that fails its check
    (d / "bad_zlib.png").write_bytes(bytes(bad_zlib))
    a = _write_png_pil(d / "a.png", rng.integers(0, 256, (300, 260, 3),
                                                 dtype=np.uint8))
    return [
        a,
        _write_png_pil(d / "rgba.png", rgba),
        _write_png_pil(d / "grey.png", rng.integers(0, 256, (64, 64),
                                                    dtype=np.uint8)),
        pal_path,
        _data_uri(rng.integers(0, 256, (1024, 700, 3), dtype=np.uint8)),
        _data_uri(rng.integers(0, 256, (128, 128, 4), dtype=np.uint8)),
        a,                                   # a duplicate slot
        str(d / "missing.png"),
        str(d / "corrupt.png"),
        str(d / "unknown.bin"),
        str(d / "bad_zlib.png"),
    ]


def test_pages_match_jax(sources):
    atlas_j, sub_j = tex_j.build_texture_pages(sources)
    atlas_t, sub_t = tex_t.build_texture_pages(sources, device="cpu")
    assert atlas_t.dtype == torch.uint8 and sub_t.dtype == torch.int32
    np.testing.assert_array_equal(sub_t.numpy(), np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t.numpy(), np.asarray(atlas_j))
    sub = sub_t.numpy()
    assert sub[1, 1] == 512 and sub[5, 1] == 1024   # buckets keep detail
    # the missing, corrupt and unknown sources are 4x4 white -> 128 white
    for slot in (8, 9, 10, 11):
        p, s, ox, oy = sub[slot]
        assert s == 128
        assert (atlas_t.numpy()[p, oy:oy + s, ox:ox + s] == 255).all()


@pytest.mark.parametrize("page_size,n_mips", [(1024, 4), (2048, None)])
def test_pages_explicit_size_match_jax(sources, page_size, n_mips):
    srcs = sources[2:4] + sources[7:8]
    atlas_j, sub_j = tex_j.build_texture_pages(srcs, page_size, n_mips)
    atlas_t, sub_t = tex_t.bake_texture_pages(srcs, page_size, n_mips)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))


@pytest.fixture(scope="module")
def pages(sources):
    srcs = sources[:6]
    pj = tex_j.build_texture_pages(srcs)
    pt = tex_t.build_texture_pages(srcs, device="cpu")
    return pj, pt


SAMPLE_CASES = [dict(mip=0), dict(mip=2), dict(mip=7), dict(mip=3,
                                                              nearest=True),
                dict(mip="per_ray"), dict(mip="per_ray", nearest=True),
                dict(lod="lod"), dict(lod="lod", nearest=True),
                dict(lod="lod", srgb=True), dict(mip=0, srgb=True),
                dict(mip=1, nearest=True, srgb=True)]


@pytest.mark.parametrize("case", range(len(SAMPLE_CASES)))
def test_sample_pages_matches_jax(pages, case):
    (pj, sj), (pt, st) = pages
    kw = dict(SAMPLE_CASES[case])
    rng = np.random.default_rng(case)
    n = 4096
    idx = rng.integers(-1, 9, n).astype(np.int32)      # incl. out of range
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)  # wraps both ways
    uv[:8] = [[0, 0], [1, 1], [-1e-9, 0.5], [0.5, 1 - 1e-7], [2, -3],
              [0.25, 0.75], [-0.5, -0.5], [1e-7, 1e-7]]
    kj, kt = {}, {}
    if kw.pop("mip", None) == "per_ray":
        m = rng.integers(0, 9, n).astype(np.int32)
        kj["mip"], kt["mip"] = jnp.asarray(m), torch.from_numpy(m)
    else:
        kj["mip"] = kt["mip"] = SAMPLE_CASES[case].get("mip", 0)
    if kw.pop("lod", None):
        lb = rng.uniform(-12.0, 2.0, n).astype(np.float32)
        kj["lod_base"], kt["lod_base"] = jnp.asarray(lb), torch.from_numpy(lb)
    out_j = tex_j.sample_pages(pj, sj, jnp.asarray(idx), jnp.asarray(uv),
                               **kj, **kw)
    out_t = tex_t.sample_pages(pt, st, torch.from_numpy(idx),
                               torch.from_numpy(uv), **kt, **kw)
    assert out_t.dtype == torch.float32 and out_t.shape == (n, 4)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_textures.py (TestPages, TestTangents)
# ---------------------------------------------------------------------------

def _mip_region(atlas, m):
    s = atlas.shape[1]
    if m == 0:
        return atlas[:, :s, :s]
    sm = s >> m
    y0 = s - 2 * sm
    return atlas[:, y0:y0 + sm, s:s + sm]


def _pages_of(tmp_path, img, name):
    p = str(tmp_path / name)
    Image.fromarray(img).save(p)
    return tex_t.build_texture_pages([p], device="cpu")


class TestPages:
    def test_white_page_default(self):
        pages, sub = tex_t.build_texture_pages([], device="cpu")
        s = tex_t.PAGE_SIZE
        assert pages.shape == (1, s, s + s // 2, 4)
        assert pages.dtype == torch.uint8
        for m in range(tex_t.N_MIPS):
            assert int(_mip_region(pages, m).min()) == 255
        assert sub[0].tolist() == [0, s, 0, 0]

    def test_bucket_sizes_and_packing(self, tmp_path):
        rng = np.random.default_rng(0)
        paths = []
        for i, side in enumerate([1024, 300, 100, 64, 64]):
            img = rng.integers(0, 255, (side, side, 4), dtype=np.uint8)
            paths.append(str(tmp_path / f"b{i}.png"))
            Image.fromarray(img).save(paths[-1])
        pages, sub = tex_t.build_texture_pages(paths, device="cpu")
        sub = sub.numpy()
        assert sub[1, 1] == 1024 and sub[2, 1] == 512
        assert sub[3, 1] == 128 and sub[4, 1] == 128
        assert pages.shape[1] == 1024
        assert _mip_region(pages, 6).shape[1] == 16
        boxes = {}
        for p, size, ox, oy in sub:
            boxes.setdefault(p, []).append((ox, oy, ox + size, oy + size))
        for bs in boxes.values():
            for i in range(len(bs)):
                for j in range(i + 1, len(bs)):
                    a, b = bs[i], bs[j]
                    assert (a[2] <= b[0] or b[2] <= a[0]
                            or a[3] <= b[1] or b[3] <= a[1])

    def test_sample_bilinear_wrap(self, tmp_path):
        g = np.linspace(0, 255, 256).astype(np.uint8)
        img = np.broadcast_to(g[None, :, None], (256, 256, 4)).copy()
        pages, sub = _pages_of(tmp_path, img, "g.png")
        idx = torch.ones((3,), dtype=torch.int32)
        uv = torch.tensor([[0.25, 0.5], [0.75, 0.5], [1.25, 0.5]])
        out = tex_t.sample_pages(pages, sub, idx, uv, mip=0)
        assert abs(float(out[0, 0]) - 0.25) < 0.01
        assert abs(float(out[1, 0]) - 0.75) < 0.01
        assert abs(float(out[2, 0]) - float(out[0, 0])) < 1e-5

    def test_mip_is_average(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (256, 256, 4), dtype=np.uint8)
        pages, sub = _pages_of(tmp_path, img, "m.png")
        s, ox, oy = (int(x) for x in sub[1][1:])
        m0 = _mip_region(pages, 0)[-1].numpy()[oy:oy + s, ox:ox + s]
        m2 = _mip_region(pages, 2)[-1].numpy()[
            oy >> 2:(oy + s) >> 2, ox >> 2:(ox + s) >> 2]
        assert abs(m0.mean() - m2.mean()) < 1.5

    def test_dynamic_mip_matches_static(self, tmp_path):
        rng = np.random.default_rng(3)
        img = rng.integers(0, 255, (256, 256, 4), dtype=np.uint8)
        pages, sub = _pages_of(tmp_path, img, "d.png")
        idx = torch.ones((5,), dtype=torch.int32)
        uv = torch.tensor([[0.13, 0.77], [0.5, 0.5], [0.9, 0.1],
                           [0.33, 0.66], [0.25, 0.75]])
        size = float(sub[1, 1])
        for m in range(4):
            stat = tex_t.sample_pages(pages, sub, idx, uv, mip=m,
                                      nearest=True)
            lb = torch.full((5,), m - np.log2(size), dtype=torch.float32)
            dyn = tex_t.sample_pages(pages, sub, idx, uv, lod_base=lb,
                                     nearest=True)
            torch.testing.assert_close(stat, dyn, rtol=0, atol=0)
        lb = torch.tensor([0, 1, 2, 3, 1], dtype=torch.float32) - np.log2(
            size)
        dyn = tex_t.sample_pages(pages, sub, idx, uv, lod_base=lb,
                                 nearest=True)
        for i, m in enumerate([0, 1, 2, 3, 1]):
            stat = tex_t.sample_pages(pages, sub, idx, uv, mip=m,
                                      nearest=True)
            torch.testing.assert_close(stat[i], dyn[i], rtol=0, atol=0)

    def test_srgb_per_slot(self, tmp_path):
        img = np.full((64, 64, 4), 128, np.uint8)
        pages, sub = _pages_of(tmp_path, img, "s.png")
        idx = torch.ones((1,), dtype=torch.int32)
        uv = torch.tensor([[0.5, 0.5]])
        lin = tex_t.sample_pages(pages, sub, idx, uv, nearest=True)
        col = tex_t.sample_pages(pages, sub, idx, uv, nearest=True, srgb=True)
        assert abs(float(lin[0, 0]) - 128 / 255) < 5e-3
        assert abs(float(col[0, 0]) - 0.214) < 1e-2
        assert abs(float(col[0, 3]) - float(lin[0, 3])) < 1e-6

    def test_small_texture_keeps_content_through_mips(self, tmp_path):
        img = np.zeros((128, 128, 4), np.uint8)
        img[:, :64] = 255
        pages, sub = _pages_of(tmp_path, img, "h.png")
        idx = torch.ones((2,), dtype=torch.int32)
        uv = torch.tensor([[0.20, 0.5], [0.80, 0.5]])
        for mip in range(3):
            out = tex_t.sample_pages(pages, sub, idx, uv, mip=mip,
                                     nearest=True)
            assert float(out[0, 0]) > 0.9
            assert float(out[1, 0]) < 0.1


class TestTangents:
    def test_generated_tangents_follow_uv(self):
        pos = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]],
                       np.float32)
        nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
        tan = tangents_t(pos, nrm, uv, idx)
        assert tan.shape == (4, 4)
        np.testing.assert_allclose(tan[:, :3], np.tile([1, 0, 0], (4, 1)),
                                   atol=1e-5)
        assert np.all(np.abs(tan[:, 3]) == 1.0)
        assert np.abs((tan[:, :3] * nrm).sum(-1)).max() < 1e-5
        np.testing.assert_array_equal(tan, tangents_j(pos, nrm, uv, idx))

    def test_degenerate_uv_fallback(self):
        pos = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        nrm = np.tile(np.array([0, 1, 0], np.float32), (3, 1))
        uv = np.zeros((3, 2), np.float32)
        idx = np.array([[0, 1, 2]], np.uint32)
        tan = tangents_t(pos, nrm, uv, idx)
        np.testing.assert_allclose(np.linalg.norm(tan[:, :3], axis=-1), 1.0,
                                   atol=1e-5)
        assert np.abs((tan[:, :3] * nrm).sum(-1)).max() < 1e-5
        np.testing.assert_array_equal(tan, tangents_j(pos, nrm, uv, idx))

    def test_random_mesh_matches_jax(self):
        rng = np.random.default_rng(9)
        pos = rng.normal(size=(60, 3)).astype(np.float32)
        nrm = rng.normal(size=(60, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        uv = rng.uniform(-1, 2, (60, 2)).astype(np.float32)
        idx = rng.integers(0, 60, (80, 3)).astype(np.uint32)
        np.testing.assert_array_equal(tangents_t(pos, nrm, uv, idx),
                                      tangents_j(pos, nrm, uv, idx))


def test_pages_on_a_cuda_request_need_the_card():
    """The bake runs on the host; the upload goes to the asked device, and
    CUDA without a card raises instead of keeping the pages on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex_t.build_texture_pages([])
    data = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(data, format="PNG")
    atlas, sub = tex_t.bake_texture_pages(
        ["data:image/png;base64," + base64.b64encode(data.getvalue())
         .decode()])
    assert isinstance(atlas, np.ndarray) and sub.shape == (2, 4)
