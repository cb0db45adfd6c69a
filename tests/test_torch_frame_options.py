"""Port parity, the frame's last options pass by pass: the traced g-buffer
(against the raster g-buffer, as `tests/test_raster.py` holds JAX's, and
against JAX's traced one; tiled primaries on the clustered city), the world
radiance cache's trace and lookup, depth of field, the IBL sky's RGBE
decoder and panorama resampling, and `check_supported`, which refuses
nothing now. The frame with all four options on is
test_torch_frame_options_frame.py (JAX's first eager frame takes ~60 s)."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.ops import tiling as tiling_j
from kajiya_tpu.renderers import dof as dof_j
from kajiya_tpu.renderers import gbuffer as gbuffer_j
from kajiya_tpu.renderers import wrc as wrc_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.sky import env as sky_j
from kajiya_tpu.sky import ibl as ibl_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.frame import RenderConfig, check_supported
from kajiya_tpu_torch.ops import tiling as tiling_t
from kajiya_tpu_torch.renderers import dof as dof_t
from kajiya_tpu_torch.renderers import gbuffer as gbuffer_t
from kajiya_tpu_torch.renderers import wrc as wrc_t
from kajiya_tpu_torch.rt.trace import Hit
from kajiya_tpu_torch.sky import env as sky_t
from kajiya_tpu_torch.sky import ibl as ibl_t

W, H = 64, 48
GB_KEYS = ("depth", "albedo", "normal", "geo_normal", "velocity", "pos",
           "metallic", "roughness", "emissive", "ray_dir")


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def scene_setup(make, eye, fwd, w=W, h=H):
    ts_j, _ = build_ts_j(build_gpu_j(make()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    vj = view_j(eye, fwd, fov_y_deg=55.0, width=w, height=h)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    return ts_j, ts_t, vj, vt


SCENES = {
    "cornell": (lambda: proc_j.cornell_box(), (0.0, 0.0, 2.4),
                (0.0, 0.0, -1.0)),
    "city": (lambda: proc_j.city(n=4, subdiv=8), (0.0, 8.0, 14.0),
             (0.0, -0.45, -1.0)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def gbuffers(request):
    ts_j, ts_t, vj, vt = scene_setup(*SCENES[request.param])
    return dict(
        name=request.param, ts_t=ts_t,
        traced_t=gbuffer_t.raytrace_gbuffer(ts_t, vt, W, H),
        raster_t=gbuffer_t.raster_gbuffer(ts_t, vt, W, H),
        traced_j=gbuffer_j.raytrace_gbuffer(ts_j, vj, W, H))


def test_traced_gbuffer_equals_raster_gbuffer(gbuffers):
    """Same intersector, same hits: every plane within 1e-6 (the raster
    path's binned lists against the traced path's culled or brute walk),
    the hit masks equal; on the city the traced rays went out tiled."""
    g = gbuffers
    if g["name"] == "city":
        assert "cmin" in g["ts_t"].woop
    tr, ra = g["traced_t"], g["raster_t"]
    assert torch.equal(tr["hit"], ra["hit"])
    assert float(tr["hit"].float().mean()) > 0.3
    for k in GB_KEYS:
        np.testing.assert_allclose(_n(tr[k]), _n(ra[k]), atol=1e-6,
                                   err_msg=k)


def test_traced_gbuffer_matches_jax(gbuffers):
    """Against JAX's raytrace_gbuffer: hit masks equal, planes within
    1e-5 absolute + 1e-5 relative (float32 rounding of the interpolated
    attributes; world positions on the city reach ~10)."""
    g = gbuffers
    tr, tj = g["traced_t"], g["traced_j"]
    np.testing.assert_array_equal(_n(tr["hit"]), np.asarray(tj["hit"]))
    for k in GB_KEYS:
        np.testing.assert_allclose(_n(tr[k]), np.asarray(tj[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_tile_order_round_trips_hit_fields():
    """tile_order / untile_order over every Hit field at a size that pads
    (70 x 130 against 64 x 128 tiles): the per-pixel fields come back
    exactly, integer ids stay int32, and the order is JAX's."""
    rs = np.random.default_rng(5)
    h, w = 70, 130
    planes = {"t": rs.random((h, w)).astype(np.float32),
              "tri": rs.integers(-1, 1 << 20, (h, w)).astype(np.int32),
              "u": rs.random((h, w)).astype(np.float32),
              "v": rs.random((h, w)).astype(np.float32)}
    flat = {k: tiling_t.tile_order(_t(v)) for k, v in planes.items()}
    for k, v in planes.items():
        np.testing.assert_array_equal(
            _n(flat[k]), np.asarray(tiling_j.tile_order(jnp.asarray(v))))
    hit = Hit(**flat).map(lambda x: tiling_t.untile_order(x, h, w))
    for k, v in planes.items():
        got = getattr(hit, k)
        assert got.dtype == _t(v).dtype, k
        np.testing.assert_array_equal(_n(got), v, err_msg=k)


# ---------------------------------------------------------------------------
# world radiance cache
# ---------------------------------------------------------------------------

WRC = dict(grid=(2, 2, 2), probe_res=8, grid_spacing=1.0,
           grid_origin=(-0.5, -0.5, -0.5))


@pytest.fixture(scope="module")
def wrc_runs():
    ts_j, ts_t, _, _ = scene_setup(*SCENES["cornell"])
    cj, ct = wrc_j.WrcConfig(**WRC), wrc_t.WrcConfig(**WRC)
    sky = sky_j.build_sky_env(ts_j.gpu.sun_direction, 32)
    sh = sky_j.project_sh9(sky)
    envs_j = (sky_j.sh9_radiance_fn(sh), sky_j.sh9_irradiance_fn(sh))
    sh_t = _t(sh)
    envs_t = (sky_t.sh9_radiance_fn(sh_t), sky_t.sh9_irradiance_fn(sh_t))
    sj = dict(wrc_j.init_state(cj))
    sj["wrc_atlas"] = sj["wrc_atlas"] + 0.3
    st = {"wrc_atlas": _t(sj["wrc_atlas"])}
    sj = wrc_j.trace_wrc(sj, ts_j, *envs_j, 0, cj)
    st = wrc_t.trace_wrc(st, ts_t, *envs_t, 0, ct)
    return cj, ct, sj, st


def test_wrc_trace(wrc_runs):
    """The probe texels' rays, traced and shaded and blended with the 0.9
    hysteresis: the atlas within 1e-5 on >= 99.5% of its values (a shadow
    ray grazing an edge may resolve differently), 1e-3 on all."""
    _, _, sj, st = wrc_runs
    a, b = np.asarray(sj["wrc_atlas"]), _n(st["wrc_atlas"])
    assert a.shape == b.shape == (8, 8, 8, 3)
    d = np.abs(a - b)
    assert (d <= 1e-5).mean() >= 0.995 and d.max() <= 1e-3, d.max()
    assert b.max() > 0.3       # the ceiling light is visible somewhere


def test_wrc_lookup_rounding(wrc_runs):
    """lookup on points spread over and beyond the grid, on cell centres,
    and on the half-way planes between probes, where round-half-to-even
    decides the probe (`jnp.round` and `torch.round` both), along random
    and axis directions: the same probe texels, so exactly JAX's values."""
    cj, ct, sj, st = wrc_runs
    rs = np.random.default_rng(9)
    p_rand = rs.uniform(-2.0, 2.0, (512, 3))
    k = np.arange(-2, 4)
    halves = np.stack(np.meshgrid(k - 0.5, k - 0.5, k - 0.5), -1)
    centres = np.stack(np.meshgrid(k, k, k), -1)
    pos = np.concatenate([p_rand, halves.reshape(-1, 3),
                          centres.reshape(-1, 3)]).astype(np.float32)
    d = rs.normal(size=(pos.shape[0], 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:6] = np.eye(3)[[0, 1, 2, 0, 1, 2]] * np.array([1, 1, 1, -1, -1, -1])[
        :, None]
    d = d.astype(np.float32)
    a = np.asarray(wrc_j.lookup(sj, cj, jnp.asarray(pos), jnp.asarray(d)))
    b = _n(wrc_t.lookup(st, ct, _t(pos), _t(d)))
    np.testing.assert_array_equal(b, a)
    # and from the JAX atlas itself: the index math alone
    b2 = _n(wrc_t.lookup({"wrc_atlas": _t(sj["wrc_atlas"])}, ct, _t(pos),
                         _t(d)))
    np.testing.assert_array_equal(b2, a)


def test_wrc_see_through():
    """The debug raymarch of the probe field against JAX's, on a constant
    atlas: within 1e-6."""
    cj, ct = wrc_j.WrcConfig(grid=(2, 2, 2), probe_res=8), \
        wrc_t.WrcConfig(grid=(2, 2, 2), probe_res=8)
    rs = np.random.default_rng(2)
    atlas = rs.random((8, 8, 8, 3)).astype(np.float32)
    org = rs.normal(size=(16, 3)).astype(np.float32)
    d = rs.normal(size=(16, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    a = wrc_j.see_through({"wrc_atlas": jnp.asarray(atlas)}, cj,
                          jnp.asarray(org), jnp.asarray(d))
    b = wrc_t.see_through({"wrc_atlas": _t(atlas)}, ct, _t(org), _t(d))
    np.testing.assert_allclose(_n(b), np.asarray(a), atol=1e-6)


# ---------------------------------------------------------------------------
# depth of field
# ---------------------------------------------------------------------------

def test_dof_gather():
    """CoC and the 12-tap golden-angle gather on a seeded colour image and a
    depth ramp with a sky patch: CoC within 1e-5 px, the blur within 1e-5
    (float32 rounding of the tap offsets and of the bilinear weights)."""
    rs = np.random.default_rng(4)
    color = rs.random((H, W, 3)).astype(np.float32) * 4.0
    vz = np.linspace(0.5, 6.0, W, dtype=np.float32)[None, :] * np.ones(
        (H, 1), np.float32)
    depth = 0.01 / vz
    depth[:8, :16] = 0.0
    coc_j = dof_j.circle_of_confusion(jnp.asarray(depth), 2.0, 4.0)
    coc_t = dof_t.circle_of_confusion(_t(depth), 2.0, 4.0)
    np.testing.assert_allclose(_n(coc_t), np.asarray(coc_j), atol=1e-5)
    a = dof_j.dof_gather(jnp.asarray(color), jnp.asarray(depth), 2.0, 4.0)
    b = dof_t.dof_gather(_t(color), _t(depth), 2.0, 4.0)
    np.testing.assert_allclose(_n(b), np.asarray(a), atol=1e-5)
    assert np.abs(_n(b) - color).max() > 0.1      # it blurred


# ---------------------------------------------------------------------------
# IBL sky
# ---------------------------------------------------------------------------

def _rle_scanline(row):
    """New-style RLE encoding of one (W, 4) uint8 scanline: runs of equal
    bytes as (128 + n, byte), the rest as literal (n, bytes...)."""
    out = bytearray([2, 2, row.shape[0] >> 8, row.shape[0] & 255])
    for c in range(4):
        ch = row[:, c]
        x = 0
        while x < len(ch):
            run = 1
            while x + run < len(ch) and run < 127 and ch[x + run] == ch[x]:
                run += 1
            if run >= 3:
                out += bytes([128 + run, ch[x]])
                x += run
            else:
                n = min(128, len(ch) - x)
                out += bytes([n]) + ch[x:x + n].tobytes()
                x += n
    return bytes(out)


def _panorama(h=16, w=32):
    rs = np.random.default_rng(6)
    rgbe = rs.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rs.integers(120, 140, (h, w))
    rgbe[2, :, :] = 77                      # runs for the RLE path
    rgbe[5, 3:20, 3] = 0                    # exponent 0 = black
    return rgbe


@pytest.mark.parametrize("encoding", ["flat", "rle"])
def test_hdr_decoder(tmp_path, encoding):
    """The port's RGBE decoder (a copy of the JAX module's) on a panorama
    the test writes, flat and RLE scanlines: exactly JAX's decode."""
    rgbe = _panorama()
    h, w = rgbe.shape[:2]
    body = (rgbe.tobytes() if encoding == "flat"
            else b"".join(_rle_scanline(rgbe[y]) for y in range(h)))
    p = tmp_path / "pano.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                  + f"-Y {h} +X {w}\n".encode() + body)
    a, b = ibl_j.load_hdr(str(p)), ibl_t.load_hdr(str(p))
    assert b.shape == (h, w, 3) and b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    assert (b[5, 3:20] == 0.0).all()


def test_hdr_writer_round_trip(tmp_path):
    """write_hdr then load_hdr: within 1/128 of each pixel's largest
    channel (8-bit mantissas under a shared exponent); zero stays zero."""
    rs = np.random.default_rng(8)
    img = (rs.random((12, 20, 3)) * np.logspace(-3, 3, 20)[None, :, None]
           ).astype(np.float32)
    img[0, 0] = 0.0
    p = str(tmp_path / "w.hdr")
    ibl_t.write_hdr(p, img)
    back = ibl_t.load_hdr(p)
    err = np.abs(back - img).max(-1) / np.maximum(img.max(-1), 1e-30)
    assert err.max() <= 1.0 / 128, err.max()
    assert (back[0, 0] == 0.0).all()
    q = tmp_path / "not.hdr"
    q.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError):
        ibl_t.load_hdr(str(q))


@pytest.mark.parametrize("rotation", [0.0, 37.0])
def test_panorama_to_env_and_load_ibl_env(tmp_path, rotation):
    """The octahedral resampling (nearest panorama texel per env texel) and
    the loader: exactly JAX's env map, on the device asked for."""
    rgbe = _panorama()
    h, w = rgbe.shape[:2]
    p = tmp_path / "pano.hdr"
    p.write_bytes(b"#?RADIANCE\n\n" + f"-Y {h} +X {w}\n".encode()
                  + rgbe.tobytes())
    pano = ibl_t.load_hdr(str(p))
    a = np.asarray(ibl_j.panorama_to_env(pano, res=16,
                                         rotation_deg=rotation))
    b = ibl_t.panorama_to_env(pano, res=16, rotation_deg=rotation,
                              device="cpu")
    assert b.device.type == "cpu" and tuple(b.shape) == (16, 16, 3)
    np.testing.assert_array_equal(_n(b), a)
    env = ibl_t.load_ibl_env(str(p), rotation_deg=rotation, device="cpu")
    np.testing.assert_array_equal(
        _n(env), np.asarray(ibl_j.load_ibl_env(str(p),
                                               rotation_deg=rotation)))
    assert tuple(env.shape) == (sky_t.SKY_RES, sky_t.SKY_RES, 3)


def test_load_exr_without_reader_raises(tmp_path, monkeypatch):
    """Where no EXR reader is installed (the card's machine has none) the
    loader says so."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(RuntimeError, match="no EXR reader"):
        ibl_t.load_ibl_env(str(tmp_path / "sky.exr"), device="cpu")


def test_check_supported_refuses_nothing():
    for kw in ({}, {"use_wrc": True}, {"use_dof": True},
               {"primary": "trace"}, {"temporal_upsampling": 2.0}):
        check_supported(RenderConfig(**kw), ibl_env=torch.zeros(4, 4, 3))
