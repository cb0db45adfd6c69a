"""Port parity, the reference path tracer on cornell (brute kernel path,
emissive-triangle NEE): the layered BRDF's sampling and pdf, `path_trace`
per path over 5 bounces and statistically over 16, `render_frame_reference`
over 4 frames, the dead-lane skip against tracing every lane, and the port's
own furnace and NEE-vs-BRDF checks (`tests/test_reference_pt.py`).

The JAX tracer runs as written: its bounce loop is a `lax.scan`, whose body
XLA compiles even outside `jit` (`jax.disable_jit()` does not run it: the
atmosphere's `fori_loop` body then gets a Python int). The port's RNG
streams are bit-exact, so paths stay paired lane by lane; what differs is
float32 rounding of the same math. The clustered city runs in
test_torch_reference_pt_city.py, so the two land on different workers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.brdf import ggx as ggx_j
from kajiya_tpu.core import camera as cam_j
from kajiya_tpu.core import rng as rng_j
from kajiya_tpu.frame import RenderConfig as CfgJ
from kajiya_tpu.frame import init_reference_state as init_ref_j
from kajiya_tpu.frame import render_frame_reference as render_ref_j
from kajiya_tpu.renderers import reference as ref_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.brdf import ggx as ggx_t
from kajiya_tpu_torch.core import camera as cam_t
from kajiya_tpu_torch.core import rng as rng_t
from kajiya_tpu_torch.frame import RenderConfig as CfgT
from kajiya_tpu_torch.frame import init_reference_state as init_ref_t
from kajiya_tpu_torch.frame import render_frame_reference as render_ref_t
from kajiya_tpu_torch.renderers import reference as ref_t
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.mesh import Material, PackedMesh
from kajiya_tpu_torch.scene.scene import Scene, build_gpu_scene
from kajiya_tpu_torch.world import build_trace_scene

W, H = 64, 48
CORNELL = (lambda: proc_j.cornell_box(), (0.0, 0.0, 2.4), (0.0, 0.0, -1.0))

# Per-path tolerance: a pixel agrees when every channel is within 1e-4 of
# JAX's, relative to max(1, |value|) (the emitter seen directly is 20);
# >= 99.5% of the pixels must agree and every pixel within 1e-2. Measured
# on cornell: all pixels within 1e-4 at 5 and at 16 bounces; on the city
# 99.97% (one ulp of a hit distance moves the next bounce's origin).
PATH_TOL, PATH_FRAC, PATH_MAX = 1e-4, 0.995, 1e-2


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def scenes_for(make):
    ts_j, _ = build_ts_j(build_gpu_j(make()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    return ts_j, ts_t


def primary_rays(eye, fwd, w=W, h=H):
    v = cam_j.make_view_constants(eye, fwd, fov_y_deg=55.0, width=w,
                                  height=h)
    org, d = cam_j.camera_rays(v, w, h)
    return np.asarray(org).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def seeds(n_px, frame, stream=0):
    return np.asarray(rng_j.hash3(jnp.arange(n_px, dtype=jnp.uint32),
                                  jnp.uint32(frame), jnp.uint32(stream)))


def trace_both(ts_j, ts_t, org, d, seed, **kw):
    rj = np.asarray(ref_j.path_trace(ts_j, jnp.asarray(org), jnp.asarray(d),
                                     jnp.asarray(seed), **kw))
    rt = _n(ref_t.path_trace(ts_t, torch.as_tensor(org), torch.as_tensor(d),
                             torch.as_tensor(seed.astype(np.int64)), **kw))
    return rj, rt


def assert_paths_agree(rj, rt, name):
    assert rj.shape == rt.shape, name
    assert np.isfinite(rt).all(), name
    err = (np.abs(rt - rj) / np.maximum(1.0, np.abs(rj))).max(-1)
    frac = (err <= PATH_TOL).mean()
    assert frac >= PATH_FRAC and err.max() <= PATH_MAX, (name, frac,
                                                         err.max())


def assert_statistics_agree(rj, rt, rt_other, name):
    """Two accumulated images of the same paths: the mean of each channel
    within 1% of the tracer's own noise level, and the RMSE between the two
    below 1/10 of the RMSE between the port's image and the port's image
    from an independent seed set at the same spp (the noise of the
    difference of two renders)."""
    noise = float(np.sqrt(np.mean((rt - rt_other) ** 2)))
    assert noise > 0.0, name
    rmse = float(np.sqrt(np.mean((rt - rj) ** 2)))
    assert rmse <= 0.1 * noise, (name, rmse, noise)
    dmean = np.abs(rt.reshape(-1, 3).mean(0) - rj.reshape(-1, 3).mean(0))
    assert (dmean <= 0.01 * noise).all(), (name, dmean, noise)


# ---------------------------------------------------------------------------
# the layered BRDF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rough,metal", [(0.0, 0.0), (0.05, 1.0),
                                         (0.4, 0.5), (1.0, 0.0)])
def test_layered_sample_and_pdf(rough, metal):
    """sample_layered and pdf_layered on seeded normals, views, colours and
    uniforms. Directions within 1e-6 on >= 99.5% of the lanes and 1e-4 on
    all (the VNDF rim caveat of test_torch_rtr.py::test_vndf_sample_and_pdf:
    where u1 -> 1 an ulp of sin / cos becomes ~1e-5 of the direction).
    Pdf and value relative 1e-5, and 0.25 on all lanes: near a glossy peak
    1 - n.h is a few ulps, so D moves by up to ~10%. At each package's own
    sampled directions, which differ by those ulps, on >= 97% of the lanes
    (measured 97.7% at roughness 0.05 metal, >= 99.7% on the others); at
    the same directions (pdf_layered alone) on >= 99%."""
    rs = np.random.default_rng(int(rough * 100 + metal * 7))
    n = rs.normal(size=(4096, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wo = rs.normal(size=(4096, 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    bc = rs.random((4096, 3))
    args = [x.astype(np.float32) for x in (
        bc, np.full(4096, metal), np.full(4096, rough), n, wo,
        rs.random(4096), rs.random(4096), rs.random(4096))]
    wi_j, pdf_j, f_j = map(np.asarray,
                           ggx_j.sample_layered(*map(jnp.asarray, args)))
    wi_t, pdf_t, f_t = map(_n, ggx_t.sample_layered(*map(torch.as_tensor,
                                                         args)))
    err = np.abs(wi_t - wi_j).max(-1)
    assert (err <= 1e-6).mean() >= 0.995 and err.max() <= 1e-4, err.max()
    for a, b, name in ((pdf_t, pdf_j, "pdf"), (f_t, f_j, "value")):
        rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).reshape(4096, -1)
        rel = rel.max(-1)
        assert (rel <= 1e-5).mean() >= 0.97 and rel.max() <= 0.25, (
            name, rel.max())
    assert ((pdf_t > 0) == (pdf_j > 0)).mean() >= 0.999
    # the pdf alone, at JAX's sampled directions
    p_args = args[:5] + [np.array(wi_j)]
    pj = np.asarray(ggx_j.pdf_layered(*map(jnp.asarray, p_args)))
    pt = _n(ggx_t.pdf_layered(*map(torch.as_tensor, p_args)))
    rel = np.abs(pt - pj) / np.maximum(pj, 1e-6)
    assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 0.25, rel.max()


def test_camera_rays_pixel_jitter():
    """camera_rays with per-pixel offsets: within 1e-6 of JAX's."""
    jit = np.random.default_rng(3).normal(size=(H, W, 2)).astype(np.float32)
    vj = cam_j.make_view_constants((0.1, 0.2, 2.4), (0.0, -0.1, -1.0),
                                   width=W, height=H, jitter=(0.25, -0.1))
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    for a, b in zip(cam_j.camera_rays(vj, W, H, jitter_px=jnp.asarray(jit)),
                    cam_t.camera_rays(vt, W, H,
                                      jitter_px=torch.as_tensor(jit))):
        np.testing.assert_allclose(_n(b), np.asarray(a), atol=1e-6)


# ---------------------------------------------------------------------------
# path_trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    return scenes_for(CORNELL[0])


def test_path_trace_per_path(cornell):
    """5 bounces (russian roulette from bounce 3), one path a pixel."""
    org, d = primary_rays(*CORNELL[1:])
    rj, rt = trace_both(*cornell, org, d, seeds(W * H, 3), num_bounces=5)
    assert_paths_agree(rj, rt, "cornell/5")


def test_path_trace_16_bounces_statistics(cornell):
    """16 bounces, 2 samples a pixel through the gaussian pixel filter
    (render_sample), accumulated by both tracers."""
    ts_j, ts_t = cornell
    vj = cam_j.make_view_constants(*CORNELL[1:], fov_y_deg=55.0, width=W,
                                   height=H)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    rj = np.asarray(ref_j.render_sample(ts_j, vj, W, H, 5, spp_chunk=2))
    rt = _n(ref_t.render_sample(ts_t, vt, W, H, 5, spp_chunk=2))
    rt_other = _n(ref_t.render_sample(ts_t, vt, W, H, 99, spp_chunk=2))
    assert_paths_agree(rj.reshape(-1, 3), rt.reshape(-1, 3), "cornell/16")
    assert_statistics_agree(rj, rt, rt_other, "cornell/16")


def test_dead_lanes_skip_changes_nothing(cornell, monkeypatch):
    """The port traces a finished path's lanes, and shadow rays whose light
    cannot count, with t_max = 0. Tracing every lane instead (as the JAX
    tracer does) must give the same bits."""
    _, ts_t = cornell
    org, d = (torch.as_tensor(x) for x in primary_rays(*CORNELL[1:]))
    seed = torch.as_tensor(seeds(W * H, 11).astype(np.int64))
    skip = ref_t.path_trace(ts_t, org, d, seed, num_bounces=16)
    monkeypatch.setattr(ref_t, "_live_tmax", lambda live, t_max: t_max)
    every = ref_t.path_trace(ts_t, org, d, seed, num_bounces=16)
    assert torch.equal(skip, every)


# ---------------------------------------------------------------------------
# render_frame_reference
# ---------------------------------------------------------------------------

def test_render_frame_reference_four_frames(cornell):
    """Four progressive frames (16 bounces, 1 spp, pixel filter on) from
    the same state, JAX's under `jit` as its own tests run it (one compile
    for the four): the sample count exactly, the
    accumulator at the per-path tolerance, the metered exposure within
    1e-5 and `final` within 1e-3 on >= 99% of the pixels."""
    ts_j, ts_t = cornell
    cfg_j, cfg_t = CfgJ(width=W, height=H), CfgT(width=W, height=H)
    vj = cam_j.make_view_constants(*CORNELL[1:], fov_y_deg=55.0, width=W,
                                   height=H)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    sj, st = init_ref_j(cfg_j), init_ref_t(cfg_t, device="cpu")
    assert set(sj) == set(st)
    step_j = jax.jit(lambda s: render_ref_j(ts_j, s, vj, cfg_j))
    for _ in range(4):
        sj, oj = step_j(sj)
        st, ot = render_ref_t(ts_t, st, vt, cfg_t)
    assert float(st["refpt_samples"]) == float(sj["refpt_samples"]) == 4.0
    assert_paths_agree(np.asarray(sj["refpt_accum"]).reshape(-1, 3),
                       _n(st["refpt_accum"]).reshape(-1, 3), "accum")
    np.testing.assert_allclose(_n(st["smoothed_ev"]),
                               np.asarray(sj["smoothed_ev"]), atol=1e-5)
    fd = np.abs(_n(ot["final"]) - np.asarray(oj["final"]))
    assert (fd <= 1e-3).mean() >= 0.99, (fd <= 1e-3).mean()
    assert float(ot["final"].min()) >= 0.0 and float(ot["final"].max()) <= 1.0


def test_accumulate_and_max_spp():
    """accumulate's running mean, and the max_spp clamp of the frame: past
    the cap each new frame keeps weight 1/(max_spp + 1)."""
    a = torch.zeros((2, 2, 3))
    for k, v in enumerate((1.0, 3.0, 5.0)):
        a, n = ref_t.accumulate(a, torch.full((2, 2, 3), v), float(k))
    assert n == 3.0 and torch.allclose(a, torch.full((2, 2, 3), 3.0))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(
        build_ts_j(build_gpu_j(proc_j.cornell_box()))[0]), device="cpu")
    cfg = CfgT(width=8, height=6)
    vt = cam_t.make_view_constants(*CORNELL[1:], width=8, height=6,
                                   device="cpu")
    st = init_ref_t(cfg, device="cpu")
    st["refpt_samples"] = torch.tensor(7.0)
    st2, _ = render_ref_t(ts_t, st, vt, cfg, num_bounces=2, max_spp=3.0)
    assert float(st2["refpt_samples"]) == 4.0


# ---------------------------------------------------------------------------
# the port's own oracle checks (tests/test_reference_pt.py)
# ---------------------------------------------------------------------------

def big_plane_scene(albedo=0.5, roughness=1.0, metallic=0.0):
    """Huge diffuse plane at y=0 (approximates an infinite plane)."""
    s = 5000.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]],
                     np.float32)
    mesh = PackedMesh(
        positions=verts,
        normals=np.tile(np.array([0, 1, 0], np.float32), (4, 1)),
        uvs=np.zeros((4, 2), np.float32),
        tangents=np.tile(np.array([1, 0, 0, 1], np.float32), (4, 1)),
        colors=np.ones((4, 4), np.float32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.uint32),
        material_ids=np.zeros(2, np.uint32),
        materials=[Material(
            base_color=np.array([albedo] * 3 + [1.0], np.float32),
            emissive=np.zeros(3, np.float32),
            metallic=metallic, roughness=roughness)],
    )
    scene = Scene(sun_intensity=0.0)
    scene.add_instance(scene.add_mesh(mesh))
    return scene


def batched_paths(ts, eye, fwd, fov, w, h, spp, stream, **kw):
    """Mean of `spp` paths a pixel (seeds hash3(px, f, stream)), all
    samples traced as one wavefront."""
    v = cam_t.make_view_constants(eye, fwd, fov_y_deg=fov, width=w,
                                  height=h, device="cpu")
    org, d = cam_t.camera_rays(v, w, h)
    n = w * h
    px = torch.arange(n, dtype=torch.int64)
    seed = torch.cat([rng_t.hash3(px, f, stream) for f in range(spp)])
    rad = ref_t.path_trace(ts, org.reshape(-1, 3).repeat(spp, 1),
                           d.reshape(-1, 3).repeat(spp, 1), seed, **kw)
    return _n(rad.reshape(spp, n, 3).mean(0))


def trace_plane(albedo, spp=48, bounces=4, roughness=1.0, metallic=0.0):
    gpu = build_gpu_scene(big_plane_scene(albedo, roughness, metallic),
                          device="cpu")
    ts, _ = build_trace_scene(gpu, device="cpu")
    return batched_paths(
        ts, (0, 3, 0), (0.3, -1, 0.2), 40, 32, 32, spp, 0,
        num_bounces=bounces, sun_nee=False, light_nee=False,
        sky_fn=lambda d: torch.ones(d.shape[:-1] + (3,)))


def test_furnace_diffuse_plane_under_white_sky():
    """A plane of diffuse albedo a under a unit white sky: each mean in the
    physical band [0.96a, a + 0.07] (the layered material adds a ~4%
    dielectric lobe over a*(1-F)), and the difference between two albedos,
    where that lobe cancels, (a2 - a1)(1 - F) within 0.03."""
    means = {a: trace_plane(a).mean() for a in (0.25, 0.75)}
    for a, m in means.items():
        assert 0.96 * a - 0.01 < m < a + 0.07, (a, m)
    assert abs(means[0.75] - means[0.25] - 0.5 * 0.96) < 0.03, means


def test_furnace_rough_metal():
    """Rough metal with base colour 1 under a white sky stays within 10% of
    1 (the multi-scatter compensation keeps it from darkening)."""
    m = trace_plane(1.0, roughness=0.6, metallic=1.0, bounces=6,
                    spp=64).mean()
    assert 0.9 < m < 1.1, m


@pytest.fixture(scope="module")
def cornell_port():
    gpu = build_gpu_scene(proc_t.cornell_box(), device="cpu")
    return build_trace_scene(gpu, device="cpu")[0]


def render_box(ts, spp, **kw):
    black = lambda d: torch.zeros(d.shape[:-1] + (3,))     # noqa: E731
    return batched_paths(ts, (0, 0, 2.9), (0, 0, -1), 45, 32, 32, spp, 7,
                         num_bounces=5, sun_nee=False, sky_fn=black, **kw)


def test_nee_and_brdf_sampling_agree(cornell_port):
    """Emissive-triangle NEE with MIS converges to the image of BRDF
    sampling alone (64 against 512 samples a pixel): means within 8%."""
    m1 = render_box(cornell_port, 64, light_nee=True).mean()
    m2 = render_box(cornell_port, 512, light_nee=False).mean()
    assert abs(m1 - m2) / max(m2, 1e-6) < 0.08, (m1, m2)


def test_light_pixels_brightest_and_finite(cornell_port):
    img = render_box(cornell_port, 8).reshape(32, 32, 3)
    assert np.isfinite(img).all()
    assert img[2:6, 12:20].mean() > 5 * img[16:, :].mean()
