"""Port parity, the numerics under the diffuse-GI frame: RNG draws, sampling
primitives, phase split / weave, sorted ray wavefronts, reservoir updates,
emissive-triangle light sampling and the half-res SSAO, each run through the
JAX function and its kajiya_tpu_torch counterpart on the same numpy inputs."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.brdf import sampling as samp_j
from kajiya_tpu.core import img as im_j
from kajiya_tpu.core import rng as rng_j
from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.ops import raysort as rs_j
from kajiya_tpu.ops import reservoir as rsv_j
from kajiya_tpu.ops import woop as woop_j
from kajiya_tpu.renderers import lights as lights_j
from kajiya_tpu.renderers import ssgi as ssgi_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.brdf import sampling as samp_t
from kajiya_tpu_torch.core import img as im_t
from kajiya_tpu_torch.core import rng as rng_t
from kajiya_tpu_torch.ops import raysort as rs_t
from kajiya_tpu_torch.ops import reservoir as rsv_t
from kajiya_tpu_torch.ops import woop as woop_t
from kajiya_tpu_torch.ops import woop_cuda as wc
from kajiya_tpu_torch.renderers import lights as lights_t
from kajiya_tpu_torch.renderers import ssgi as ssgi_t
from kajiya_tpu_torch.rt import trace as trace_t

# Tolerances: RNG draws, sort keys, permutations and pure selections are
# exact; float formulas agree to 1e-6 absolute (float32 rounding of the same
# operations in the same order); reservoir decisions (`take`) must be equal.
ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _u32(n, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


# ----------------------------------------------------------------------------
# RNG draws and sampling primitives
# ----------------------------------------------------------------------------

def test_rand_u01_stream_bit_exact():
    seed = _u32(4096, 3)
    rj, rt = jnp.asarray(seed), _t(seed.astype(np.int64))
    for _ in range(5):
        uj, rj = rng_j.rand_u01(rj)
        ut, rt = rng_t.rand_u01(rt)
        np.testing.assert_array_equal(_n(ut), np.asarray(uj))
        np.testing.assert_array_equal(_n(rt).astype(np.uint32),
                                      np.asarray(rj))
    np.testing.assert_array_equal(
        _n(rng_t.next_rng(_t(seed.astype(np.int64)))).astype(np.uint32),
        np.asarray(rng_j.next_rng(jnp.asarray(seed))))


@pytest.mark.parametrize("fn", ["cosine_hemisphere", "uniform_sphere",
                                "uniform_triangle", "power_heuristic"])
def test_sampling_primitives(fn):
    rng = np.random.default_rng(5)
    u1 = rng.random(4096, dtype=np.float32)
    u2 = rng.random(4096, dtype=np.float32)
    if fn == "power_heuristic":
        u1, u2 = u1 * 10.0, u2 * 10.0
    ref = getattr(samp_j, fn)(jnp.asarray(u1), jnp.asarray(u2))
    got = getattr(samp_t, fn)(_t(u1), _t(u2))
    if fn == "uniform_triangle":
        ref, got = jnp.stack(ref), torch.stack(got)
    np.testing.assert_allclose(_n(got), np.asarray(ref), atol=ATOL)


# ----------------------------------------------------------------------------
# Image helpers of the GI passes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64), (48, 64, 3), (27, 35, 2)])
def test_phase_split_weave_exact(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    pj = im_j.phase_split(jnp.asarray(x))
    pt = im_t.phase_split(_t(x))
    for py in (0, 1):
        for px in (0, 1):
            np.testing.assert_array_equal(_n(pt[py][px]),
                                          np.asarray(pj[py][px]))
    wj = np.asarray(im_j.weave2x2(pj))
    wt = _n(im_t.weave2x2(pt))
    np.testing.assert_array_equal(wt, wj)
    h, w = shape[0] // 2 * 2, shape[1] // 2 * 2
    np.testing.assert_array_equal(wt, x[:h, :w])


@pytest.mark.parametrize("shape", [(135, 67), (135, 67, 3), (48, 64, 4)])
def test_half_res_helpers_on_odd_sizes(shape):
    """540 rows halve to 270 and 135: the helpers must agree on odd extents."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for name in ("downsample_2x", "downsample_nearest", "decimate2",
                 "local_moments_3x3", "minmax_3x3"):
        ref = getattr(im_j, name)(jnp.asarray(x))
        got = getattr(im_t, name)(_t(x))
        if isinstance(ref, tuple):
            ref, got = jnp.stack(ref), torch.stack(got)
        assert tuple(got.shape) == ref.shape, name
        np.testing.assert_allclose(_n(got), np.asarray(ref), atol=ATOL,
                                   err_msg=name)
    ref = im_j.separable_blur(jnp.asarray(x), im_j.GAUSS5)
    got = im_t.separable_blur(_t(x), im_t.GAUSS5)
    np.testing.assert_allclose(_n(got), np.asarray(ref), atol=ATOL)
    offs = [(-3, 2), (0, 0), (1, -1), (200, -200)]
    np.testing.assert_array_equal(
        _n(im_t.shift_stack(_t(x), offs)),
        np.asarray(im_j.shift_stack(jnp.asarray(x), offs)))


def test_warp_nearest_ignores_window_rows():
    x = np.random.default_rng(2).standard_normal((24, 32, 13)).astype(
        np.float32)
    uv = np.random.default_rng(3).random((24, 32, 2), dtype=np.float32)
    a = im_t.warp_nearest(_t(x), _t(uv), window_rows=40)
    b = im_t.warp_nearest(_t(x), _t(uv))
    np.testing.assert_array_equal(_n(a), _n(b))
    np.testing.assert_array_equal(
        _n(a), np.asarray(im_j.sample_nearest(jnp.asarray(x),
                                              jnp.asarray(uv))))


# ----------------------------------------------------------------------------
# Sorted wavefronts
# ----------------------------------------------------------------------------

def _rays(n, seed=3, lo=-5.0, hi=5.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


@pytest.mark.parametrize("bits", [(5, 3), (3, 2)])
def test_ray_sort_key_exact(bits):
    org, d = _rays(8192, seed=4, lo=-6.0, hi=6.0)
    smin = np.full(3, -5.0, np.float32)
    smax = np.array([5.0, 4.0, 6.0], np.float32)
    ref = np.asarray(rs_j.ray_sort_key(jnp.asarray(org), jnp.asarray(d),
                                       jnp.asarray(smin), jnp.asarray(smax),
                                       *bits))
    got = _n(rs_t.ray_sort_key(_t(org), _t(d), _t(smin), _t(smax), *bits))
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert got.max() < 1 << 24


def test_sorted_trace_is_a_pure_permutation():
    """Per-ray outputs come back in the caller's order, with integer and
    bool payloads exact at any magnitude, and the rays reach the trace
    function in the order JAX's sort gives them."""
    n = 3000
    org, d = _rays(n, seed=7)
    woop_np = {"cmin64": np.array([[-5.0, -5, -5]], np.float32),
               "cmax64": np.array([[5.0, 5, 5]], np.float32)}
    big = np.arange(n, dtype=np.int32) * 7919 + (1 << 24) + 3
    tmax = np.random.default_rng(8).random(n, dtype=np.float32) * 9
    seen = {}

    def fn_t(o, dd, tm):
        seen["t"] = _n(o)
        idx = torch.argmin(torch.abs(o[:, None, 0] - _t(org)[None, :, 0]),
                           dim=1)
        return (o * dd).sum(-1), _t(big)[idx], idx % 2 == 0, tm

    def fn_j(o, dd, tm):
        seen["j"] = np.asarray(o)
        return ((o * dd).sum(-1),)

    outs = rs_t.sorted_trace(fn_t, {k: _t(v) for k, v in woop_np.items()},
                             _t(org), _t(d), t_max=_t(tmax))
    rs_j.sorted_trace(fn_j, {k: jnp.asarray(v) for k, v in woop_np.items()},
                      jnp.asarray(org), jnp.asarray(d))
    np.testing.assert_array_equal(seen["t"], seen["j"])
    np.testing.assert_array_equal(_n(outs[0]), (org * d).sum(-1))
    np.testing.assert_array_equal(_n(outs[1]), big)
    np.testing.assert_array_equal(_n(outs[2]), np.arange(n) % 2 == 0)
    np.testing.assert_array_equal(_n(outs[3]), tmax)
    assert outs[1].dtype == torch.int32 and outs[2].dtype == torch.bool


def _clustered_scene(n_tri=700, seed=11):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (n_tri, 3)).astype(np.float32)
    pad = -(-n_tri // 256) * 256
    wj = woop_j.build_woop(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                           pad_to=pad)
    wt = woop_t.build_woop(_t(v0), _t(e1), _t(e2), pad_to=pad)
    for key, tb in (("", 256), ("64", wc.CULL_TB)):
        wt["cmin" + key], wt["cmax" + key] = woop_t.build_clusters(
            _t(v0), _t(e1), _t(e2), pad_to=pad, tri_block=tb)
    return wj, types.SimpleNamespace(woop=wt)


@pytest.mark.parametrize("any_hit", [False, True])
def test_scene_trace_sorted_equals_unsorted(any_hit):
    """sort=True through the dispatch (culled plain version, 128-ray chunks
    of the sorted batch) returns exactly the unsorted trace's hits, and both
    agree with the JAX brute reference."""
    wj, ts = _clustered_scene()
    org, d = _rays(3000, seed=12)
    assert trace_t._can_sort(ts, True) and not trace_t._can_sort(ts, False)
    ref = woop_j.intersect_brute(wj, jnp.asarray(org), jnp.asarray(d),
                                 any_hit=any_hit)
    if any_hit:
        a = trace_t.scene_trace_shadow(ts, _t(org), _t(d))
        b = trace_t.scene_trace_shadow(ts, _t(org), _t(d), sort=True)
        np.testing.assert_array_equal(_n(a), _n(b))
        np.testing.assert_array_equal(_n(b), np.asarray(ref[1]) >= 0)
        return
    a = trace_t.scene_trace_closest(ts, _t(org), _t(d))
    b = trace_t.scene_trace_closest(ts, _t(org), _t(d), sort=True)
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(_n(getattr(a, f)), _n(getattr(b, f)),
                                      err_msg=f)
    assert b.tri.dtype == torch.int32
    hit = np.asarray(ref[1]) >= 0
    np.testing.assert_array_equal(_n(b.tri) >= 0, hit)
    np.testing.assert_allclose(_n(b.t)[hit], np.asarray(ref[0])[hit],
                               rtol=2e-5, atol=2e-5)
    assert (_n(b.tri)[hit] == np.asarray(ref[1])[hit]).mean() >= 0.999


def test_brute_scene_never_sorts():
    ts = types.SimpleNamespace(woop={"a_o": None, "a_d": None})
    assert not trace_t._can_sort(ts, True)


# ----------------------------------------------------------------------------
# Reservoirs
# ----------------------------------------------------------------------------

def _reservoir(shape, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(shape + s, dtype=np.float32)   # noqa: E731
    m = np.floor(f() * 30).astype(np.float32)
    p_hat = f() * (f() > 0.2)
    w_sum = f() * 3 * (m > 0)
    res = {"payload": {"radiance": f(3), "hit": f(3) * 4 - 2,
                       "hitn": f(3) * 2 - 1},
           "w_sum": w_sum, "M": m, "p_hat": p_hat}
    denom = m * p_hat
    res["W"] = np.where(denom > 1e-8, w_sum / np.maximum(denom, 1e-8),
                        0.0).astype(np.float32)
    return res


def _both(res):
    to_j = lambda d: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in d.items()}                 # noqa: E731
    to_t = lambda d: {k: to_t(v) if isinstance(v, dict) else _t(v)
                      for k, v in d.items()}                 # noqa: E731
    return to_j(res), to_t(res)


def _assert_reservoir(rj, rt):
    for k in ("w_sum", "M", "W", "p_hat"):
        np.testing.assert_allclose(_n(rt[k]), np.asarray(rj[k]), atol=ATOL,
                                   rtol=ATOL, err_msg=k)
    # equal `take` decisions: the selected payload is the same sample
    for k in rj["payload"]:
        np.testing.assert_array_equal(_n(rt["payload"][k]),
                                      np.asarray(rj["payload"][k]), err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_reservoir_update(masked):
    shape = (24, 32)
    res = _reservoir(shape, 0)
    rng = np.random.default_rng(1)
    payload = {k: rng.random(shape + (3,), dtype=np.float32)
               for k in ("radiance", "hit", "hitn")}
    w = rng.random(shape, dtype=np.float32) * 2 - 0.2
    p_hat = rng.random(shape, dtype=np.float32)
    u = rng.random(shape, dtype=np.float32)
    mask = rng.random(shape) > 0.3 if masked else None
    rj, rt = _both(res)
    pj, pt = _both(payload)
    out_j = rsv_j.update(rj, pj, jnp.asarray(w), jnp.asarray(p_hat),
                         jnp.asarray(u),
                         mask=None if mask is None else jnp.asarray(mask))
    out_t = rsv_t.update(rt, pt, _t(w), _t(p_hat), _t(u),
                         mask=None if mask is None else _t(mask))
    _assert_reservoir(out_j, out_t)


@pytest.mark.parametrize("variant", ["plain", "mask_scale", "m_clamp"])
def test_reservoir_merge(variant):
    shape = (24, 32)
    rj, rt = _both(_reservoir(shape, 2))
    oj, ot = _both(_reservoir(shape, 3))
    rng = np.random.default_rng(4)
    p_here = rng.random(shape, dtype=np.float32)
    u = rng.random(shape, dtype=np.float32)
    kw_j, kw_t = {}, {}
    if variant == "mask_scale":
        mask = rng.random(shape) > 0.4
        jac = rng.random(shape, dtype=np.float32) * 8
        kw_j = dict(mask=jnp.asarray(mask), w_scale=jnp.asarray(jac))
        kw_t = dict(mask=_t(mask), w_scale=_t(jac))
    elif variant == "m_clamp":
        kw_j = kw_t = dict(m_clamp=10.0)
    out_j = rsv_j.merge(rj, oj, jnp.asarray(p_here), jnp.asarray(u), **kw_j)
    out_t = rsv_t.merge(rt, ot, _t(p_here), _t(u), **kw_t)
    _assert_reservoir(out_j, out_t)


def test_reservoir_init_and_clamp_m():
    shape = (24, 32)
    rj, rt = _both(_reservoir(shape, 5))
    _assert_reservoir(rsv_j.clamp_m(rj, 20.0), rsv_t.clamp_m(rt, 20.0))
    zero = {"radiance": np.zeros(shape + (3,), np.float32)}
    ij = rsv_j.init(shape, {"radiance": jnp.asarray(zero["radiance"])})
    it = rsv_t.init(shape, {"radiance": _t(zero["radiance"])})
    assert set(ij) == set(it)
    for k in ("w_sum", "M", "W", "p_hat"):
        np.testing.assert_array_equal(_n(it[k]), np.asarray(ij[k]))


# ----------------------------------------------------------------------------
# Emissive-triangle lights
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    from kajiya_tpu.scene.procedural import cornell_box
    from kajiya_tpu.scene.scene import build_gpu_scene
    from kajiya_tpu.world import build_trace_scene

    ts_j, _ = build_trace_scene(build_gpu_scene(cornell_box()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    return ts_j, ts_t


def test_sample_triangle_light(cornell):
    ts_j, ts_t = cornell
    assert int(ts_t.gpu.num_lights) > 0
    rng = np.random.default_rng(6)
    pos = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    seed = _u32(4096, 7)
    lj, rj = lights_j.sample_triangle_light(ts_j, jnp.asarray(pos),
                                            jnp.asarray(seed))
    lt, rt = lights_t.sample_triangle_light(ts_t, _t(pos),
                                            _t(seed.astype(np.int64)))
    np.testing.assert_array_equal(_n(rt).astype(np.uint32), np.asarray(rj))
    np.testing.assert_array_equal(_n(lt["valid"]), np.asarray(lj["valid"]))
    for k in ("wi", "dist", "emission"):
        np.testing.assert_allclose(_n(lt[k]), np.asarray(lj[k]), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(_n(lt["pdf_sa"]), np.asarray(lj["pdf_sa"]),
                               rtol=1e-5, err_msg="pdf_sa")


def test_light_pdf_for_hit(cornell):
    from kajiya_tpu.rt.trace import Hit as HitJ

    ts_j, ts_t = cornell
    rng = np.random.default_rng(8)
    n = 512
    tri = rng.integers(-1, 32, n).astype(np.int32)
    t = (rng.random(n, dtype=np.float32) * 3 + 0.1)
    _, wi = _rays(n, seed=9)
    z = np.zeros(n, np.float32)
    ref = lights_j.light_pdf_for_hit(
        ts_j, HitJ(t=jnp.asarray(t), tri=jnp.asarray(tri), u=jnp.asarray(z),
                   v=jnp.asarray(z)), jnp.asarray(wi))
    got = lights_t.light_pdf_for_hit(
        ts_t, trace_t.Hit(t=_t(t), tri=_t(tri), u=_t(z), v=_t(z)), _t(wi))
    assert (np.asarray(ref) > 0).any()
    np.testing.assert_allclose(_n(got), np.asarray(ref), rtol=1e-5, atol=ATOL)


# ----------------------------------------------------------------------------
# SSAO at half res
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("frame_idx", [0, 5])
def test_ssao_half(frame_idx):
    """A synthetic gbuffer (a tilted floor with a step) through both
    ssao_half functions: 1e-6 absolute."""
    h, w = 48, 64
    vj = view_j((0.0, 1.0, 3.0), (0.0, -0.2, -1.0), fov_y_deg=55.0, width=w,
                height=h)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    vz = 2.0 + 0.05 * yy + 0.8 * (xx > 30) + 0.02 * rng.random((h, w))
    depth = (0.01 / vz).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32) * 0.1 + \
        np.array([0.0, 1.0, 0.3], np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    hit = rng.random((h, w)) > 0.05
    gb = {"depth": depth, "normal": normal.astype(np.float32), "hit": hit}
    ref = ssgi_j.ssao_half({k: jnp.asarray(v) for k, v in gb.items()}, vj,
                           frame_idx)
    got = ssgi_t.ssao_half({k: _t(v) for k, v in gb.items()}, vt, frame_idx)
    assert tuple(got.shape) == (h // 2, w // 2)
    assert 0.05 < float(got.mean()) < 0.999
    np.testing.assert_allclose(_n(got), np.asarray(ref), atol=ATOL)
