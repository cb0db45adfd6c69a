"""Port parity, Woop intersectors: the tables, and the plain versions of
kernel B (brute) and kernel C (culled) against the Pallas kernels in
interpret mode and the XLA reference `intersect_brute`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.ops import woop as woop_j
from kajiya_tpu.ops import woop_pallas as wp_j
from kajiya_tpu.rt.bvh import bvh_from_scene
from kajiya_tpu.scene.procedural import cornell_box as cornell_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu_torch.ops import woop as woop_t
from kajiya_tpu_torch.ops import woop_cuda as wc

# Tolerances: tables agree to 1e-6 relative (float32 3x3 inverses through
# different LAPACK paths); hits agree on >= 99.9% of triangle ids (exactly
# coplanar ties may resolve differently) with t within 2e-5; any-hit is
# compared as an occlusion mask.
ID_AGREE = 0.999
T_TOL = 2e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _soup(n_tri, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (n_tri, 3)).astype(np.float32)
    return v0, e1, e2


def _rays(n, seed=1, lo=-12.0, hi=12.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


def _tables(v0, e1, e2, clusters=True):
    n = v0.shape[0]
    pad = -(-n // 256) * 256
    wj = woop_j.build_woop(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                           pad_to=pad)
    wt = woop_t.build_woop(_t(v0), _t(e1), _t(e2), pad_to=pad)
    if clusters:
        for key, tb in (("", 256), ("64", wc.CULL_TB)):
            wj["cmin" + key], wj["cmax" + key] = woop_j.build_clusters(
                jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                pad_to=pad, tri_block=tb)
            wt["cmin" + key], wt["cmax" + key] = woop_t.build_clusters(
                _t(v0), _t(e1), _t(e2), pad_to=pad, tri_block=tb)
    return wj, wt


def _assert_hits(ref, got, tmax_finite=False):
    t_r, tri_r = np.asarray(ref[0]), np.asarray(ref[1])
    t_g, tri_g = _n(got[0]), _n(got[1])
    assert tri_g.dtype == np.int32
    np.testing.assert_array_equal(tri_r >= 0, tri_g >= 0)
    hit = tri_r >= 0
    np.testing.assert_allclose(t_g[hit], t_r[hit], rtol=T_TOL, atol=T_TOL)
    assert (tri_r[hit] == tri_g[hit]).mean() >= ID_AGREE
    assert (t_g[~hit] >= 1e29).all()


def test_woop_tables_match():
    v0, e1, e2 = _soup(700, seed=11)
    wj, wt = _tables(v0, e1, e2)
    assert set(wj) == set(wt)
    for k in wj:
        a, b = np.asarray(wj[k]), _n(wt[k])
        assert a.shape == b.shape, k
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            scale = np.abs(a).max()
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)


def _cornell_woop():
    gpu = build_gpu_j(cornell_j())
    _, _, (v0, e1, e2) = bvh_from_scene(gpu)
    v0, e1, e2 = (np.asarray(x) for x in (v0, e1, e2))
    n = v0.shape[0]
    pad = max(8, -(-n // 8) * 8)
    wj = woop_j.build_woop(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                           pad_to=pad)
    return wj, {k: _t(np.asarray(v)) for k, v in wj.items()}


@pytest.mark.parametrize("case", ["closest", "t_max", "any_hit"])
def test_brute_plain_matches_pallas_and_xla(case):
    wj, wt = _cornell_woop()
    org, d = _rays(2048, seed=2, lo=-0.9, hi=0.9)
    kw = {}
    if case == "t_max":
        kw["t_max"] = np.random.default_rng(3).uniform(
            0.05, 1.5, 2048).astype(np.float32)
    any_hit = case == "any_hit"
    ref_p = wp_j.intersect_brute_pallas(
        wj, jnp.asarray(org), jnp.asarray(d), any_hit=any_hit, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    ref_x = woop_j.intersect_brute(wj, jnp.asarray(org), jnp.asarray(d),
                                   any_hit=any_hit,
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
    got = wc.intersect_brute_cuda(wt, _t(org), _t(d), any_hit=any_hit,
                                  **{k: _t(v) for k, v in kw.items()})
    if any_hit:
        occ = _n(got[1]) >= 0
        np.testing.assert_array_equal(occ, np.asarray(ref_p[1]) >= 0)
        np.testing.assert_array_equal(occ, np.asarray(ref_x[1]) >= 0)
        return
    _assert_hits(ref_p, got)
    _assert_hits(ref_x, got)
    # the dense reference in ops/woop.py is the same plain math
    ref_t = woop_t.intersect_brute(wt, _t(org), _t(d),
                                   t_max=_t(kw["t_max"]) if kw else None)
    for a, b in zip(ref_t, got):
        np.testing.assert_array_equal(_n(a), _n(b))


def test_brute_plain_exact_t_max_and_axis_rays():
    wj, wt = _cornell_woop()
    org = np.zeros((8, 3), np.float32)
    d = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (8, 1))
    _, tri, _, _ = wc.intersect_brute_cuda(wt, _t(org), _t(d), t_max=0.5)
    assert (_n(tri) == -1).all()
    t, tri, _, _ = wc.intersect_brute_cuda(wt, _t(org), _t(d))
    assert (_n(tri) >= 0).all()
    np.testing.assert_allclose(_n(t), 1.0, rtol=1e-4)


def _culled_case(case):
    if case == "divergent":
        def wall(x, n=16, half=20.0):
            ys = np.linspace(-half, half, n + 1)
            v0, e1, e2 = [], [], []
            for i in range(n):
                for j in range(n):
                    a = np.array([x, ys[i], ys[j]])
                    b = np.array([x, ys[i + 1], ys[j]])
                    c = np.array([x, ys[i], ys[j + 1]])
                    dd = np.array([x, ys[i + 1], ys[j + 1]])
                    v0 += [a, dd]
                    e1 += [b - a, b - dd]
                    e2 += [c - a, c - dd]
            return [np.asarray(q, np.float32) for q in (v0, e1, e2)]
        w1, w2 = wall(5.0), wall(-5.0)
        tris = [np.concatenate([a, b]) for a, b in zip(w1, w2)]
        rng = np.random.default_rng(7)
        org = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
        d = np.zeros((2048, 3), np.float32)
        d[:1800, 0], d[1800:, 0] = 1.0, -1.0
        d += rng.normal(0, 0.02, d.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return tris, org, d, None
    seed = {"closest": 0, "any_hit": 3, "t_max": 5}[case]
    tris = _soup({"closest": 1000, "any_hit": 600, "t_max": 400}[case],
                 seed=seed)
    org, d = _rays(4096 if case == "closest" else 2048, seed=seed + 1)
    tmax = np.full((org.shape[0],), 4.0, np.float32) if case == "t_max" \
        else None
    return tris, org, d, tmax


@pytest.mark.parametrize("case", ["closest", "any_hit", "t_max", "divergent"])
def test_culled_plain_matches_pallas_interpret(case):
    (v0, e1, e2), org, d, tmax = _culled_case(case)
    wj, wt = _tables(v0, e1, e2)
    any_hit = case == "any_hit"
    kj = {} if tmax is None else {"t_max": jnp.asarray(tmax)}
    kt = {} if tmax is None else {"t_max": _t(tmax)}
    ref = wp_j.intersect_culled_pallas(wj, jnp.asarray(org), jnp.asarray(d),
                                       any_hit=any_hit, interpret=True, **kj)
    got = wc.intersect_culled_cuda(wt, _t(org), _t(d), any_hit=any_hit, **kt)
    brute = woop_j.intersect_brute(wj, jnp.asarray(org), jnp.asarray(d),
                                   any_hit=any_hit, **kj)
    if any_hit:
        occ = _n(got[1]) >= 0
        np.testing.assert_array_equal(occ, np.asarray(ref[1]) >= 0)
        np.testing.assert_array_equal(occ, np.asarray(brute[1]) >= 0)
        return
    _assert_hits(ref, got)
    _assert_hits(brute, got)
    if case == "divergent":
        assert (_n(got[1]) >= 0).all()


def test_culled_plain_with_caller_block_lists():
    """Caller-given lists (as the rasterizer passes) replace the beam cull:
    every block listed for every chunk, in index order, finds the brute
    hits; a list that leaves out the hit blocks finds nothing."""
    v0, e1, e2 = _soup(1000, seed=21)
    wj, wt = _tables(v0, e1, e2)
    org, d = _rays(1024, seed=22)
    nrb = 1024 // wc.CULL_RAY_BLOCK
    nt = wt["a_d"].shape[0] // 3 // wc.CULL_TB
    hit = np.ones((nrb, nt), bool)
    dlb = np.zeros((nrb, nt), np.float32)
    lists_j = wp_j.sort_blocks_by_distance(jnp.asarray(hit), jnp.asarray(dlb))
    lists_t = wc.sort_blocks_by_distance(_t(hit), _t(dlb))
    for a, b in zip(lists_j, lists_t):
        np.testing.assert_array_equal(_n(b), np.asarray(a))
    ref = wp_j.intersect_culled_pallas(wj, jnp.asarray(org), jnp.asarray(d),
                                       block_lists=lists_j, interpret=True)
    got = wc.intersect_culled_cuda(wt, _t(org), _t(d), block_lists=lists_t)
    _assert_hits(ref, got)
    empty = wc.sort_blocks_by_distance(_t(np.zeros((nrb, nt), bool)), _t(dlb))
    _, tri, _, _ = wc.intersect_culled_cuda(wt, _t(org), _t(d),
                                            block_lists=empty)
    assert (_n(tri) == -1).all()


def test_culled_plain_step_size_and_visit_counts():
    """The plain version of kernel C gives the same rows whatever number of
    chunks it walks side by side, and its per-chunk visit counts (the work
    chip_smoke.py charges the kernel with) never exceed the listed blocks
    and shrink under early stop."""
    v0, e1, e2 = _soup(800, seed=31)
    _, wt = _tables(v0, e1, e2)
    org, d = _rays(4096, seed=32)
    b = wc.prepare_culled(wt, _t(org), _t(d))
    walked, walked_all = [], []
    full = wc.culled_plain(b, 1e-4, False, True, visits=walked)
    step = wc.culled_plain(b, 1e-4, False, True, chunks_per_step=3)
    for a, p in zip(full, step):
        np.testing.assert_array_equal(_n(a), _n(p))
    wc.culled_plain(b, 1e-4, False, False, visits=walked_all)
    walked, walked_all = torch.cat(walked), torch.cat(walked_all)
    assert walked.shape == (b.n_chunks,)
    np.testing.assert_array_equal(_n(walked_all), _n(b.count).astype(np.int64))
    assert (walked <= walked_all).all() and (walked >= 1).all()
