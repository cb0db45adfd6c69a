"""Port parity, the skip-link BVH walk: `kajiya_tpu_torch.rt.trace`'s
`trace_closest` / `trace_shadow` (on CPU tensors, `walk_plain`) against
`kajiya_tpu.rt.trace`'s on the same BVH and rays, and the JAX package's own
brute-force agreement check (tests/test_bvh.py) run against the port.

Tolerance: hit masks and triangle ids equal; t, u and v within
1e-5 * max(1, |value|). The walks visit the same nodes and triangles in the
same order, but XLA evaluates the test's dot products on the CPU in its own
order (measured: t within 1.5 ulp, u and v, whose dot products cancel,
within 5.5e-6); the kernel is held to `walk_plain` bit for bit on the card
(chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kajiya_tpu.rt import bvh as bvh_j
from kajiya_tpu.rt import trace as trace_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu_torch.ops.woop_cuda import INF
from kajiya_tpu_torch.rt import bvh as bvh_t
from kajiya_tpu_torch.rt import trace as trace_t
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
from test_bvh import brute_force_closest

TOL = 1e-5


def scenes(make):
    """(JAX bvh, tris), (port bvh, tris) of the same scene."""
    bj, _, tj = bvh_j.bvh_from_scene(build_gpu_j(make(proc_j)))
    bt, _, tt = bvh_t.bvh_from_scene(build_gpu_t(make(proc_t), device="cpu"))
    return (bj, tj), (bt, tt)


def random_rays(n, seed, extent=3.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d


def assert_hits(hj, ht):
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    assert tri_t.dtype == np.int32
    np.testing.assert_array_equal(tri_t, tri_j)
    for f in ("t", "u", "v"):
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f).numpy()
        assert b.dtype == np.float32
        assert np.all(np.abs(a - b) <= TOL * np.maximum(1.0, np.abs(a))), f


def both(sj, st, org, d, **kw):
    """trace_closest and trace_shadow of both packages on the same rays."""
    kw_t = {k: (torch.as_tensor(np.asarray(v)) if k == "t_max"
                and not np.isscalar(v) else v) for k, v in kw.items()}
    hj = trace_j.trace_closest(*sj, jnp.asarray(org), jnp.asarray(d), **kw)
    ht = trace_t.trace_closest(*st, torch.as_tensor(org), torch.as_tensor(d),
                               **kw_t)
    oj = trace_j.trace_shadow(*sj, jnp.asarray(org), jnp.asarray(d), **kw)
    ot = trace_t.trace_shadow(*st, torch.as_tensor(org), torch.as_tensor(d),
                              **kw_t)
    return hj, ht, np.asarray(oj), ot.numpy()


@pytest.mark.parametrize("n_tris", [1, 7, 64, 500])
def test_random_soup_matches_jax(n_tris):
    sj, st = scenes(lambda p: p.random_tri_soup(n_tris, seed=n_tris))
    org, d = random_rays(512, seed=1)
    hj, ht, oj, ot = both(sj, st, org, d)
    assert_hits(hj, ht)
    np.testing.assert_array_equal(ot, oj)
    if n_tris >= 64:
        assert ht.hit_mask.any() and ot.any()


@pytest.mark.parametrize("n_tris", [1, 7, 64, 500])
def test_agrees_with_brute_force(n_tris):
    """tests/test_bvh.py's agreement check, on the port's walk."""
    _, (bt, tt) = scenes(lambda p: p.random_tri_soup(n_tris, seed=n_tris))
    org, d = random_rays(512, seed=1)
    hit = trace_t.trace_closest(bt, tt, torch.as_tensor(org),
                                torch.as_tensor(d))
    tris_j = tuple(jnp.asarray(x.numpy()) for x in tt)
    bt_, btri = brute_force_closest(tris_j, jnp.asarray(org), jnp.asarray(d))
    miss = btri < 0
    assert np.array_equal(hit.tri.numpy() < 0, miss)
    np.testing.assert_allclose(hit.t.numpy()[~miss], bt_[~miss], rtol=1e-3,
                               atol=1e-4)
    if (~miss).any():
        assert (hit.tri.numpy()[~miss] == btri[~miss]).mean() > 0.99
    occ = trace_t.trace_shadow(bt, tt, torch.as_tensor(org),
                               torch.as_tensor(d)).numpy()
    assert np.array_equal(occ, ~miss)


def test_cornell_axis_rays():
    sj, st = scenes(lambda p: p.cornell_box())
    org = np.zeros((6, 3), np.float32)
    d = np.array([[0, 0, -1], [0, 0, 1], [0, 1, 0], [0, -1, 0], [1, 0, 0],
                  [-1, 0, 0]], np.float32)
    hj, ht, oj, ot = both(sj, st, org, d)
    assert_hits(hj, ht)
    np.testing.assert_array_equal(ot, oj)
    tri, t = ht.tri.numpy(), ht.t.numpy()
    assert tri[1] == -1 and t[1] == np.float32(INF)   # +Z escapes
    assert np.all(tri[[0, 2, 3, 4, 5]] >= 0)
    np.testing.assert_allclose(t[[0, 3, 4, 5]], 1.0, atol=1e-4)
    np.testing.assert_allclose(t[2], 0.995, atol=1e-4)    # the light quad


def test_single_triangle_t_max_and_barycentrics():
    sj, st = scenes(lambda p: p.single_triangle())
    org = np.array([[0.0, 0.0, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    for t_max, want in ((10.0, 0), (2.0, -1)):
        hj, ht, oj, ot = both(sj, st, org, d, t_max=np.float32(t_max))
        assert_hits(hj, ht)
        assert int(ht.tri[0]) == want and bool(ot[0]) == (want == 0)
        np.testing.assert_array_equal(ot, oj)
    far = trace_t.trace_closest(*st, torch.as_tensor(org), torch.as_tensor(d),
                                t_max=10.0)
    assert np.isclose(float(far.t[0]), 5.0, atol=1e-4)
    # aimed at vertex 1 (1, -1, 0): u ~ 1
    org = np.array([[0.99, -0.98, 5.0]], np.float32)
    hj, ht, _, _ = both(sj, st, org, d)
    assert_hits(hj, ht)
    assert float(ht.u[0]) > 0.9


def test_per_ray_t_max():
    sj, st = scenes(lambda p: p.random_tri_soup(500, seed=500))
    org, d = random_rays(512, seed=3)
    t_max = np.random.default_rng(4).uniform(0.0, 12.0, 512).astype(
        np.float32)
    t_max[::7] = 0.0                       # dead lanes, as the path tracer's
    hj, ht, oj, ot = both(sj, st, org, d, t_max=t_max)
    assert_hits(hj, ht)
    np.testing.assert_array_equal(ot, oj)
    miss = ht.tri.numpy() < 0
    np.testing.assert_array_equal(ht.t.numpy()[miss], t_max[miss])
    assert not ot[::7].any()
    # a limit cuts hits the unlimited walk finds
    full = trace_t.trace_closest(*st, torch.as_tensor(org), torch.as_tensor(d))
    assert (full.hit_mask.numpy() & miss).any()


@pytest.mark.parametrize("max_steps", [1, 4, 17, 64])
def test_max_steps_matches_jax(max_steps):
    sj, st = scenes(lambda p: p.random_tri_soup(500, seed=500))
    org, d = random_rays(512, seed=1)
    hj, ht, oj, ot = both(sj, st, org, d, max_steps=max_steps)
    assert_hits(hj, ht)
    np.testing.assert_array_equal(ot, oj)
    bvh, tris = st
    tmax = torch.full((512,), INF)
    out = trace_t.walk_plain(bvh, tris, torch.as_tensor(org),
                             torch.as_tensor(d), 1e-4, tmax, False,
                             max_steps, counts=True)
    visits = out[4].numpy()
    assert visits.max() == max_steps          # the cap is per ray
    full = trace_t.walk_plain(bvh, tris, torch.as_tensor(org),
                              torch.as_tensor(d), 1e-4, tmax, False,
                              counts=True)
    np.testing.assert_array_equal(visits, np.minimum(full[4].numpy(),
                                                     max_steps))


def test_walk_counts():
    """The per-ray counts: every ray visits the root; a ray tests no more
    triangles than leaf_size a visit; an any-hit ray stops at its first
    hit leaf, so it visits no more nodes than the closest-hit walk."""
    _, (bvh, tris) = scenes(lambda p: p.random_tri_soup(500, seed=500))
    org, d = (torch.as_tensor(x) for x in random_rays(512, seed=5))
    tmax = torch.full((512,), INF)
    t, tri, u, v, visits, tests = trace_t.walk_plain(
        bvh, tris, org, d, 1e-4, tmax, False, counts=True)
    assert visits.dtype == torch.int32 and tests.dtype == torch.int32
    assert bool((visits >= 1).all())
    assert bool((tests <= bvh.leaf_size * visits).all())
    assert bool((tests > 0).any())
    a = trace_t.walk_plain(bvh, tris, org, d, 1e-4, tmax, True, counts=True)
    assert bool((a[4] <= visits).all())
    assert torch.equal(a[1] >= 0, tri >= 0)
    # the counts change nothing else
    plain = trace_t.walk_plain(bvh, tris, org, d, 1e-4, tmax, False)
    for x, y in zip(plain, (t, tri, u, v)):
        assert torch.equal(x, y)
