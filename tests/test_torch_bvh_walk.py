"""Port parity, the BVH walk: `kajiya_tpu_torch.rt.trace`'s `trace_closest`
/ `trace_shadow` (on CPU tensors `walk_ordered_plain`, the front-to-back
walk, for closest-hit calls without a step cap, and `walk_plain`, the
skip-link walk, for any-hit and capped calls) against
`kajiya_tpu.rt.trace`'s on the same BVH and rays, the two plain walks
against each other, and the JAX package's own brute-force agreement check
(tests/test_bvh.py) run against the port.

Tolerance: hit masks and triangle ids equal; t, u and v within
1e-5 * max(1, |value|). The skip-link walk visits JAX's nodes and triangles
in JAX's order, but XLA evaluates the test's dot products on the CPU in its
own order (measured: t within 1.5 ulp, u and v, whose dot products cancel,
within 5.5e-6). The two plain walks give the same bits on these rays (the
front-to-back walk's tie rule picks the skip-link walk's triangle wherever
both test it). The kernel is held to the plain walks bit for bit on the card
(chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kajiya_tpu.rt import bvh as bvh_j
from kajiya_tpu.rt import trace as trace_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu_torch.core import camera as cam_t
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


# ----------------------------------------------------------------------------
# The front-to-back walk, the tie rule and the dead-lane rule
# ----------------------------------------------------------------------------

def cornell_axis_rays():
    org = np.zeros((6, 3), np.float32)
    d = np.array([[0, 0, -1], [0, 0, 1], [0, 1, 0], [0, -1, 0], [1, 0, 0],
                  [-1, 0, 0]], np.float32)
    return org, d


def city_camera_rays(width=96, height=64):
    """city(n=2)'s camera rays from the BVH frame test's eye
    (tests/test_torch_frame_bvh_city.py)."""
    view = cam_t.make_view_constants((0.0, 3.0, 6.0), (0.0, -0.45, -1.0),
                                     width=width, height=height,
                                     device="cpu")
    org, d = cam_t.camera_rays(view, width, height)
    return (org.reshape(-1, 3).numpy().copy(),
            d.reshape(-1, 3).numpy().copy())


WAVEFRONTS = {
    **{f"soup{n}": (lambda p, n=n: p.random_tri_soup(n, seed=n),
                    lambda: random_rays(512, seed=1))
       for n in (1, 7, 64, 500)},
    "cornell_axis": (lambda p: p.cornell_box(), cornell_axis_rays),
    "city2_camera": (lambda p: p.city(n=2, subdiv=8), city_camera_rays),
}


def plain_walks(st, org, d, tmax, t_min=1e-4):
    bvh, tris = st
    o, dd = torch.as_tensor(org), torch.as_tensor(d)
    return (trace_t.walk_ordered_plain(bvh, tris, o, dd, t_min, tmax,
                                       counts=True),
            trace_t.walk_plain(bvh, tris, o, dd, t_min, tmax, False,
                               counts=True))


@pytest.mark.parametrize("name", sorted(WAVEFRONTS))
def test_ordered_walk_matches_skip_link_and_jax(name):
    """t, tri, u, v of the front-to-back walk equal the skip-link walk's bit
    for bit and JAX's `_traverse` (ids exact, t / u / v within TOL) on every
    ray; the front-to-back walk tests no more triangles in all."""
    make, rays = WAVEFRONTS[name]
    sj, st = scenes(make)
    org, d = rays()
    tmax = torch.full((org.shape[0],), INF)
    o_out, s_out = plain_walks(st, org, d, tmax)
    for a, b in zip(o_out[:4], s_out[:4]):
        assert torch.equal(a, b)
    hj = trace_j.trace_closest(*sj, jnp.asarray(org), jnp.asarray(d))
    assert_hits(hj, trace_t.Hit(*o_out[:4]))
    assert int(o_out[5].sum()) <= int(s_out[5].sum())
    if name in ("soup500", "city2_camera", "cornell_axis"):
        assert bool((o_out[1] >= 0).any())


def test_ordered_walk_counts():
    """Box tests: the root, then two a descent, so an odd count on every
    live ray; a ray that misses the root tests one box and no triangle; at
    most leaf_size triangle tests a leaf reached (a descent reaches at most
    one); the counts change nothing else."""
    _, (bvh, tris) = scenes(lambda p: p.random_tri_soup(500, seed=500))
    org, d = (torch.as_tensor(x) for x in random_rays(512, seed=5))
    tmax = torch.full((512,), INF)
    t, tri, u, v, visits, tests = trace_t.walk_ordered_plain(
        bvh, tris, org, d, 1e-4, tmax, counts=True)
    assert visits.dtype == torch.int32 and tests.dtype == torch.int32
    assert bool((visits % 2 == 1).all())
    assert bool((tests <= bvh.leaf_size * (visits + 1) // 2).all())
    far = torch.full((1, 3), 1e4)
    miss = trace_t.walk_ordered_plain(bvh, tris, far, d[:1], 1e-4,
                                      tmax[:1], counts=True)
    assert int(miss[4][0]) == 1 and int(miss[5][0]) == 0
    assert int(miss[1][0]) == -1
    plain = trace_t.walk_ordered_plain(bvh, tris, org, d, 1e-4, tmax)
    for x, y in zip(plain, (t, tri, u, v)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_tris", [64, 500])
def test_dead_lanes_end_at_once(n_tris):
    """Rays with t_max <= t_min (0, negative, t_min itself) come back as
    (t_max, -1, 0, 0) with no visit and no test in both walks; the other
    rays' hits are unchanged and every hit equals JAX's."""
    sj, st = scenes(lambda p: p.random_tri_soup(n_tris, seed=n_tris))
    org, d = random_rays(512, seed=9)
    t_max = np.random.default_rng(10).uniform(0.5, 12.0, 512).astype(
        np.float32)
    dead = np.zeros(512, bool)
    dead[::5] = True
    t_max[::5] = np.resize(np.float32([0.0, -1.0, 1e-4]), dead.sum())
    tmax = torch.as_tensor(t_max)
    hj, ht, oj, ot = both(sj, st, org, d, t_max=t_max)
    assert_hits(hj, ht)
    np.testing.assert_array_equal(ot, oj)
    live_only = torch.as_tensor(np.where(dead, INF, t_max))
    for out, ref in zip(plain_walks(st, org, d, tmax),
                        plain_walks(st, org, d, live_only)):
        dl = torch.as_tensor(dead)
        assert torch.equal(out[0][dl], tmax[dl])
        assert bool((out[1][dl] == -1).all())
        assert bool((out[2][dl] == 0).all() and (out[3][dl] == 0).all())
        assert bool((out[4][dl] == 0).all() and (out[5][dl] == 0).all())
        for a, b in zip(out, ref):
            assert torch.equal(a[~dl], b[~dl])
    if n_tris >= 500:
        assert bool(ht.hit_mask.any())


def test_tie_goes_to_the_lower_slot():
    """Ten triangles stored twice under two ids: every ray aimed at one hits
    both at the same t, and both walks, and JAX's, return the id of the
    lower `tri_order` slot."""
    rng = np.random.default_rng(3)
    c = rng.uniform(-8, 8, (40, 1, 3)).astype(np.float32)
    p = (c + rng.uniform(-0.5, 0.5, (40, 3, 3))).astype(np.float32)
    p = np.concatenate([p, p[:10]])                 # ids 40..49 = 0..9
    v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    tmin, tmax_b = corners.min(axis=1), corners.max(axis=1)
    bt = bvh_t.build_bvh(tmin, tmax_b)[0].to("cpu")
    bj = jax.tree_util.tree_map(jnp.asarray,
                                bvh_j.build_bvh(tmin, tmax_b)[0])
    tris_t = tuple(torch.as_tensor(x) for x in (v0, e1, e2))
    tris_j = tuple(jnp.asarray(x) for x in (v0, e1, e2))
    target = v0[:10] + (e1[:10] + e2[:10]) / 3.0
    org = (target + np.float32([0.3, 9.0, 0.2])).astype(np.float32)
    d = target - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    slot = {int(t): k for k, t in enumerate(bt.tri_order.tolist()) if t >= 0}
    tmax = torch.full((10,), INF)
    o_out, s_out = plain_walks((bt, tris_t), org, d, tmax)
    hj = trace_j.trace_closest(bj, tris_j, jnp.asarray(org), jnp.asarray(d))
    ties = 0
    for i in range(10):
        a, b = i, i + 40
        want = a if slot[a] < slot[b] else b
        got = {int(o_out[1][i]), int(s_out[1][i]), int(np.asarray(hj.tri)[i])}
        # a nearer triangle of the soup may cover the target: then no tie
        if got <= {a, b}:
            assert got == {want}, (i, got, want)
            ties += 1
    assert ties >= 8
    assert torch.equal(o_out[1], s_out[1])


def test_capped_and_any_hit_calls_take_the_skip_link_walk(monkeypatch):
    """Only uncapped closest-hit calls walk front to back: a capped call and
    an any-hit call run the skip-link walk (the cap counts its steps)."""
    _, st = scenes(lambda p: p.random_tri_soup(500, seed=500))
    org, d = (torch.as_tensor(x) for x in random_rays(256, seed=2))
    calls = []
    ordered = trace_t.walk_ordered_plain

    def spy(*a, **k):
        calls.append(1)
        return ordered(*a, **k)

    monkeypatch.setattr(trace_t, "walk_ordered_plain", spy)
    capped = trace_t.trace_closest(*st, org, d, max_steps=17)
    trace_t.trace_shadow(*st, org, d)
    assert not calls
    want = trace_t.walk_plain(*st, org, d, 1e-4, torch.full((256,), INF),
                              False, 17)
    for a, b in zip((capped.t, capped.tri, capped.u, capped.v), want):
        assert torch.equal(a, b)
    trace_t.trace_closest(*st, org, d)
    assert calls == [1]
