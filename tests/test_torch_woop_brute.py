"""Kernel B's semantics on the CPU: the plain version `brute_plain` against the
Pallas kernel (interpret mode) and the XLA reference on tables of more than
one 256-triangle shared-memory tile, the tie rule, the padded (T, 24) table,
the plain model of the kernel's rejects before the division, and the
wrapper's t_min check. The kernel itself is held to `brute_plain` bit for
bit on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.ops import woop as woop_j
from kajiya_tpu.ops import woop_pallas as wp_j
from kajiya_tpu.rt.bvh import bvh_from_scene
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu_torch.core.camera import camera_rays, make_view_constants
from kajiya_tpu_torch.ops import woop as woop_t
from kajiya_tpu_torch.ops import woop_cuda as wc
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene
from kajiya_tpu_torch.world import build_trace_scene

# Hits agree on >= 99.9% of triangle ids (exactly coplanar ties may resolve
# differently in JAX's reductions) with t within 2e-5, as in
# tests/test_torch_woop.py (JAX's u, v may be contracted into FMAs, so they
# differ by more than t); any-hit is compared as an occlusion mask, which
# must be equal.
ID_AGREE = 0.999
T_TOL = 2e-5
F32 = np.float32


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scene_woop(scene):
    """JAX Woop tables of a JAX scene, padded to whole 256-triangle tiles,
    and the same tables as torch tensors."""
    _, _, (v0, e1, e2) = bvh_from_scene(build_gpu_j(scene))
    n = np.asarray(v0).shape[0]
    wj = woop_j.build_woop(v0, e1, e2, pad_to=-(-n // 256) * 256)
    return n, wj, {k: _t(np.asarray(v)) for k, v in wj.items()}


def _aimed_rays(n, lo, hi, seed):
    """Rays from a shell around the box [lo, hi] towards points inside it."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, F32), np.asarray(hi, F32)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org = mid + d * (np.linalg.norm(half) * 1.5)
    target = rng.uniform(lo, hi, (n, 3))
    dirs = target - org
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return org.astype(F32), dirs.astype(F32)


SCENES = {
    # one building and the ground: 768 + 2 = 770 triangles, 4 tiles of 256
    "city1": (lambda p: p.city(n=1, subdiv=8), (-1.5, 0.0, -1.5),
              (1.5, 8.0, 1.5)),
    # 2,000 triangles, 8 tiles
    "soup2000": (lambda p: p.random_tri_soup(2000), (-10.0, -10.0, -10.0),
                 (10.0, 10.0, 10.0)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def multi_tile(request):
    make, lo, hi = SCENES[request.param]
    n, wj, wt = _scene_woop(make(proc_j))
    assert n > 256
    org, d = _aimed_rays(2048, lo, hi, seed=len(request.param))
    return request.param, n, wj, wt, org, d


@pytest.mark.parametrize("case", ["closest", "t_max", "any_hit"])
def test_brute_plain_matches_jax_beyond_one_tile(multi_tile, case):
    name, n, wj, wt, org, d = multi_tile
    kw = {}
    if case == "t_max":
        # limits around the distance to the geometry's middle: some rays
        # stop short of their hit, some do not
        _, lo, hi = SCENES[name]
        reach = np.linalg.norm(org - (np.asarray(lo) + hi) / 2, axis=-1)
        kw["t_max"] = (reach * np.random.default_rng(3).uniform(
            0.6, 1.4, org.shape[0])).astype(F32)
    any_hit = case == "any_hit"
    ref_p = wp_j.intersect_brute_pallas(
        wj, jnp.asarray(org), jnp.asarray(d), any_hit=any_hit, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    ref_x = woop_j.intersect_brute(wj, jnp.asarray(org), jnp.asarray(d),
                                   any_hit=any_hit,
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
    got = wc.intersect_brute_cuda(wt, _t(org), _t(d), any_hit=any_hit,
                                  **{k: _t(v) for k, v in kw.items()})
    tri = _n(got[1])
    assert tri.dtype == np.int32
    # a real share of the rays hits, across more than one tile
    hit = tri >= 0
    assert 0.1 < hit.mean() < 1.0
    assert (tri[hit] >= 256).any() and (tri[hit] < 256).any()
    for ref in (ref_p, ref_x):
        np.testing.assert_array_equal(hit, np.asarray(ref[1]) >= 0)
        if any_hit:
            continue
        ref_tri = np.asarray(ref[1])
        assert (ref_tri[hit] == tri[hit]).mean() >= ID_AGREE
        same = hit & (ref_tri == tri)
        np.testing.assert_allclose(_n(got[0])[same], np.asarray(ref[0])[same],
                                   rtol=T_TOL, atol=T_TOL)
        assert (_n(got[0])[~hit] >= 1e29).all()
        assert (_n(got[2])[~hit] == 0).all() and (_n(got[3])[~hit] == 0).all()


def _tri_tables(tris):
    """torch Woop tables of (v0, e1, e2) lists, padded to whole tiles."""
    v0, e1, e2 = (_t(np.asarray(x, F32)) for x in zip(*tris))
    n = v0.shape[0]
    woop = woop_t.build_woop(v0, e1, e2, pad_to=-(-n // 256) * 256)
    return wc.attach_coef_tables(woop)


def _quad_tri(z, size=1.0, shift=(0.0, 0.0)):
    sx, sy = shift
    return ((sx - size, sy - size, z), (2 * size, 0.0, 0.0),
            (0.0, 2 * size, 0.0))


def test_ties_take_the_lowest_index():
    """Coincident triangles hit at the same t: the lowest index wins, in one
    tile and across tiles, also where a farther triangle comes first."""
    far = _quad_tri(-3.0)
    tie = _quad_tri(-1.0)
    other = _quad_tri(-2.0, size=0.2, shift=(5.0, 5.0))     # never hit
    tris = [far] + [other] * 4 + [tie] + [other] * 294 + [tie, tie]
    assert len(tris) > 256       # the last two lie in the second tile
    woop = _tri_tables(tris)
    rng = np.random.default_rng(4)
    # inside the triangles' common half of the square
    org = np.concatenate([rng.uniform(-0.9, -0.1, (256, 2)),
                          np.full((256, 1), 1.0)], axis=1).astype(F32)
    d = np.tile(np.array([0.0, 0.0, -1.0], F32), (256, 1))
    t, tri, u, v = wc.intersect_brute_cuda(woop, _t(org), _t(d))
    np.testing.assert_array_equal(_n(tri), 5)
    np.testing.assert_allclose(_n(t), 2.0, rtol=1e-6)
    # the same rule with the copies only: the first copy in the second tile
    woop2 = _tri_tables([other] * 300 + [tie, tie, tie])
    _, tri2, _, _ = wc.intersect_brute_cuda(woop2, _t(org), _t(d))
    np.testing.assert_array_equal(_n(tri2), 300)
    # JAX's kernel and reference pick the same triangle
    wj = {k: jnp.asarray(_n(woop[k])) for k in ("a_o", "a_d", "valid")}
    for ref in (wp_j.intersect_brute_pallas(wj, jnp.asarray(org),
                                            jnp.asarray(d), interpret=True),
                woop_j.intersect_brute(wj, jnp.asarray(org), jnp.asarray(d))):
        np.testing.assert_array_equal(np.asarray(ref[1]), 5)


def test_padded_rows_built_once_per_refresh(monkeypatch):
    ts, _ = build_trace_scene(build_gpu_scene(proc_t.cornell_box(),
                                              device="cpu"), device="cpu")
    rows, rows24 = ts.woop["coef_rows"], ts.woop["coef_rows24"]
    assert rows24.dtype == torch.float32 and rows24.is_contiguous()
    assert tuple(rows24.shape) == (rows.shape[0], wc.N_ROW)
    assert torch.equal(rows24[:, :wc.N_COEF], rows)
    assert not rows24[:, wc.N_COEF:].any()
    assert torch.equal(wc.coef_rows24(ts.woop), rows24)
    # 16-byte rows: the kernel reads each as 6 float4
    assert rows24.stride(0) * 4 % 16 == 0

    def rebuilt(_woop):
        raise AssertionError("the (T, 24) table was rebuilt")
    monkeypatch.setattr(wc, "coef_rows24", rebuilt)
    assert wc.stored_table(ts.woop, "coef_rows24", wc.coef_rows24) is rows24


def test_brute_launch_refuses_negative_t_min():
    woop = _tri_tables([_quad_tri(-1.0)])
    org = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    tmax = wc.ray_tmax(org, None)
    with pytest.raises(ValueError, match="t_min >= 0"):
        wc.brute_launch(woop["coef_rows24"], org, d, tmax, -1e-4, False)
    with pytest.raises(ValueError, match="t_min >= 0"):
        wc.check_t_min(float("nan"))
    wc.check_t_min(0.0)
    wc.check_t_min(1e-4)


# ----------------------------------------------------------------------------
# The rejects before the division
# ----------------------------------------------------------------------------

def _exact_ok(coef, org, d, t_min, lim):
    """brute_plain's acceptance of every ray x triangle pair for rays whose
    best t so far and tmax make lim = min(t_best, tmax)."""
    c = coef[:, :wc.N_COEF].T
    o = [org[:, j:j + 1] for j in range(3)]
    dd = [d[:, j:j + 1] for j in range(3)]
    t, u, v, rw_ok = wc._woop_math(c, o, dd)
    ok = (rw_ok & (u >= -wc._BEPS) & (v >= -wc._BEPS)
          & ((u + v) <= wc._ONE_BEPS) & (t > wc._f32(t_min)) & (t < wc.INF)
          & (t < lim[:, None]))
    return ok, t


def _assert_sound(coef, org, d, lim, t_mins=(0.0, 1e-4)):
    """No pair that the rejects drop is accepted by the exact test."""
    rej = wc.brute_reject_plain(coef, org, d, lim)
    for t_min in t_mins:
        ok, _ = _exact_ok(coef, org, d, t_min, lim)
        bad = rej & ok
        assert not bool(bad.any()), (t_min, int(bad.sum()))
    return rej


def _nextafter(x, toward):
    return torch.nextafter(x, torch.full_like(x, toward))


def _soup_coef(n, scale, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-scale, scale, (n, 3)).astype(F32)
    e1 = (rng.normal(0, 0.3, (n, 3)) * scale).astype(F32)
    e2 = (rng.normal(0, 0.3, (n, 3)) * scale).astype(F32)
    w = woop_t.build_woop(_t(v0), _t(e1), _t(e2), pad_to=n)
    return wc.coef_rows24(w)


@pytest.mark.parametrize("scale", [1e-3, 1e-1, 1.0, 1e2, 1e4])
def test_rejects_sound_at_the_limit_ulp(scale):
    """Each ray aimed at its own triangle (coordinates from 1e-3 to 1e4):
    with lim one ulp above the exact t the pair is accepted and must be
    kept; at t and one ulp below it is refused either way; every pair of the
    full matrix stays sound at each of those limits, at lim = 1e30, and
    with t_min at t and one ulp either side."""
    n = 512
    coef = _soup_coef(n, scale, seed=int(np.log10(scale) + 10))
    rng = np.random.default_rng(1)
    bary = rng.dirichlet([1.0, 1.0, 1.0], n).astype(F32)
    c = coef[:, :wc.N_COEF].double().numpy()
    # the triangle's corners from its inverse Woop transform
    pts = []
    for k in range(n):
        m = np.concatenate([c[k, 0:4][None], c[k, 4:8][None],
                            c[k, 8:12][None], [[0, 0, 0, 1]]])
        inv = np.linalg.inv(m)
        pts.append(inv[:3, :3] @ np.array([bary[k, 0], bary[k, 1], 0.0])
                   + inv[:3, 3])
    target = np.asarray(pts)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org = (target - d * scale * rng.uniform(0.5, 3.0, (n, 1))).astype(F32)
    org_t, d_t = _t(org), _t(d.astype(F32))
    _, t_all = _exact_ok(coef, org_t, d_t, 0.0,
                         torch.full((n,), wc.INF))
    t = t_all.diagonal().clone()
    ok_inf, _ = _exact_ok(coef, org_t, d_t, 1e-4, torch.full((n,), wc.INF))
    aimed = ok_inf.diagonal()
    assert aimed.float().mean() > 0.9
    up = _nextafter(t, np.inf)
    rej = _assert_sound(coef, org_t, d_t, up)
    ok_up, _ = _exact_ok(coef, org_t, d_t, 1e-4, up)
    kept = ok_up.diagonal()
    assert bool(kept[aimed].all())
    assert not bool(rej.diagonal()[kept].any())
    for lim in (t, _nextafter(t, -np.inf), torch.full((n,), wc.INF)):
        _assert_sound(coef, org_t, d_t, lim)
    # t_min at t and one ulp either side, per ray (the rejects do not read
    # t_min; the exact test does)
    tt, u, v, rw_ok = wc._woop_math(
        coef[:, :wc.N_COEF].T, [org_t[:, j:j + 1] for j in range(3)],
        [d_t[:, j:j + 1] for j in range(3)])
    inside = (rw_ok & (u >= -wc._BEPS) & (v >= -wc._BEPS)
              & ((u + v) <= wc._ONE_BEPS) & (tt < up[:, None]))
    for t_min in (t, _nextafter(t, -np.inf), _nextafter(t, np.inf)):
        assert not bool((rej & inside & (tt > t_min[:, None])).any())


def test_rejects_sound_for_grazing_rays():
    """Rays almost in a triangle's plane, |rw| around the 1e-12 rw_ok edge,
    from above, below and on the plane, at several limits."""
    tris = [_quad_tri(z, size=s) for z in (-1.0, 0.0, 2.5)
            for s in (0.5, 1.0, 40.0)]
    coef = _tri_tables(tris)["coef_rows24"][:len(tris)]
    rows = []
    for eps in (0.0, 1e-14, 3e-13, 9.99e-13, 1e-12, 1.001e-12, 3e-12, 1e-9):
        for sgn in (1.0, -1.0):
            for z0 in (-1.0, 0.0, 1e-7, 1.0, 2.5):
                for ang in (0.0, 0.7, 2.0):
                    rows.append(((0.1, 0.2, z0),
                                 (np.cos(ang), np.sin(ang), sgn * eps)))
    org = _t(np.asarray([r[0] for r in rows], F32))
    d = _t(np.asarray([r[1] for r in rows], F32))
    n = org.shape[0]
    for lim in (wc.INF, 1.0, 1e12, 1e14, 2e-25, 3e-26, 1e-30):
        _assert_sound(coef, org, d, torch.full((n,), lim, dtype=torch.float32))
    # and rays that do cross the planes, from near the rw_ok edge up
    dz = np.array([1e-12, 2e-12, 1e-6, 0.3, 1.0], F32)
    cross = [((0.05, 0.1, 3.0), (0.0, 0.0, -1.0)),
             ((0.05, 0.1, 3.0), (1e-3, 0.0, -1.0))]
    for z in dz:
        cross.append(((0.0, 0.0, 3.0), (1.0, 0.0, -z)))
    org = _t(np.asarray([c[0] for c in cross], F32))
    d = _t(np.asarray([c[1] for c in cross], F32))
    for lim in (wc.INF, 2.0, 3.5, 4.0):
        _assert_sound(coef, org, d,
                      torch.full((org.shape[0],), lim, dtype=torch.float32))


def test_rejects_sound_for_origins_on_the_plane():
    """Secondary rays leave a hit point on the triangle's plane: qw is zero
    or a rounding residue, t is 0 or tiny either sign."""
    coef = _soup_coef(256, 1.0, seed=5)
    c = coef[:, :wc.N_COEF].double().numpy()
    rng = np.random.default_rng(6)
    org, d = [], []
    for k in range(256):
        m = np.concatenate([c[k, 0:4][None], c[k, 4:8][None],
                            c[k, 8:12][None], [[0, 0, 0, 1]]])
        inv = np.linalg.inv(m)
        b = rng.dirichlet([1.0, 1.0, 1.0])
        org.append(inv[:3, :3] @ np.array([b[0], b[1], 0.0]) + inv[:3, 3])
        dd = rng.normal(size=3)
        d.append(dd / np.linalg.norm(dd))
    org, d = _t(np.asarray(org, F32)), _t(np.asarray(d, F32))
    for lim in (wc.INF, 1e-4, 1.0, 1e-30):
        _assert_sound(coef, org, d, torch.full((256,), lim,
                                               dtype=torch.float32),
                      t_mins=(0.0, 1e-4, 1e-7))


def test_rejects_drop_a_share_of_cornell_camera_pairs():
    """Not an empty filter: on cornell's camera rays (64x48) the rejects
    drop at least 30% of the pairs before any hit (lim = 1e30) and more
    once each ray's closest hit bounds it; all of them soundly."""
    ts, _ = build_trace_scene(build_gpu_scene(proc_t.cornell_box(),
                                              device="cpu"), device="cpu")
    view = make_view_constants((0.0, 0.0, 2.4), (0.0, 0.0, -1.0), width=64,
                               height=48, device="cpu")
    org, d = (x.reshape(-1, 3).contiguous()
              for x in camera_rays(view, 64, 48))
    coef = ts.woop["coef_rows24"]
    n = org.shape[0]
    first = _assert_sound(coef, org, d, torch.full((n,), wc.INF))
    t, tri, _, _ = wc.intersect_brute_cuda(ts.woop, org, d)
    hit = tri >= 0
    assert float(hit.float().mean()) > 0.9
    last = _assert_sound(coef, org, d, t)
    share_first = float(first.float().mean())
    share_last = float(last.float().mean())
    assert share_first >= 0.30, share_first
    assert share_last > share_first
    # the closest hit is kept while the bound is the previous best
    lim = _nextafter(t, np.inf)
    keep = ~wc.brute_reject_plain(coef, org, d, lim)
    assert bool(keep[torch.arange(n)[hit], tri[hit].long()].all())
