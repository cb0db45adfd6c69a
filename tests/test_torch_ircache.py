"""Port parity, the irradiance cache: `ops/scan.py` and
`renderers/ircache.py` of `kajiya_tpu_torch` against `kajiya_tpu` on the same
seeded numpy inputs.

Cell knife edges: `_cascade_of` takes ceil(log2(.)) of a distance and
`_cell_of` floors a position over a power-of-two cell size, so a point on a
cell or cascade boundary may change cell on one ulp. The seeded query points
here are drawn at cell centres plus a jitter of at most 0.3 cell and are
dropped where their distance to the eye lies within 2% of a cascade
boundary, so that both packages see the same cells and the integer planes
can be compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core.camera import make_view_constants as view_j
from kajiya_tpu.ops import scan as scan_j
from kajiya_tpu.renderers import gbuffer as gbuffer_j
from kajiya_tpu.renderers import ircache as irc_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu.sky import env as sky_j
from kajiya_tpu.world import build_trace_scene as build_ts_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.ops import scan as scan_t
from kajiya_tpu_torch.renderers import ircache as irc_t
from kajiya_tpu_torch.sky import env as sky_t

torch.set_num_threads(1)


def _n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.as_tensor(np.array(np.asarray(x)))


def cfg_pair(**kw):
    return irc_j.IrcacheConfig(**kw), irc_t.IrcacheConfig(**kw)


def assert_state(sj, st, atol=1e-6):
    """Integer and bool planes exactly, float planes within atol."""
    assert set(sj) == set(st)
    for k in sj:
        a, b = np.asarray(sj[k]), _n(st[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=k)


# ----------------------------------------------------------------------------
# ops/scan.py: bit-exact
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,density,capacity",
                         [(1, 1.0, None), (257, 0.3, None), (1000, 0.7, 100),
                          (4096, 0.05, 4096), (333, 0.0, 8)])
def test_scan_and_compact_exact(n, density, capacity):
    rs = np.random.default_rng(n)
    mask = rs.random(n) < density
    x = rs.integers(-5, 6, n).astype(np.int32)
    np.testing.assert_array_equal(
        _n(scan_t.inclusive_scan(torch.as_tensor(x))),
        np.asarray(scan_j.inclusive_scan(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _n(scan_t.exclusive_scan(torch.as_tensor(x))),
        np.asarray(scan_j.exclusive_scan(jnp.asarray(x))))
    pj, cj = scan_j.compact_indices(jnp.asarray(mask), capacity)
    pt, ct = scan_t.compact_indices(torch.as_tensor(mask), capacity)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(_n(pt), np.asarray(pj))
    assert int(ct) == int(cj)


# ----------------------------------------------------------------------------
# Cells, grid, allocation, value grid
# ----------------------------------------------------------------------------

SMALL = dict(cascades=4, grid_res=8, max_entries=48, rays_per_entry=2,
             base_cell_size=0.5, expire_frames=2)
EYE = np.array([0.3, -0.2, 0.45], np.float32)


def seeded_queries(seed, n, cfg, eye=EYE, spread=6):
    """Points at cell centres of cascade 0 (size base_cell_size) plus a
    jitter of <= 0.3 cell, away from the cascade boundaries (see the module
    note), as float32."""
    rs = np.random.default_rng(seed)
    cs = cfg.base_cell_size
    cells = rs.integers(-spread, spread, (n, 3))
    p = ((cells + 0.5 + rs.uniform(-0.3, 0.3, (n, 3))) * cs).astype(
        np.float32)
    he0 = cs * cfg.grid_res * 0.5
    d = np.abs(p.astype(np.float64) - eye).max(-1) / he0
    keep = np.ones(n, bool)
    for c in range(cfg.cascades):
        keep &= np.abs(d - 2.0 ** c) > 0.02 * 2.0 ** c
    # a coarser cascade's cells are unions of cascade-0 cells only when
    # their edges line up: keep points off every cascade's cell edges
    for c in range(cfg.cascades):
        f = p / (cs * 2.0 ** c)
        keep &= (np.abs(f - np.round(f)) > 0.02).all(-1)
    return p[keep], rs.random(keep.sum()) < 0.9


def test_cells_exact():
    cj, ct = cfg_pair(**SMALL)
    p, _ = seeded_queries(0, 2000, cj, spread=40)
    eye = torch.as_tensor(EYE)
    cas_j, inr_j = irc_j._cascade_of(jnp.asarray(p), jnp.asarray(EYE), cj)
    cas_t, inr_t = irc_t._cascade_of(torch.as_tensor(p), eye, ct)
    np.testing.assert_array_equal(_n(cas_t), np.asarray(cas_j))
    np.testing.assert_array_equal(_n(inr_t), np.asarray(inr_j))
    assert len(np.unique(np.asarray(cas_j))) >= 3
    f_j, ok_j, cs_j = irc_j._cell_of(jnp.asarray(p), jnp.asarray(EYE), cas_j,
                                     cj)
    f_t, ok_t, cs_t = irc_t._cell_of(torch.as_tensor(p), eye, cas_t, ct)
    assert f_t.dtype == torch.int32
    np.testing.assert_array_equal(_n(f_t), np.asarray(f_j))
    np.testing.assert_array_equal(_n(ok_t), np.asarray(ok_j))
    np.testing.assert_array_equal(_n(cs_t), np.asarray(cs_j))


@pytest.fixture(scope="module")
def alloc_runs():
    """Eight frames of build_grid + allocate + build_value_grid in both
    packages, each threading its own state. Query sets change between
    frames, so entries expire (expire_frames=2) and their slots are
    recycled; more cells are queried than there are slots, so allocation is
    capacity-bound."""
    cj, ct = cfg_pair(**SMALL)
    sj = irc_j.init_state(cj)
    st = irc_t.init_state(ct)
    eye_j, eye_t = jnp.asarray(EYE), torch.as_tensor(EYE)
    out = []
    for f in range(8):
        q, m = seeded_queries(100 + f % 3 + (f // 5) * 7, 60, cj)
        gj = irc_j.build_grid(sj, eye_j, cj)
        gt = irc_t.build_grid(st, eye_t, ct)
        sj = irc_j.allocate(sj, gj, jnp.asarray(q), jnp.asarray(m), eye_j, f,
                            cj)
        st = irc_t.allocate(st, gt, torch.as_tensor(q), torch.as_tensor(m),
                            eye_t, f, ct)
        vj = irc_j.build_value_grid(sj, irc_j.build_grid(sj, eye_j, cj), cj)
        vt = irc_t.build_value_grid(st, irc_t.build_grid(st, eye_t, ct), ct)
        out.append(dict(gj=gj, gt=gt, sj=sj, st=st, vj=vj, vt=vt))
    return cj, ct, out


@pytest.mark.parametrize("frame", range(8))
def test_grid_allocate_value_grid(alloc_runs, frame):
    """Grids, ids, masks and frame stamps exactly; floats within 1e-6."""
    _, _, out = alloc_runs
    r = out[frame]
    assert r["gt"].dtype == torch.int32
    np.testing.assert_array_equal(_n(r["gt"]), np.asarray(r["gj"]))
    assert_state(r["sj"], r["st"], atol=1e-6)
    np.testing.assert_allclose(_n(r["vt"]), np.asarray(r["vj"]), atol=1e-6,
                               rtol=0)


def test_allocation_recycles_and_fills(alloc_runs):
    cj, _, out = alloc_runs
    valid = [int(np.asarray(r["sj"]["ircache_valid"]).sum()) for r in out]
    seen = [np.asarray(r["sj"]["ircache_seen"]) for r in out]
    assert max(valid) == cj.max_entries          # capacity-bound
    # some slot was recycled: its stamp jumped past expire_frames
    assert any((((b - a) > cj.expire_frames) & (a >= 0)).any()
               for a, b in zip(seen, seen[1:]))


def test_lookup_irradiance(alloc_runs):
    """Both grid forms against JAX within 1e-5 on random points, normals,
    SH payloads and lives (the lives straddle the confidence ramp)."""
    cj, ct, out = alloc_runs
    sj = dict(out[-1]["sj"])
    rs = np.random.default_rng(7)
    e = cj.max_entries
    sj["ircache_sh"] = jnp.asarray(rs.normal(0.5, 0.5, (e, 3, 4)),
                                   jnp.float32)
    sj["ircache_life"] = jnp.asarray(rs.uniform(0, 8, e), jnp.float32)
    st = _t(sj)
    p, _ = seeded_queries(11, 500, cj)
    nrm = rs.normal(size=(p.shape[0], 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    sky_sh = sky_j.project_sh9(sky_j.build_sky_env(
        jnp.asarray([0.3, 0.8, 0.5], jnp.float32), res=32))
    env_j = sky_j.sh9_irradiance_fn(sky_sh)
    env_t = sky_t.sh9_irradiance_fn(_t(sky_sh))
    eye_j, eye_t = jnp.asarray(EYE), torch.as_tensor(EYE)
    gj = irc_j.build_grid(sj, eye_j, cj)
    gt = irc_t.build_grid(st, eye_t, ct)
    for grid_j, grid_t in ((gj, gt), (irc_j.build_value_grid(sj, gj, cj),
                                      irc_t.build_value_grid(st, gt, ct)),
                           (None, None)):
        a = irc_j.lookup_irradiance(sj, grid_j, jnp.asarray(p),
                                    jnp.asarray(nrm), eye_j, env_j, cj)
        b = irc_t.lookup_irradiance(st, grid_t, torch.as_tensor(p),
                                    torch.as_tensor(nrm), eye_t, env_t, ct)
        np.testing.assert_allclose(_n(b), np.asarray(a), atol=1e-5, rtol=0)
    assert float(np.asarray(a).max()) > 0.5


# ----------------------------------------------------------------------------
# trace_update on cornell
# ----------------------------------------------------------------------------

TRACE = dict(max_entries=4096, active_budget=1024)


@pytest.fixture(scope="module")
def trace_runs():
    """Entries allocated from a 64x48 cornell gbuffer (JAX), then 4 frames of
    trace_update in both packages from that state, each threading its own;
    frames 0 and 3 are validation frames (frame 3 re-traces stored rays)."""
    cj, ct = cfg_pair(**TRACE)
    ts_j, _ = build_ts_j(build_gpu_j(proc_j.cornell_box()))
    ts_t = convert.trace_scene_from_numpy(convert.to_numpy_dict(ts_j),
                                          device="cpu")
    eye = (0.0, 0.0, 2.4)
    v = view_j(eye, (0.0, 0.0, -1.0), fov_y_deg=55.0, width=64, height=48)
    gb = gbuffer_j.raster_gbuffer(ts_j, v, 64, 48)
    eye_j = jnp.asarray(eye, jnp.float32)
    s0 = irc_j.init_state(cj)
    s0 = irc_j.allocate(s0, irc_j.build_grid(s0, eye_j, cj),
                        gb["pos"].reshape(-1, 3), gb["hit"].reshape(-1),
                        eye_j, 0, cj)
    sky_sh = sky_j.project_sh9(sky_j.build_sky_env(ts_j.gpu.sun_direction,
                                                   res=32))
    envs_j = (sky_j.sh9_radiance_fn(sky_sh), sky_j.sh9_irradiance_fn(sky_sh))
    sh_t = _t(sky_sh)
    envs_t = (sky_t.sh9_radiance_fn(sh_t), sky_t.sh9_irradiance_fn(sh_t))
    sj, st = s0, _t(s0)
    out = []
    for f in range(4):
        sj = irc_j.trace_update(sj, ts_j, *envs_j, eye_j, f, cj,
                                secondary_full_shading=True)
        st = irc_t.trace_update(st, ts_t, *envs_t,
                                torch.as_tensor(np.array(eye_j)), f, ct,
                                secondary_full_shading=True)
        out.append((sj, st))
    return cj, out


def test_active_entries_exact(trace_runs):
    """The round-robin active set, for frame indices past the wrap."""
    cj, out = trace_runs
    valid = np.asarray(out[0][0]["ircache_valid"])
    n_live = int(valid.sum())
    assert n_live > cj.active_budget // 8
    for fi in (0, 1, 3, 7, 1000):
        for budget in (64, 1024):
            lst = irc_t.active_entries(torch.as_tensor(valid), fi, budget)
            rank = np.cumsum(valid) - 1
            slot = np.where(valid, (rank - (fi * budget) % n_live) % n_live,
                            budget)
            ref = np.full(budget, -1, np.int64)
            sel = valid & (slot < budget)
            ref[slot[sel]] = np.nonzero(sel)[0]
            np.testing.assert_array_equal(_n(lst), ref)


@pytest.mark.parametrize("frame", range(4))
def test_trace_update(trace_runs, frame):
    """SH and life within 1e-4 on >= 99.5% of the entries (a shadow ray that
    grazes an edge may resolve differently); directions of the stored rays
    within 1e-6 on the same share, the masks and stamps exactly."""
    _, out = trace_runs
    sj, st = out[frame]
    for k in ("ircache_valid", "ircache_seen"):
        np.testing.assert_array_equal(_n(st[k]), np.asarray(sj[k]), k)
    for k, tol in (("ircache_sh", 1e-4), ("ircache_life", 1e-4),
                   ("ircache_ray_rad", 1e-4), ("ircache_ray_dir", 1e-6),
                   ("ircache_pos", 1e-6)):
        a, b = np.asarray(sj[k]), _n(st[k])
        ok = (np.abs(a - b) <= tol).reshape(a.shape[0], -1).all(-1)
        assert ok.mean() >= 0.995, (k, ok.mean())
    live = np.asarray(sj["ircache_valid"])
    assert np.abs(np.asarray(sj["ircache_sh"])[live]).sum() > 0.0
    if frame == 3:
        # the validation frame re-traced the directions frame 2 stored
        np.testing.assert_allclose(_n(st["ircache_ray_dir"]),
                                   _n(out[2][1]["ircache_ray_dir"]),
                                   atol=1e-6)
