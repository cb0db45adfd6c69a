"""Kernel tables and the per-ray walk of the culled Woop kernel, on the CPU.

The coefficient tables kernels B and C read are stored in the `woop`
dictionary when the trace scene is refreshed; these tests hold them to the
tables built per launch before (value for value), show that the plain version
of kernel C returns the same bits from the stored table, that a refresh after
a moved vertex yields new tables, and that the kernel's per-ray decisions
(`culled_plain(ray_skip=True)`) return the chunk-level walk's bits, also on
divergent chunks with rays that miss. All comparisons are exact."""
import numpy as np
import pytest
import torch

from kajiya_tpu_torch.ops import woop as woop_t
from kajiya_tpu_torch.ops import woop_cuda as wc
from kajiya_tpu_torch.scene import procedural
from kajiya_tpu_torch.scene.scene import build_gpu_scene
from kajiya_tpu_torch.world import build_trace_scene, refresh_trace_scene

SCENES = {"cornell": lambda: procedural.cornell_box(),
          "city4": lambda: procedural.city(n=4, subdiv=8)}
MODES = {"closest": (False, True), "any_hit": (True, True),
         "no_early_stop": (False, False)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain walk is thousands of small tensor ops: on one thread they
    do not wait for a thread pool that other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _trace_scene(name):
    return build_trace_scene(build_gpu_scene(SCENES[name](), device="cpu"),
                             device="cpu")[0]


@pytest.fixture(scope="module")
def city():
    return _trace_scene("city4")


def _old_rows(woop):
    """The (T, 21) table as it was gathered per launch: for triangle i the
    rows i, T + i, 2T + i of a_o (4 wide) and then of a_d (3 wide)."""
    a_o, a_d = woop["a_o"].numpy(), woop["a_d"].numpy()
    t = a_d.shape[0] // 3
    rows = np.empty((t, 21), np.float32)
    for g in range(3):
        rows[:, 4 * g:4 * g + 4] = a_o[g * t:(g + 1) * t]
        rows[:, 12 + 3 * g:15 + 3 * g] = a_d[g * t:(g + 1) * t]
    return rows


def _city_rays(ts, n=2048, seed=0, miss_every=0):
    """Rays from around the city towards it; every `miss_every`-th one points
    away and up, so it leaves the scene without a hit, and every 11th one
    points straight down (two direction components exactly 0, the slab
    test's degenerate case)."""
    rng = np.random.default_rng(seed)
    lo = ts.woop["cmin64"].amin(dim=0).numpy()
    hi = ts.woop["cmax64"].amax(dim=0).numpy()
    hi = np.where(np.isfinite(hi), hi, 0.0)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    org[:, 1] = rng.uniform(hi[1] * 0.5, hi[1] * 1.5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    if miss_every:
        d[::miss_every, 1] = np.abs(d[::miss_every, 1]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[3::11] = np.array([0.0, -1.0, 0.0], np.float32)
    return _t(org), _t(d)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stored_tables_equal_per_launch_tables(name):
    ts = _trace_scene(name)
    woop = ts.woop
    rows = _old_rows(woop)
    np.testing.assert_array_equal(woop["coef_rows"].numpy(), rows)
    np.testing.assert_array_equal(wc.coef_rows(woop).numpy(), rows)
    assert woop["coef_rows"].is_contiguous()
    if name == "cornell":
        assert "coef_blocks" not in woop and "cmin64" not in woop
        return
    nt = rows.shape[0] // wc.CULL_TB
    slabs = rows.reshape(nt, wc.CULL_TB, 21).transpose(0, 2, 1)
    np.testing.assert_array_equal(woop["coef_blocks"].numpy(), slabs)
    np.testing.assert_array_equal(wc.coef_blocks(woop).numpy(), slabs)
    assert woop["coef_blocks"].is_contiguous()
    assert tuple(woop["coef_blocks"].shape) == (nt, 21, wc.CULL_TB)
    # the launches read the stored tensors, not copies
    org, d = _city_rays(ts, 512)
    assert wc.prepare_culled(woop, org, d).coef is woop["coef_blocks"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_culled_plain_same_bits_from_stored_table(city, mode):
    """The batch built from the stored slabs and one built from a table
    gathered afresh from a_o / a_d give the same (t, tri, u, v) bits."""
    any_hit, early_stop = MODES[mode]
    org, d = _city_rays(city, 1024, seed=1, miss_every=7)
    stored = wc.prepare_culled(city.woop, org, d)
    bare = {k: v for k, v in city.woop.items() if not k.startswith("coef_")}
    fresh = wc.prepare_culled(bare, org, d)
    assert fresh.coef is not stored.coef
    a = wc.culled_plain(stored, 1e-4, any_hit, early_stop)
    b = wc.culled_plain(fresh, 1e-4, any_hit, early_stop)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int((a[1] >= 0).sum()) > 0 and int((a[1] < 0).sum()) > 0


def test_brute_reads_stored_rows():
    ts = _trace_scene("cornell")
    rng = np.random.default_rng(2)
    org = _t(rng.uniform(-0.9, 0.9, (512, 3)).astype(np.float32))
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=-1, keepdims=True))
    bare = {k: v for k, v in ts.woop.items() if not k.startswith("coef_")}
    for a, b in zip(wc.intersect_brute_cuda(ts.woop, org, d),
                    wc.intersect_brute_cuda(bare, org, d)):
        assert torch.equal(a, b)
    for a, b in zip(woop_t.intersect_brute(ts.woop, org, d),
                    wc.intersect_brute_cuda(bare, org, d)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_refresh_after_moved_vertex_rebuilds_tables(name):
    """No cache outlives a refresh: moving one vertex changes the stored
    tables (the moved triangle's rows among them, not all rows) and leaves
    the old scene's tables as they were."""
    ts = _trace_scene(name)
    gpu = ts.gpu
    tri = 0
    vert = int(gpu.tri_idx[tri, 0])
    moved = gpu.verts_obj.clone()
    moved[vert] += torch.tensor([0.05, 0.03, -0.04])
    kw = dict(gpu.__dict__)
    kw["verts_obj"] = moved
    ts2 = refresh_trace_scene(type(gpu)(**kw))
    assert ts2.woop["coef_rows"] is not ts.woop["coef_rows"]
    changed = (ts2.woop["coef_rows"] != ts.woop["coef_rows"]).any(dim=1)
    assert bool(changed[tri]) and 0 < int(changed.sum()) < changed.numel()
    np.testing.assert_array_equal(ts2.woop["coef_rows"].numpy(),
                                  _old_rows(ts2.woop))
    np.testing.assert_array_equal(ts.woop["coef_rows"].numpy(),
                                  _old_rows(ts.woop))
    if name == "city4":
        np.testing.assert_array_equal(ts2.woop["coef_blocks"].numpy(),
                                      wc.coef_blocks(ts2.woop).numpy())
        assert not torch.equal(ts2.woop["coef_blocks"],
                               ts.woop["coef_blocks"])


def _divergent_batch(city, rb):
    """Unsorted, divergent rays with misses among them, in `rb`-ray chunks:
    every chunk keeps walking for its missing rays while most of its rays
    have long found their hit."""
    org, d = _city_rays(city, 1024, seed=3, miss_every=5)
    return wc.prepare_culled(city.woop, org, d, rb=rb)


@pytest.mark.parametrize("rb", [128, 512])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_per_ray_walk_returns_chunk_walk_bits(city, mode, rb):
    any_hit, early_stop = MODES[mode]
    b = _divergent_batch(city, rb)
    walked, pairs = [], []
    chunk = wc.culled_plain(b, 1e-4, any_hit, early_stop, visits=walked,
                            ray_visits=pairs)
    pairs_skip = []
    per_ray = wc.culled_plain(b, 1e-4, any_hit, early_stop, ray_skip=True,
                              ray_visits=pairs_skip)
    if any_hit:
        # any-hit promises the occlusion mask: a ray that stops at its first
        # hit need not hold the closest one
        assert torch.equal(chunk[1] >= 0, per_ray[1] >= 0)
        assert bool((per_ray[0][per_ray[1] >= 0] < 1e29).all())
    else:
        for x, y in zip(chunk, per_ray):
            assert torch.equal(x, y)
    walked, pairs = torch.cat(walked), torch.cat(pairs)
    assert torch.equal(pairs, torch.cat(pairs_skip))
    live = (b.tmax.reshape(-1, rb) > 1e-4).sum(dim=1)
    assert (pairs <= walked * live).all()
    miss = chunk[1].reshape(-1, rb) < 0
    assert bool(miss.any(dim=1).all()) and bool((~miss).any())
    if mode == "no_early_stop":
        # nothing but dead rays is left out
        assert torch.equal(pairs, walked * live)
    else:
        # the chunks walk on for their misses; rays that are done drop out
        assert int(pairs.sum()) < int((walked * live).sum())


def test_per_ray_walk_on_caller_lists(city):
    """Raster-style lists (every block listed for every chunk, bound 0): no
    bound can stop a ray, only the block boxes thin the per-ray walk; without
    early stop it tests what the chunk walk tests, minus dead rays."""
    org, d = _city_rays(city, 1024, seed=4, miss_every=3)
    nrb = 1024 // wc.CULL_RAY_BLOCK
    nt = city.woop["coef_blocks"].shape[0]
    lists = wc.sort_blocks_by_distance(torch.ones((nrb, nt), dtype=torch.bool),
                                       torch.zeros((nrb, nt)))
    b = wc.prepare_culled(city.woop, org, d, block_lists=lists)
    live = (b.tmax.reshape(-1, b.rb) > 1e-4).sum(dim=1)
    for early_stop in (True, False):
        walked, pairs = [], []
        chunk = wc.culled_plain(b, 1e-4, False, early_stop, visits=walked,
                                ray_visits=pairs)
        per_ray = wc.culled_plain(b, 1e-4, False, early_stop, ray_skip=True)
        for x, y in zip(chunk, per_ray):
            assert torch.equal(x, y)
        walked, pairs = torch.cat(walked), torch.cat(pairs)
        if early_stop:
            # a ray crosses few of the city's block boxes
            assert int(pairs.sum()) < 0.5 * int((walked * live).sum())
        else:
            assert torch.equal(pairs, walked * live)


def test_block_bounds_hold_their_triangles(city):
    """Every triangle of a block lies inside the block's padded box, and the
    pad is a thousandth of the scene's largest coordinate."""
    woop = city.woop
    box = woop["block_bounds"]
    nt = box.shape[0]
    assert tuple(box.shape) == (nt, 8) and box.is_contiguous()
    assert torch.equal(box, wc.block_bounds(woop))
    pts = torch.stack([city.v0, city.v0 + city.e1, city.v0 + city.e2], dim=1)
    n = pts.shape[0]
    blk = torch.arange(n) // wc.CULL_TB
    assert bool((pts >= box[blk, None, 0:3]).all())
    assert bool((pts <= box[blk, None, 4:7]).all())
    eps = (woop["cmin64"] - box[:, 0:3])[torch.isfinite(box[:, 0])].amax()
    big = max(float(woop["cmin64"].amin(dim=0).abs().amax()),
              float(woop["cmax64"].amax(dim=0).abs().amax()))
    assert 0.5e-3 * big < float(eps) < 2e-3 * big


@pytest.mark.parametrize("rb", [0, 16, 100, 1056])
def test_prepare_culled_refuses_bad_chunks(city, rb):
    org, d = _city_rays(city, 256)
    with pytest.raises(ValueError, match="multiple of 32"):
        wc.prepare_culled(city.woop, org, d, rb=rb)
