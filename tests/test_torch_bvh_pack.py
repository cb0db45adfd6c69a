"""The walk kernel's packed tables (`rt.bvh.pack_walk_tables` of the port):
the node, leaf and child-pair records hold the `Bvh` arrays and the world
triangle SoA bit for bit, a repack after `refit_bvh` equals a pack of a
fresh refit (the JAX package's refit included), and the trace scene carries
them on the BVH route only. All on the CPU; the kernel that reads them runs
on the card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kajiya_tpu.rt import bvh as bvh_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.rt import bvh as bvh_t
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t
from kajiya_tpu_torch.world import build_trace_scene, refresh_trace_scene

SCENES = {"soup1": lambda p: p.random_tri_soup(1, seed=1),
          "soup64": lambda p: p.random_tri_soup(64, seed=64),
          "soup500": lambda p: p.random_tri_soup(500, seed=500),
          "cornell": lambda p: p.cornell_box(),
          "city2": lambda p: p.city(n=2, subdiv=4)}


def bits(x):
    return x.contiguous().view(torch.int32)


def unpack(nodes, leaves, leaf_size):
    """The `Bvh` arrays and per-slot triangles read back from the tables."""
    n = nodes.shape[0]
    skip = bits(nodes[:, 3])
    link = bits(nodes[:, 7])
    leaf = link < 0
    first = torch.where(leaf, -1 - link, 0)
    ids = bits(leaves[:, 3])
    slot = first[:, None] + torch.arange(leaf_size)[None]
    count = torch.where(leaf, (ids[slot.clamp(max=ids.shape[0] - 1)] >= 0)
                        .sum(dim=1).to(torch.int32), 0)
    right = skip[torch.clamp(torch.arange(1, n + 1), max=n - 1)]
    return dict(node_min=nodes[:, 0:3], node_max=nodes[:, 4:7],
                node_first=first, node_count=count, node_skip=skip,
                tri_order=ids, right=right, link=link,
                v0=leaves[:, 0:3], e1=leaves[:, 4:7], e2=leaves[:, 8:11],
                spare=leaves[:, [7, 11]])


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.contiguous().numpy().tobytes() == b.contiguous().numpy().tobytes()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pack_round_trips(scene):
    gpu = build_gpu_t(SCENES[scene](proc_t), device="cpu")
    bvh, _, tris = bvh_t.bvh_from_scene(gpu)
    nodes, leaves, pairs = bvh_t.pack_walk_tables(bvh, tris)
    assert nodes.dtype == leaves.dtype == pairs.dtype == torch.float32
    assert nodes.shape == (bvh.num_nodes, 8) and nodes.is_contiguous()
    assert leaves.shape == (bvh.tri_order.shape[0], 12)
    assert leaves.is_contiguous()
    assert pairs.shape == (bvh.num_nodes, 16) and pairs.is_contiguous()
    got = unpack(nodes, leaves, bvh.leaf_size)
    for f in ("node_min", "node_max", "node_first", "node_count",
              "node_skip", "tri_order"):
        assert same_bits(got[f], getattr(bvh, f)), f
    # an internal node's link is its right child, whose subtree follows the
    # left child's (i + 1)
    inner = bvh.node_count == 0
    assert torch.equal(got["link"][inner], got["right"][inner])
    assert bool((got["link"][inner] > torch.arange(bvh.num_nodes)[inner])
                .all())
    # a leaf's run is leaf-aligned; its triangles first, then padding
    assert bool((got["node_first"] % bvh.leaf_size == 0).all())
    t = bvh.tri_order
    live = t >= 0
    safe = torch.clamp(t, min=0).long()
    for name, src in zip(("v0", "e1", "e2"), tris):
        assert same_bits(got[name][live], src[safe][live]), name
        assert bool((got[name][~live] == 0).all()), name
    assert bool((got["spare"] == 0).all())
    # a pair record: the children's boxes and links, the right child's index
    link = got["link"]
    idx = torch.nonzero(inner)[:, 0]
    c0, c1 = idx + 1, link[idx].long()
    pi = pairs[idx]
    assert same_bits(pi[:, 0:3], bvh.node_min[c0])
    assert same_bits(pi[:, 4:7], bvh.node_max[c0])
    assert same_bits(pi[:, 8:11], bvh.node_min[c1])
    assert same_bits(pi[:, 12:15], bvh.node_max[c1])
    assert torch.equal(bits(pi[:, 3]), link[c0])
    assert torch.equal(bits(pi[:, 7]), link[c1])
    assert torch.equal(bits(pi[:, 11]).long(), c1)
    assert bool((pi[:, 15] == 0).all()) and bool((pairs[~inner] == 0).all())


@pytest.mark.parametrize("n", [64, 500])
def test_repack_after_refit_equals_a_fresh_refit(n):
    """Move every instance: the port's refit repacked equals a pack of the
    JAX package's refit of the same move, and refresh_trace_scene repacks
    after its refit."""
    gpu_j = build_gpu_j(proc_j.random_tri_soup(n, seed=7))
    gpu_t = build_gpu_t(proc_t.random_tri_soup(n, seed=7), device="cpu")
    bj, lj, _ = bvh_j.bvh_from_scene(gpu_j)
    ts, levels = build_trace_scene(gpu_t, device="cpu", brute_max_tris=0)
    built = ts.walk_tables
    shift = np.zeros((3, 4), np.float32)
    shift[:, 3] = (3.0, -1.25, 0.5)
    gpu_j.xforms = gpu_j.xforms + jnp.asarray(shift)[None]
    ts.gpu.xforms = ts.gpu.xforms + torch.as_tensor(shift)[None]
    moved = refresh_trace_scene(ts.gpu, ts.bvh, levels)
    tris = moved.tris
    rj = bvh_j.refit_bvh(bj, lj, *gpu_j.triangle_corners())
    fresh = bvh_t.pack_walk_tables(
        convert.bvh_from_numpy(convert.to_numpy_dict(rj), "cpu"), tris)
    again = bvh_t.pack_walk_tables(
        bvh_t.refit_bvh(moved.bvh, levels["levels"], *tris), tris)
    for a, b, c in zip(moved.walk_tables, fresh, again):
        assert same_bits(a, b) and same_bits(a, c)
    assert not same_bits(built[0], moved.walk_tables[0])


def test_trace_scene_carries_tables_on_the_bvh_route_only():
    gpu = build_gpu_t(proc_t.cornell_box(), device="cpu")
    ts, _ = build_trace_scene(gpu, device="cpu", brute_max_tris=0)
    for a, b in zip(ts.walk_tables,
                    bvh_t.pack_walk_tables(ts.bvh, ts.tris)):
        assert same_bits(a, b)
    ts_w, _ = build_trace_scene(gpu, device="cpu")
    assert ts_w.bvh is None and ts_w.walk_tables is None


@pytest.mark.parametrize("leaf_size", [1, 2, 4])
def test_walk_depth_is_the_bvh_depth(leaf_size):
    """`walk_depth` (the front-to-back walk's stack size, a kernel launch
    argument) counts the internal levels of the builders' BVH: the refit
    schedule has one level for each."""
    from kajiya_tpu_torch.rt.trace import walk_depth

    rng = np.random.default_rng(leaf_size)
    for n in (1, 2, 4, 5, 7, 17, 64, 500, 1000, 4097):
        c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
        _, levels = bvh_t.build_bvh(c - 0.1, c + 0.1, leaf_size=leaf_size)
        assert walk_depth(n, leaf_size) == len(levels), n
    assert walk_depth(1_228_802, 4) == 19       # city40
