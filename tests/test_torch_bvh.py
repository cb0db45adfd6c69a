"""Port parity, the BVH build and refit (`kajiya_tpu_torch/rt/bvh.py`)
against `kajiya_tpu/rt/bvh.py`: the Python builder and the native builder
(the port's own copy of the C++ source, built with g++ at first use) give
JAX's bytes, levels included; the refit gives JAX's bits; a native build
that cannot be made raises instead of falling back."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kajiya_tpu.rt import bvh as bvh_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu.scene.scene import build_gpu_scene as build_gpu_j
from kajiya_tpu_torch.rt import bvh as bvh_t
from kajiya_tpu_torch.scene import procedural as proc_t
from kajiya_tpu_torch.scene.scene import build_gpu_scene as build_gpu_t

FIELDS = ("node_min", "node_max", "node_first", "node_count", "node_skip",
          "tri_order")


def _boxes(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - h, c + h


def assert_same_bvh(a, b, levels_a, levels_b):
    """Byte for byte: every array (values and dtype) and every level."""
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), getattr(b, f)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert int(a.leaf_size) == int(b.leaf_size)
    assert len(levels_a) == len(levels_b)
    for la, lb in zip(levels_a, levels_b):
        for x, y in zip(la, lb):
            y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("n", [1, 3, 7, 17, 64, 500, 1000, 4097])
def test_build_bvh_matches_jax(n):
    tmin, tmax = _boxes(n, seed=n)
    bj, lj = bvh_j.build_bvh(tmin, tmax, leaf_size=4)
    bt, lt = bvh_t.build_bvh(tmin, tmax, leaf_size=4)
    assert_same_bvh(bj, bt, lj, lt)
    assert bt.num_nodes == bj.num_nodes


@pytest.mark.parametrize("n", [3, 17, 1000, 4097])
def test_native_build_matches_jax_native_and_python(n):
    tmin, tmax = _boxes(n, seed=n)
    cj, lcj = bvh_j.build_bvh_native(tmin, tmax, leaf_size=4)
    ct, lct = bvh_t.build_bvh_native(tmin, tmax, leaf_size=4)
    pt, lpt = bvh_t.build_bvh(tmin, tmax, leaf_size=4)
    assert_same_bvh(cj, ct, lcj, lct)
    assert_same_bvh(pt, ct, lpt, lct)


def test_native_build_of_a_large_scene_matches_jax():
    """A city above NATIVE_BUILD_MIN_TRIS through `bvh_from_scene` (the
    native builder on both sides), and the triangle SoA it returns."""
    bj, lj, (v0j, _e1j, _e2j) = bvh_j.bvh_from_scene(
        build_gpu_j(proc_j.city(n=6, subdiv=8)))
    bt, lt, (v0t, _e1t, _e2t) = bvh_t.bvh_from_scene(
        build_gpu_t(proc_t.city(n=6, subdiv=8), device="cpu"))
    assert v0t.shape[0] >= bvh_t.NATIVE_BUILD_MIN_TRIS
    assert_same_bvh(bj, bt, lj, lt)
    np.testing.assert_array_equal(v0t.numpy(), np.asarray(v0j))


@pytest.mark.parametrize("scene", ["soup64", "soup500", "cornell",
                                   "single_triangle"])
def test_bvh_from_scene_matches_jax(scene):
    make = {"soup64": lambda p: p.random_tri_soup(64, seed=64),
            "soup500": lambda p: p.random_tri_soup(500, seed=500),
            "cornell": lambda p: p.cornell_box(),
            "single_triangle": lambda p: p.single_triangle()}[scene]
    bj, lj, tris_j = bvh_j.bvh_from_scene(build_gpu_j(make(proc_j)))
    bt, lt, tris_t = bvh_t.bvh_from_scene(
        build_gpu_t(make(proc_t), device="cpu"))
    assert_same_bvh(bj, bt, lj, lt)
    assert isinstance(bt.node_min, torch.Tensor)
    for a, b in zip(tris_j, tris_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _moved(gpu_j, gpu_t, shift):
    """Both scenes with every instance translated by `shift`."""
    s = np.zeros((3, 4), np.float32)
    s[:, 3] = shift
    gpu_j.xforms = gpu_j.xforms + jnp.asarray(s)[None]
    gpu_t.xforms = gpu_t.xforms + torch.as_tensor(s)[None]
    return gpu_j.triangle_corners(), gpu_t.triangle_corners()


@pytest.mark.parametrize("n", [64, 100, 500])
def test_refit_matches_jax_bit_for_bit(n):
    gpu_j = build_gpu_j(proc_j.random_tri_soup(n, seed=11))
    gpu_t = build_gpu_t(proc_t.random_tri_soup(n, seed=11), device="cpu")
    bj, lj, _ = bvh_j.bvh_from_scene(gpu_j)
    bt, lt, _ = bvh_t.bvh_from_scene(gpu_t)
    tris_j, tris_t = _moved(gpu_j, gpu_t, (100.0, -3.5, 0.25))
    rj = bvh_j.refit_bvh(bj, lj, *tris_j)
    rt = bvh_t.refit_bvh(bt, bvh_t.refit_schedule(lt, "cpu"), *tris_t)
    assert_same_bvh(rj, rt, [], [])
    # the root contains every vertex of the moved scene
    v0, e1, e2 = (x.numpy() for x in tris_t)
    pts = np.concatenate([v0, v0 + e1, v0 + e2])
    assert np.all(rt.node_min[0].numpy() <= pts.min(0))
    assert np.all(rt.node_max[0].numpy() >= pts.max(0))


def test_refit_of_the_build_gives_its_bounds():
    """Refit at the build's own geometry restores the built bounds."""
    gpu_t = build_gpu_t(proc_t.city(n=2, subdiv=4), device="cpu")
    bt, lt, tris = bvh_t.bvh_from_scene(gpu_t)
    rt = bvh_t.refit_bvh(bt, bvh_t.refit_schedule(lt, "cpu"), *tris)
    assert torch.equal(rt.node_min, bt.node_min)
    assert torch.equal(rt.node_max, bt.node_max)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_native_build_raises(compiler, monkeypatch, tmp_path):
    """No fallback: where the builder cannot be compiled, a scene of
    NATIVE_BUILD_MIN_TRIS triangles or more raises with the compiler's
    output; smaller scenes keep the Python builder."""
    monkeypatch.setattr(bvh_t, "_builder", None)
    monkeypatch.setattr(bvh_t, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(bvh_t, "CXX", {
        "missing": str(tmp_path / "no-such-compiler"),
        "failing": "false"}[compiler])
    with pytest.raises(RuntimeError, match="could not be built"):
        bvh_t.build_bvh_native(*_boxes(100))
    called = []
    monkeypatch.setattr(bvh_t, "build_bvh",
                        lambda *a, **k: called.append(1))
    gpu = build_gpu_t(proc_t.random_tri_soup(bvh_t.NATIVE_BUILD_MIN_TRIS,
                                             seed=1), device="cpu")
    with pytest.raises(RuntimeError, match="could not be built"):
        bvh_t.bvh_from_scene(gpu)
    assert not called
    assert not list(tmp_path.glob("*.so"))


def test_bvh_to_device_keeps_dtypes():
    bt, _ = bvh_t.build_bvh(*_boxes(17))
    b = bt.to("cpu")
    assert b.node_min.dtype == torch.float32
    assert b.node_max.dtype == torch.float32
    for f in ("node_first", "node_count", "node_skip", "tri_order"):
        assert getattr(b, f).dtype == torch.int32, f
    assert b.leaf_size == 4 and b.num_nodes == bt.num_nodes
