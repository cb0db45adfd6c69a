"""Port parity, kernel S: the plain version of the per-tile shift against
`kajiya_tpu.ops.tileshift_pallas.tile_shift` (which runs its bit-identical
XLA gather off the TPU) on the same numpy inputs. Pure data movement, so the
tolerance is exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from kajiya_tpu.ops import tileshift_pallas as ts_j
from kajiya_tpu_torch.ops import tileshift_cuda as ts_t

SHAPES = [(16, 256, 3), (45, 200, 20), (540, 960, 1), (23, 130)]


def _case(shape, seed, mode):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape).astype(np.float32)
    nty, ntx = ts_t.tile_grid(shape[0], shape[1])
    n = nty * ntx
    if mode == "inside":           # within the clip range
        dy = rng.integers(-ts_t.MAX_DY, ts_t.MAX_DY + 1, n)
        dx = rng.integers(-ts_t.MAX_DX, ts_t.MAX_DX + 1, n)
    elif mode == "beyond":         # beyond +-16 / +-64: clipped
        dy = rng.integers(-40, 41, n)
        dx = rng.integers(-200, 201, n)
    else:                          # the extremes: every edge tile clamps
        dy = rng.choice([-ts_t.MAX_DY, ts_t.MAX_DY, -1000, 1000], n)
        dx = rng.choice([-ts_t.MAX_DX, ts_t.MAX_DX, -1000, 1000], n)
    return img, dy.astype(np.int32), dx.astype(np.int32)


def test_tile_grid_matches():
    for h, w in [(8, 128), (9, 129), (540, 960), (1, 1), (23, 130)]:
        assert ts_t.tile_grid(h, w) == ts_j.tile_grid(h, w)
    assert (ts_t.TH, ts_t.TW, ts_t.MAX_DY, ts_t.MAX_DX) == (
        ts_j.TH, ts_j.TW, ts_j.MAX_DY, ts_j.MAX_DX)


@pytest.mark.parametrize("mode", ["inside", "beyond", "extreme"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_shift_equals_jax_exactly(shape, mode):
    img, dy, dx = _case(shape, seed=len(shape) + shape[0], mode=mode)
    ref = np.asarray(ts_j.tile_shift(jnp.asarray(img), jnp.asarray(dy),
                                     jnp.asarray(dx)))
    got = ts_t.tile_shift(torch.as_tensor(img), torch.as_tensor(dy),
                          torch.as_tensor(dx))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_tile_shift_zero_offsets_is_identity():
    img, dy, _ = _case((45, 200, 20), 5, "inside")
    z = torch.zeros(dy.shape, dtype=torch.int32)
    got = ts_t.tile_shift(torch.as_tensor(img), z, z)
    np.testing.assert_array_equal(got.numpy(), img)


def test_tile_shift_rejects_wrong_offset_count():
    img = torch.zeros((16, 256, 3))
    bad = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="one offset per tile"):
        ts_t.tile_shift(img, bad, bad)


def test_tile_shift_launch_raises_without_card(monkeypatch):
    """CUDA-typed tensors (fake tensors: no card here) must go to the kernel
    path and raise, never to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def fail(*_a, **_k):
        raise AssertionError("plain version called for a CUDA request")

    monkeypatch.setattr(ts_t, "tile_shift_plain", fail)
    with FakeTensorMode():
        dev = torch.device("cuda")
        img = torch.zeros((16, 256, 3), device=dev)
        off = torch.zeros((4,), dtype=torch.int32, device=dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            ts_t.tile_shift(img, off, off)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts_t.tile_shift_launch(torch.zeros((16, 256, 3)),
                               torch.zeros((4,), dtype=torch.int32),
                               torch.zeros((4,), dtype=torch.int32))
