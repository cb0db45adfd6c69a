"""The port's FrameState checkpoint (`kajiya_tpu_torch/core/checkpoint.py`,
port of `kajiya_tpu/core/checkpoint.py`): round trip, the key and shape
validation, bit-exact resume of the reference accumulation, and the file
format shared with the JAX module (as in `tests/test_aux.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core.checkpoint import load_state as load_j
from kajiya_tpu.core.checkpoint import save_state as save_j
from kajiya_tpu_torch.core.camera import make_view_constants
from kajiya_tpu_torch.core.checkpoint import load_state, save_state
from kajiya_tpu_torch.frame import (RenderConfig, init_frame_state,
                                    init_reference_state,
                                    render_frame_reference)
from kajiya_tpu_torch.scene.procedural import cornell_box
from kajiya_tpu_torch.scene.scene import build_gpu_scene
from kajiya_tpu_torch.world import build_trace_scene


def test_roundtrip(tmp_path):
    state = {"a": torch.ones((4, 4)),
             "idx": torch.tensor(3, dtype=torch.int32),
             "mask": torch.tensor([True, False])}
    p = str(tmp_path / "ck.npz")
    save_state(state, p)
    out = load_state(p, like=state, device="cpu")
    for k, v in state.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v), k


@pytest.mark.parametrize("like", [{"a": torch.ones((8, 8))},
                                  {"a": torch.ones((4, 4)),
                                   "b": torch.ones(2)},
                                  {}])
def test_mismatch_rejected(tmp_path, like):
    """A shape that differs, a key the file lacks and a key it has in
    excess each raise ValueError."""
    p = str(tmp_path / "ck.npz")
    save_state({"a": torch.ones((4, 4))}, p)
    with pytest.raises(ValueError, match="checkpoint"):
        load_state(p, like=like, device="cpu")


def test_resume_reference_accumulation(tmp_path):
    """Checkpoint after 2 of 4 progressive PT frames and resume from the
    file: the same bits as the uninterrupted run."""
    cfg = RenderConfig(width=32, height=24, max_trace_steps=128)
    ts, _ = build_trace_scene(build_gpu_scene(cornell_box(), device="cpu"),
                              device="cpu")
    view = make_view_constants((0, 0, 2.4), (0, 0, -1), width=32, height=24,
                               device="cpu")

    def step(s):
        return render_frame_reference(ts, s, view, cfg, num_bounces=3)

    s = init_reference_state(cfg, device="cpu")
    for _ in range(4):
        s, out_a = step(s)
    s2 = init_reference_state(cfg, device="cpu")
    for _ in range(2):
        s2, _ = step(s2)
    p = str(tmp_path / "pt.npz")
    save_state(s2, p)
    s3 = load_state(p, like=s2, device="cpu")
    for _ in range(2):
        s3, out_b = step(s3)
    assert set(s3) == set(s)
    for k in s:
        assert torch.equal(s3[k], s[k]), k
    assert torch.equal(out_a["final"], out_b["final"])


def test_file_format_shared_with_jax(tmp_path):
    """A file the JAX module wrote loads into the port, and the port's
    into the JAX module, with the same values and dtypes; a hybrid
    FrameState round-trips with its integer planes intact."""
    p = str(tmp_path / "j.npz")
    sj = {"a": jnp.arange(6.0).reshape(2, 3),
          "idx": jnp.asarray(5, jnp.int32)}
    save_j(sj, p)
    st = load_state(p, like={"a": torch.zeros(2, 3),
                             "idx": torch.zeros(())}, device="cpu")
    assert st["idx"].dtype == torch.int32 and int(st["idx"]) == 5
    np.testing.assert_array_equal(st["a"].numpy(), np.asarray(sj["a"]))
    q = str(tmp_path / "t.npz")
    save_state(st, q)
    back = load_j(q, like=sj)
    np.testing.assert_array_equal(np.asarray(back["a"]), np.asarray(sj["a"]))
    fs = init_frame_state(RenderConfig(width=16, height=12), device="cpu")
    save_state(fs, q)
    fs2 = load_state(q, like=fs, device="cpu")
    for k in fs:
        assert fs2[k].dtype == fs[k].dtype and torch.equal(fs2[k], fs[k]), k
