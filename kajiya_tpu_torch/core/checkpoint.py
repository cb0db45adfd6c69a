"""FrameState checkpoint / resume (port of `kajiya_tpu/core/checkpoint.py`).

The FrameState dict of tensors is the renderer's whole temporal state, so
writing it out gives failure recovery and bit-exact resume of temporal
accumulation (the reference path tracer's included). The file is the JAX
module's `.npz` of one array per key, so either package reads the other's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device


def save_state(state: dict, path: str):
    """Write a FrameState (flat dict of tensors) as .npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in state.items()}
    np.savez(path, **flat)


def load_state(path: str, like: dict | None = None, device=None) -> dict:
    """Load a FrameState onto `device` (default CUDA). When `like` is
    given, its keys and shapes are checked against it (resolution or config
    drift raises ValueError rather than rendering garbage)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        out = {k: torch.as_tensor(z[k], device=dev) for k in z.files}
    if like is not None:
        missing = set(like) - set(out)
        extra = set(out) - set(like)
        if missing or extra:
            raise ValueError(
                f"checkpoint mismatch: missing={sorted(missing)} "
                f"extra={sorted(extra)}")
        for k in like:
            if tuple(out[k].shape) != tuple(like[k].shape):
                raise ValueError(
                    f"checkpoint {k}: shape {tuple(out[k].shape)} != "
                    f"expected {tuple(like[k].shape)}")
    return out
