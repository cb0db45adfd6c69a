"""Device selection for the port's entry points.

Every entry point (`Renderer`, `build_gpu_scene`, `build_trace_scene`,
`make_view_constants`) takes an explicit `device`. It defaults to CUDA and
raises when no CUDA device exists: the port never slips onto the CPU unless
the caller asks for it with `device="cpu"` (as the CPU parity tests do).
"""
from __future__ import annotations

from functools import lru_cache

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kajiya_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def _new_const(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


# the cache lives on across an importlib.reload of this module
# (core/reload.py): the tensors it handed out stay the ones it returns
_const = globals().get("_const") or lru_cache(maxsize=256)(_new_const)


def const_tensor(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor, built once per (values, dtype, device) and
    reused: building it anew on every call would be a host-to-device copy
    per pass per frame. `values` is a (nested) tuple of numbers. Callers
    must not write into the result."""
    return _const(values, dtype, torch.device(device))
