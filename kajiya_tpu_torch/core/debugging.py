"""Debug utilities: NaN guards and the pass-output hook (port of
`kajiya_tpu/core/debugging.py`).

`check_finite` sweeps a FrameState (or an outputs dict) and names the planes
that hold a NaN or an Inf: the crash-marker analog of the reference
(`vulkan/error.rs:35-81`). `debug_view` is the GraphDebugHook analog: it
routes any intermediate output to the display slot."""
from __future__ import annotations

import numpy as np
import torch


def check_finite(state: dict, where: str = "") -> list[str]:
    """Names of the floating-point planes of `state` that are not finite.
    Every plane is checked where it lies; the flags come back to the host
    in one read."""
    names = [k for k, v in state.items()
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not names:
        return []
    ok = torch.stack([torch.isfinite(state[k]).all() for k in names]).cpu()
    return [k for k, good in zip(names, ok.tolist()) if not good]


def assert_finite(state: dict, where: str = ""):
    bad = check_finite(state, where)
    if bad:
        raise FloatingPointError(
            f"non-finite renderer state{' after ' + where if where else ''}: "
            f"{bad}")


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.percentile(x, q)` (linear interpolation, NaN if any element is
    NaN) as a 0-d float32 tensor, through `torch.kthvalue`: `torch.quantile`
    refuses inputs above 2^24 elements. The rank and the weights are
    computed in float32, as JAX computes them (XLA turns q / 100 into a
    product with the float32 reciprocal)."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    frac = np.float32(q) * (np.float32(1) / np.float32(100))
    pos = frac * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = np.float32(1) - w_hi
    lo = int(min(max(lo, 0), n - 1))
    hi = int(min(max(hi, 0), n - 1))
    a = torch.kthvalue(flat, lo + 1).values
    b = a if hi == lo else torch.kthvalue(flat, hi + 1).values
    out = a * float(w_lo) + b * float(w_hi)
    return torch.where(torch.isnan(flat).any(), float("nan"), out)


def debug_view(outputs: dict, hook: str | None):
    """Route an intermediate buffer to the final image (GraphDebugHook,
    `kajiya-rg/src/graph.rs:592-657`). hook = output key, e.g. 'ssao',
    'shadow', 'diffuse_gi'. Returns an (H, W, 3) image in [0, 1], scaled
    by the 99th percentile."""
    if not hook or hook not in outputs:
        return outputs["final"]
    img = outputs[hook]
    if isinstance(img, dict):      # gbuffer sub-dict: show albedo
        img = img.get("albedo", next(iter(img.values())))
    img = img.float()
    if img.ndim == 2:
        img = img[..., None].expand(img.shape + (3,))
    if img.shape[-1] > 3:
        img = img[..., :3]
    mx = torch.clamp(percentile(img, 99.0), min=1e-6)
    return torch.clamp(img / mx, 0.0, 1.0)
