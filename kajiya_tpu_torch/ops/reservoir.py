"""Weighted reservoir sampling (streaming RIS) as plain tensor functions
(port of `kajiya_tpu/ops/reservoir.py`).

A "reservoir texture" is a dict of planar tensors and the stochastic update
is an elementwise `where`. Conventions (Bitterli et al. 2020):
  * a candidate with source pdf p and target value p_hat enters with
    w = p_hat / p (or an externally supplied weight);
  * after streaming, the unbiased contribution weight is
    W = w_sum / (M * p_hat_selected).
Payloads are dicts of tensors that share the lanes' leading shape.
"""
from __future__ import annotations

import torch


def init(lane_shape, payload_zero):
    """Reservoir dict with empty state. lane_shape e.g. (H, W)."""
    dev = next(iter(payload_zero.values())).device

    def z():
        return torch.zeros(lane_shape, dtype=torch.float32, device=dev)

    return {"payload": payload_zero, "w_sum": z(), "M": z(), "W": z(),
            "p_hat": z()}


def _select(cond, a, b):
    def sel(x, y):
        c = cond
        while c.ndim < x.ndim:
            c = c[..., None]
        return torch.where(c, x, y)

    return {k: sel(a[k], b[k]) for k in a}


def update(res, payload, w, p_hat, u, m: float = 1.0, mask=None):
    """Stream one candidate into the reservoir.

    w: RIS weight of the candidate (p_hat / source_pdf). u: uniform [0,1)
    per lane. m: the candidate's M (sample count). mask: lanes where the
    candidate exists. Returns the new reservoir."""
    w = torch.clamp(w, min=0.0)
    if mask is not None:
        w = torch.where(mask, w, 0.0)
        m_eff = torch.where(mask, m, 0.0)
    else:
        m_eff = torch.full_like(w, m)
    w_sum = res["w_sum"] + w
    take = (u * w_sum < w) & (w > 0.0)
    new = {
        "payload": _select(take, payload, res["payload"]),
        "w_sum": w_sum,
        "M": res["M"] + m_eff,
        "p_hat": torch.where(take, p_hat, res["p_hat"]),
    }
    new["W"] = contribution_weight(new)
    return new


def merge(res, other, p_hat_other_here, u, m_clamp=None, mask=None,
          w_scale=None):
    """Merge another reservoir in (spatial / temporal reuse). The neighbour's
    sample is re-evaluated with our target function (`p_hat_other_here`);
    its RIS weight is p_hat * W_other * M_other, and the merged M adds the
    neighbour's (clamped) M. `w_scale` is an extra factor on the RIS weight:
    the reconnection jacobian when the sample moves between surface points."""
    m_other = other["M"]
    if m_clamp is not None:
        m_other = torch.clamp(m_other, max=m_clamp)
    w = torch.clamp(p_hat_other_here * other["W"] * m_other, min=0.0)
    if w_scale is not None:
        w = w * w_scale
    if mask is not None:
        w = torch.where(mask, w, 0.0)
        m_other = torch.where(mask, m_other, 0.0)
    w_sum = res["w_sum"] + w
    take = (u * w_sum < w) & (w > 0.0)
    new = {
        "payload": _select(take, other["payload"], res["payload"]),
        "w_sum": w_sum,
        "M": res["M"] + m_other,
        "p_hat": torch.where(take, p_hat_other_here, res["p_hat"]),
    }
    new["W"] = contribution_weight(new)
    return new


def contribution_weight(res):
    """Unbiased contribution weight W = w_sum / (M * p_hat)."""
    denom = res["M"] * res["p_hat"]
    return torch.where(denom > 1e-8,
                       res["w_sum"] / torch.clamp(denom, min=1e-8), 0.0)


def clamp_m(res, m_max):
    """History clamp: caps M to bound staleness."""
    scale = torch.clamp(m_max / torch.clamp(res["M"], min=1e-8), max=1.0)
    out = dict(res)
    out["M"] = res["M"] * scale
    out["w_sum"] = res["w_sum"] * scale
    out["W"] = contribution_weight(out)
    return out
