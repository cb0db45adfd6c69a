"""Row fetches (port of `kajiya_tpu/ops/gather.py`).

The JAX module recasts small-table gathers as one-hot MXU matmuls and keeps
results lane-major; on the GPU a gather is a plain indexed load, so these
collapse to indexing. The row-major (R, C) layout is kept.
"""
from __future__ import annotations


def interp3_rows(table, i0, i1, i2, w0, w1, w2):
    """Barycentric-weighted 3-row fetch:
    out[r] = w0[r]*table[i0[r]] + w1[r]*table[i1[r]] + w2[r]*table[i2[r]]."""
    return (table[i0] * w0[:, None] + table[i1] * w1[:, None]
            + table[i2] * w2[:, None])
