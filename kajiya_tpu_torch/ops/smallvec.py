"""Small-vector linear algebra over big batches (port of
`kajiya_tpu/ops/smallvec.py`).

The JAX module unrolls tiny contractions to dodge a TPU compiler pathology;
here the unrolled forms are kept because they fix the summation order, which
keeps the port's float results next to the JAX ones.
"""
from __future__ import annotations

import torch


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(a):
    return torch.sqrt(torch.clamp(dot3(a, a), min=1e-24))


def matvec(m, v):
    """m: (I, K) small shared matrix; v: (..., K) -> (..., I)."""
    i, k = m.shape
    cols = []
    for ii in range(i):
        acc = v[..., 0] * m[ii, 0]
        for kk in range(1, k):
            acc = acc + v[..., kk] * m[ii, kk]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def transform_dirs(m, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
                        for i in range(3)], dim=-1)


def transform_h(m, p):
    """m: (4, 4); p: (..., 4) -> (..., 4)."""
    return matvec(m, p)


def matmul_small(a, b):
    """a: (..., K); b: (K, N) small shared matrix -> (..., N)."""
    k, n = b.shape
    cols = []
    for j in range(n):
        acc = a[..., 0] * b[0, j]
        for kk in range(1, k):
            acc = acc + a[..., kk] * b[kk, j]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def pow8(x):
    """x ** 8 by three squarings (the order XLA's integer power takes, so
    the weights built from it round as the JAX ones do)."""
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4
