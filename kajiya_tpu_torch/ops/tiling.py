"""Screen-tile reordering for coherent ray chunks (port of
`kajiya_tpu/ops/tiling.py`): (H, W, ...) <-> tile-major flat order, tiles of
TILE_H x TILE_W pixels, edge-padded. Pure reshape/permute."""
from __future__ import annotations

import torch

TILE_H = 64
TILE_W = 128


def pad_hw(h: int, w: int, th: int = TILE_H, tw: int = TILE_W):
    return (-h) % th, (-w) % tw


def _pad_edge(img, n: int, axis: int):
    """Append n copies of the last slice along `axis` (numpy's mode="edge")."""
    if not n:
        return img
    edge = img.narrow(axis, img.shape[axis] - 1, 1)
    return torch.cat([img, edge.expand(*[n if a == axis else -1
                                         for a in range(img.ndim)])], dim=axis)


def tile_order(img, th: int = TILE_H, tw: int = TILE_W):
    """(H, W, ...) -> (N, ...) flattened in tile-major order (edge-padded)."""
    ph, pw = pad_hw(img.shape[0], img.shape[1], th, tw)
    img = _pad_edge(_pad_edge(img, ph, 0), pw, 1)
    hh, ww = img.shape[0], img.shape[1]
    rest = tuple(img.shape[2:])
    x = img.reshape((hh // th, th, ww // tw, tw) + rest).transpose(1, 2)
    return x.reshape((-1,) + rest)


def untile_order(flat, h: int, w: int, th: int = TILE_H, tw: int = TILE_W):
    """Inverse of tile_order: (N, ...) -> (H, W, ...) with padding cropped."""
    ph, pw = pad_hw(h, w, th, tw)
    hh, ww = h + ph, w + pw
    rest = tuple(flat.shape[1:])
    x = flat.reshape((hh // th, ww // tw, th, tw) + rest).transpose(1, 2)
    return x.reshape((hh, ww) + rest)[:h, :w]
