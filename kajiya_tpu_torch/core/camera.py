"""Camera math (port of `kajiya_tpu/core/camera.py`): reversed-infinite-Z
projection, the view-constant bundle and primary camera rays.

Conventions as in the JAX module: right-handed view space looking down -Z,
reversed infinite depth (near -> 1, infinity -> 0), (4, 4) float32 matrices
in the column-vector convention p' = M @ p.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

from ..device import const_tensor, resolve_device
from ..ops.smallvec import cross, transform_dirs, transform_h


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def perspective_reversed_infinite_z(fov_y_rad, aspect_w_over_h, near, device):
    f = 1.0 / torch.tan(_f32(fov_y_rad, device) * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = f / aspect_w_over_h
    m[1, 1] = f
    m[2, 3] = near
    m[3, 2] = -1.0
    return m


def inverse_perspective_reversed_infinite_z(fov_y_rad, aspect_w_over_h, near,
                                            device):
    f = 1.0 / torch.tan(_f32(fov_y_rad, device) * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = aspect_w_over_h / f
    m[1, 1] = 1.0 / f
    m[2, 3] = -1.0
    m[3, 2] = 1.0 / near
    return m


def look_rotation(forward, up, device):
    """3x3 world-from-view rotation whose -Z column is `forward`."""
    fwd = _f32(forward, device)
    fwd = fwd / torch.linalg.norm(fwd)
    right = cross(fwd, _f32(up, device))
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-8)
    true_up = cross(right, fwd)
    return torch.stack([right, true_up, -fwd], dim=1)


def world_to_view_from(position, rotation3):
    pos = _f32(position, rotation3.device)
    r_t = rotation3.T
    m = torch.eye(4, dtype=torch.float32, device=rotation3.device)
    m[:3, :3] = r_t
    m[:3, 3] = -(r_t @ pos)
    return m


def view_to_world_from(position, rotation3):
    m = torch.eye(4, dtype=torch.float32, device=rotation3.device)
    m[:3, :3] = rotation3
    m[:3, 3] = _f32(position, rotation3.device)
    return m


@dataclass
class ViewConstants:
    """The per-frame matrix bundle (cf. `view_constants.rs:6-23`).
    `*_prev` are last frame's; `sample_offset_pixels` is the TAA jitter."""

    view_to_clip: torch.Tensor
    clip_to_view: torch.Tensor
    world_to_view: torch.Tensor
    view_to_world: torch.Tensor
    view_to_clip_prev: torch.Tensor
    world_to_view_prev: torch.Tensor
    view_to_world_prev: torch.Tensor
    sample_offset_pixels: torch.Tensor  # (2,) in [-0.5, 0.5)
    eye_position: torch.Tensor          # (3,)

    @property
    def world_to_clip(self):
        return self.view_to_clip @ self.world_to_view

    @property
    def world_to_clip_prev(self):
        return self.view_to_clip_prev @ self.world_to_view_prev

    @property
    def device(self):
        return self.view_to_clip.device

    def to(self, device):
        return ViewConstants(**{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)})


def make_view_constants(position, forward, fov_y_deg: float = 52.0,
                        width: int = 1920, height: int = 1080,
                        near: float = 0.01, up=(0.0, 1.0, 0.0),
                        jitter=(0.0, 0.0), prev: ViewConstants | None = None,
                        device=None) -> ViewConstants:
    """Build the view bundle on `device` (default CUDA; raises without it)."""
    dev = resolve_device(device)
    fov = _f32(fov_y_deg, dev) * (math.pi / 180.0)
    aspect = width / height
    rot = look_rotation(forward, up, dev)
    v2c = perspective_reversed_infinite_z(fov, aspect, near, dev)
    c2v = inverse_perspective_reversed_infinite_z(fov, aspect, near, dev)
    w2v = world_to_view_from(position, rot)
    v2w = view_to_world_from(position, rot)
    if prev is None:
        v2c_prev, w2v_prev, v2w_prev = v2c, w2v, v2w
    else:
        v2c_prev = prev.view_to_clip.to(dev)
        w2v_prev = prev.world_to_view.to(dev)
        v2w_prev = prev.view_to_world.to(dev)
    return ViewConstants(
        view_to_clip=v2c, clip_to_view=c2v, world_to_view=w2v,
        view_to_world=v2w, view_to_clip_prev=v2c_prev,
        world_to_view_prev=w2v_prev, view_to_world_prev=v2w_prev,
        sample_offset_pixels=_f32(jitter, dev),
        eye_position=_f32(position, dev))


def pixel_centers_uv(width: int, height: int, jitter, device, band=None):
    """(H, W, 2) uv in [0,1): pixel centers plus sub-pixel jitter; with
    `band` (parallel/comm.py), its rows only."""
    y0, n = (0, height) if band is None else (band.y0, band.n)
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(y0, y0 + n, dtype=torch.float32, device=device) + 0.5
    u = (xs[None, :] + jitter[0]) / width
    v = (ys[:, None] + jitter[1]) / height
    return torch.stack([u.expand(n, width), v.expand(n, width)], dim=-1)


def uv_to_clip(uv):
    return torch.stack([uv[..., 0] * 2.0 - 1.0, 1.0 - uv[..., 1] * 2.0],
                       dim=-1)


def camera_rays(view: ViewConstants, width: int, height: int,
                jitter_px=None, band=None):
    """Primary ray origins/directions for every pixel: (org, dir), each
    (H, W, 3). `jitter_px` ((H, W, 2), pixels) adds per-pixel sub-pixel
    offsets on top of the TAA jitter (the path tracer's pixel filter).
    With `band`, the rays of its rows."""
    uv = pixel_centers_uv(width, height, view.sample_offset_pixels,
                          view.device, band)
    if jitter_px is not None:
        uv = uv + jitter_px / const_tensor((float(width), float(height)),
                                           uv.device)
    cs = uv_to_clip(uv)
    ones = torch.ones_like(cs[..., :1])
    clip = torch.cat([cs, ones, ones], dim=-1)
    vpos = transform_h(view.clip_to_view, clip)
    vpos = vpos[..., :3] / vpos[..., 3:4]
    wdir = transform_dirs(view.view_to_world, vpos)
    wdir = wdir / torch.linalg.norm(wdir, dim=-1, keepdim=True)
    org = view.eye_position.expand(wdir.shape)
    return org, wdir


def depth_to_view_z(depth, near: float = 0.01):
    """Reversed-infinite-Z depth -> positive view-space distance along -Z."""
    return near / torch.clamp(depth, min=1e-12)
