"""Carry state across from the JAX package: numpy dicts -> the port's types.

The JAX side's arrays are handed over as numpy (`np.asarray` of each field),
so this module needs neither JAX nor the JAX package. Field names are the
JAX dataclasses' own:

- `trace_scene_from_numpy`: the fields of a JAX `TraceScene` (`gpu` as a dict
  of `GpuScene` fields, `woop` as its dict, `bvh` as a dict of `Bvh` fields);
  on the Woop route the port carries no BVH (it reads none), so `bvh` is
  kept only where `woop` is None, the BVH route, with the walk kernel's
  tables packed from it;
- `bvh_from_numpy`: the fields of a JAX `Bvh`;
- `levels_from_numpy`: the `levels` of a JAX `build_trace_scene`, the refit
  schedule as index tensors on the device;
- `frame_state_from_numpy`: an `init_frame_state`-shaped dict;
- `view_from_numpy`: the fields of a JAX `ViewConstants`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.camera import ViewConstants
from .device import resolve_device
from .rt.bvh import Bvh, pack_walk_tables, refit_schedule
from .scene.scene import GpuScene
from .world import TraceScene

_INT_GPU_FIELDS = {"tri_idx", "tri_mat", "tri_inst", "light_tri", "num_lights"}
# the texture tables (None on an untextured scene): uint8 atlas, int32 slots
_TEXTURE_FIELDS = {"tex_pages": torch.uint8, "mat_tex": torch.int32,
                   "page_sub": torch.int32}


def _t(x, dev, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = {np.dtype(np.bool_): torch.bool,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64}.get(a.dtype, torch.float32)
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def to_numpy_dict(obj):
    """A dataclass or dict of array-likes (e.g. a JAX TraceScene, GpuScene,
    ViewConstants or frame state) -> nested dict of numpy arrays."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_numpy_dict(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy_dict(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def gpu_scene_from_numpy(d: dict, device=None) -> GpuScene:
    dev = resolve_device(device)
    kw = {}
    for name in GpuScene.__dataclass_fields__:
        if name in _TEXTURE_FIELDS:
            x = d.get(name)
            kw[name] = None if x is None else _t(x, dev,
                                                 _TEXTURE_FIELDS[name])
            continue
        dtype = torch.int32 if name in _INT_GPU_FIELDS else torch.float32
        kw[name] = _t(d[name], dev, dtype)
    return GpuScene(**kw)


def bvh_from_numpy(d: dict, device=None) -> Bvh:
    return Bvh(**{name: d[name] for name in Bvh.__dataclass_fields__}).to(
        resolve_device(device))


def levels_from_numpy(d: dict, device=None) -> dict:
    dev = resolve_device(device)
    out = {"use_brute": bool(d["use_brute"])}
    if not out["use_brute"]:
        out["levels"] = refit_schedule(d["levels"], dev)
    return out


def trace_scene_from_numpy(d: dict, device=None) -> TraceScene:
    dev = resolve_device(device)
    woop = bvh = tables = None
    kw = {name: _t(d[name], dev) for name in TraceScene.__dataclass_fields__
          if name not in ("gpu", "woop", "bvh", "walk_tables")}
    if d.get("woop") is not None:
        woop = {k: _t(v, dev) for k, v in d["woop"].items() if v is not None}
    else:
        bvh = bvh_from_numpy(d["bvh"], dev)
        tables = pack_walk_tables(bvh, (kw["v0"], kw["e1"], kw["e2"]))
    return TraceScene(gpu=gpu_scene_from_numpy(d["gpu"], dev), woop=woop,
                      bvh=bvh, walk_tables=tables, **kw)


def frame_state_from_numpy(d: dict, device=None) -> dict:
    dev = resolve_device(device)
    return {k: _t(v, dev) for k, v in d.items()}


def view_from_numpy(d: dict, device=None) -> ViewConstants:
    dev = resolve_device(device)
    return ViewConstants(**{name: _t(d[name], dev, torch.float32)
                            for name in ViewConstants.__dataclass_fields__})
