"""Multi-device rendering over `torch.distributed` (port of
`kajiya_tpu/parallel/mesh.py`).

Parallel axes, as in the JAX module:

  * ``tile``: every (H, W, ...) frame plane is held as row bands, one per
    rank; the scene, its trace tables and the view are replicated. Each pass
    computes only its own band (`render_frame(..., band=)`), and every read
    outside it is an explicit collective of `comm.Comm`: halo rows for
    bounded stencils, an all-gather of the source for fetches at arbitrary
    uv (the temporal warps, the screen-space radiance reuse), an all-reduce
    for the exposure histogram. Band edges fall on multiples of 16 full-res
    rows (`band_rows`), so that every half- and quarter-res plane, every
    (8, 128) ReSTIR tile, every 16-row motion-blur tile and every 8-row
    irradiance-cache query splits on the same rows. The irradiance cache's
    pool (the `ircache_*` tables) is replicated: every rank gathers the
    frame's query points, traces its slice of the entry wavefront and
    gathers the others' radiance, so every rank writes the same pool.
  * ``spp`` (`shard_rays_pt`): the reference path tracer's flat ray batch is
    split into contiguous slices, traced independently and all-gathered.
  * multi-host: a ("host", "tile") grid whose ranks are ordered host-major,
    so that a halo crosses a host seam only between the last band of one
    host and the first of the next; the log counts those bytes apart.

The banded frame runs every `RenderConfig`: the default frame (the
irradiance cache, SSAO, ReSTIR GI, RTR with mesh-light specular, TAA,
motion blur), the traced g-buffer, the world radiance cache (its atlas
split over its probes: each rank traces its probes and all-gathers the
atlas), depth of field (halo rows) and temporal super-resolution, whose
output-size planes are banded on the output frame's own bands
(`FrameBands`). An IBL sky raises NotImplementedError, as JAX's sharded
entry points take no env map (`frame.check_supported(..., sharded=True)`).
Every output and state plane equals the single-device frame's bit for bit.

The JAX module jits the frame with GSPMD shardings and reads the collectives
XLA inserted from the optimized HLO. The port runs eagerly, so
`compile_frame_sharded` runs one frame while the communicator records and
returns that log, and `collective_summary` / `check_sharding_quality` read
the log with the JAX thresholds (docs/port_eager.md).

The backend is chosen when the process group starts (`init_distributed`):
NCCL when every rank has a card of its own, gloo otherwise (ranks on the
CPU, or several ranks sharing one card, which NCCL refuses). A failed NCCL
set-up raises; nothing gives way to gloo.
"""
from __future__ import annotations

import dataclasses
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..renderers.taa import KEYS as TAA_KEYS
from .comm import Band, CollectiveLog, Comm, even_slices

BAND_UNIT = 16      # band edges are multiples of this many full-res rows


@dataclass
class Mesh:
    """The ranks of a frame, in band order, with each rank's device, the
    communicator over their process group and the axis names / sizes."""

    comm: Comm
    axis_names: tuple
    shape: dict
    devices: tuple
    host_groups: tuple = ()

    @property
    def ranks(self):
        return self.comm.ranks

    @property
    def size(self):
        return self.comm.size

    @property
    def index(self):
        return self.comm.index

    @property
    def backend(self):
        return self.comm.backend

    @property
    def device(self):
        return self.comm.device

    def band(self, height: int, width: int) -> Band:
        """This rank's band of an (height, width) frame."""
        return Band(self.comm, band_rows(height, self.size), height, width)


def band_rows(height: int, n: int):
    """The rows [a, b) of each of n bands: band i starts at i * height / n
    rounded to the nearest multiple of BAND_UNIT, and the last band takes the
    remainder (1080 over 4: 272, 272, 272, 264 rows; 72 over 4: 16, 16, 16,
    24)."""
    if n > height // BAND_UNIT:
        raise ValueError(f"{n} ranks need at least {n} units of {BAND_UNIT} "
                         f"rows; a {height}-row frame has "
                         f"{height // BAND_UNIT}")
    starts = [((2 * i * height + BAND_UNIT * n) // (2 * BAND_UNIT * n))
              * BAND_UNIT for i in range(n)]
    return tuple(zip(starts, starts[1:] + [height]))


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, init_method=None):
    """Join the process group (once per process, before any mesh is built;
    mirrors `jax.distributed.initialize`). `coordinator_address` is
    "host:port" for a tcp:// rendezvous; `init_method` (e.g. file://...)
    replaces it. The backend is NCCL when this host has a card for every
    process, gloo otherwise, unless `backend` names one. A no-op for one
    process. Returns the backend, or None."""
    if num_processes is None or num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= num_processes else "gloo")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("init_distributed needs a coordinator address "
                             "or an init_method")
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return backend


def _rank_device(backend, device):
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError("NCCL moves CUDA tensors; the mesh's device "
                             f"cannot be {device}")
        return torch.device("cuda", dist.get_rank()
                            % torch.cuda.device_count())
    return resolve_device(device)


def _build_mesh(order, hosts, axis_names, shape, device, host_groups=()):
    if not dist.is_initialized():
        dev = resolve_device(device)
        comm = Comm(ranks=(0,), index=0, backend="none", device=dev,
                    hosts=(0,))
        return Mesh(comm, axis_names, shape, (dev,))
    backend = dist.get_backend()
    dev = _rank_device(backend, device)
    comm = Comm(ranks=tuple(order), index=order.index(dist.get_rank()),
                backend=backend, device=dev, hosts=tuple(hosts))
    devices = tuple(torch.device(d) for d in comm.gather_objects(str(dev)))
    if backend == "nccl" and len(set(devices)) != len(devices):
        raise ValueError("NCCL needs a card for every rank; ranks share "
                         f"{devices}")
    return Mesh(comm, axis_names, shape, devices, tuple(host_groups))


def make_mesh(n_devices: int | None = None, axis: str = "tile",
              device=None) -> Mesh:
    """A one-axis mesh over every rank of the process group, in rank order
    (one rank, this process, when no group was started). `device` is the
    rank's device (default CUDA; under NCCL the rank's own card)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans the whole process group ({world} "
                         f"ranks), not {n}")
    return _build_mesh(list(range(world)), [0] * world, (axis,), {axis: n},
                       device)


def make_multihost_mesh(shape: tuple | None = None,
                        axes: tuple = ("host", "tile"), device=None) -> Mesh:
    """(n_hosts, ranks_per_host) mesh ordered host-major. By default the
    hosts are the distinct host names of the ranks; `shape` groups ranks
    r // per_host into emulated hosts (as the tests emulate hosts on one
    machine). The ranks of each host form a subgroup (`host_groups`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        names = ([socket.gethostname()] if world == 1 else
                 _world_objects(socket.gethostname()))
        uniq = list(dict.fromkeys(names))
        host_of = [uniq.index(nm) for nm in names]
        counts = {h: host_of.count(h) for h in range(len(uniq))}
        if len(set(counts.values())) != 1:
            raise ValueError(f"hosts hold unequal rank counts {counts}")
        shape = (len(uniq), world // len(uniq))
    else:
        host_of = [r // shape[1] for r in range(world)]
    n_hosts, per_host = shape
    if n_hosts * per_host != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    order = sorted(range(world), key=lambda r: (host_of[r], r))
    groups = []
    if dist.is_initialized():
        for h in range(n_hosts):
            groups.append(dist.new_group([r for r in order
                                          if host_of[r] == h]))
    return _build_mesh(order, [host_of[r] for r in order], tuple(axes),
                       {axes[0]: n_hosts, axes[1]: per_host}, device, groups)


def _world_objects(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ----------------------------------------------------------------------------
# The sharding plan and the banded state
# ----------------------------------------------------------------------------

def _spec(shape, n: int, axis):
    """JAX's `_spec_for` rule on a shape: row-shard (H, W, ...) planes whose
    H divides by the mesh size and whose W is at least 8; replicate the
    rest. `axis` is the axis name, or the tuple of names of a 2-D mesh."""
    if (len(shape) >= 2 and shape[0] % n == 0 and shape[0] >= n
            and shape[1] >= 8):
        return (axis,) + (None,) * (len(shape) - 1)
    return ()


# the planes held at the output size (TAA's state and its results): under
# temporal super-resolution they are banded on the output frame's bands
OUTPUT_KEYS = TAA_KEYS + ("taa", "final")


@dataclass(frozen=True)
class FrameBands:
    """This rank's bands of a sharded frame's planes: `render` (the render
    resolution's; its decimations by `scaled`), `output` (the output
    frame's, under temporal super-resolution not the render band scaled)
    and `probes` (the world radiance cache's probe axis, or None)."""

    render: Band
    output: Band
    probes: Band | None = None

    def layout(self, key, shape):
        """(band, whole) for a plane of this frame: the band it is held in,
        and whether `shape` is the whole plane (else the band's rows); None
        for a tensor that is not a frame plane. A plane is looked for among
        the bands of its width, those of its key's resolution first (the
        output planes are at the render size when TAA is off)."""
        if len(shape) < 2:
            return None
        render = (self.render, self.render.scaled(2), self.render.scaled(4))
        if key == "wrc_atlas":
            cands = (self.probes,) if self.probes is not None else ()
        elif key in OUTPUT_KEYS:
            cands = (self.output,) + render
        else:
            cands = render + (self.output,)
        for b in cands:
            if shape[1] == b.width and shape[0] in (b.height, b.n):
                return b, shape[0] == b.height
        return None


def frame_bands(mesh: Mesh, cfg) -> FrameBands:
    """The bands of `cfg`'s frame on this rank of `mesh`."""
    from ..renderers.wrc import probe_band

    return FrameBands(
        render=mesh.band(cfg.height, cfg.width),
        output=mesh.band(cfg.out_height, cfg.out_width),
        probes=probe_band(cfg.wrc, mesh.comm) if cfg.use_wrc else None)


def frame_state_sharding(state, mesh: Mesh, axis: str = "tile"):
    """The sharding plan of a whole-frame FrameState: for each key, JAX's
    PartitionSpec as a tuple, (axis, None, ...) for a row-sharded plane and
    () for a replicated one; the same answer as JAX's `frame_state_sharding`
    on the same state (the output-size TAA planes row-sharded, the world
    radiance cache's atlas sharded over its probes). Only band edges differ
    from JAX's even split (`band_rows`). `render_frame_sharded` keeps the
    sharded planes banded and the replicated ones whole."""
    name = axis if len(mesh.axis_names) == 1 else tuple(mesh.axis_names)
    return {k: _spec(tuple(v.shape), mesh.size, name)
            for k, v in state.items()}


def _plan_of(state, mesh: Mesh, bands: FrameBands):
    """{key: (band, sharded, whole)} for the frame planes of a state that
    may be whole or banded: `band` the one they are held in, `sharded`
    whether the plan shards them, `whole` whether this state holds them
    whole."""
    out = {}
    for key, v in state.items():
        lay = bands.layout(key, tuple(v.shape))
        if lay is None:
            continue
        b, whole = lay
        full = (b.height,) + tuple(v.shape[1:])
        out[key] = (b, bool(_spec(full, mesh.size, "tile")), whole)
    return out


def render_frame_sharded(ts, state, view, cfg, levels, mesh: Mesh,
                         axis: str = "tile"):
    """`render_frame` on this rank's bands (an IBL env map is refused, as
    JAX's sharded entry points take none). `state` is this rank's band of
    the state (as a sharded frame returns it) or the whole state (as
    `init_frame_state` makes it), whose sharded planes are cut to the band.
    Returns (band state, band outputs); planes the plan replicates come
    back whole, and so do the irradiance-cache tables, the same on every
    rank. Every rank of the mesh calls it with the same arguments."""
    from ..frame import check_supported, render_frame

    check_supported(cfg, sharded=True)
    bands = frame_bands(mesh, cfg)
    plan = _plan_of(state, mesh, bands)
    local = {}
    for key, v in state.items():
        b, _sharded, whole = plan.get(key, (None, False, False))
        local[key] = b.rows_of(v) if whole and mesh.size > 1 else v
    new_state, out = render_frame(ts, local, view, cfg, levels=levels,
                                  band=bands.render, out_band=bands.output)
    for key, (b, sharded, _whole) in plan.items():
        if not sharded and mesh.size > 1:
            new_state[key] = b.gather(new_state[key],
                                      label=f"replicated {key}")
    return new_state, out


def render_frame_multihost(ts, state, view, cfg, levels, mesh: Mesh,
                           axes=("host", "tile")):
    """`render_frame` over a ("host", "tile") mesh: bands over every rank,
    host-major, so halos cross a host seam only at the rows between hosts
    (logged as `inter_host_bytes`); the scene replicated on every rank."""
    if tuple(mesh.axis_names) != tuple(axes):
        raise ValueError(f"mesh axes {mesh.axis_names}, expected {axes}")
    return render_frame_sharded(ts, state, view, cfg, levels, mesh)


def gather_frame(tree, mesh: Mesh, cfg):
    """Whole planes of a sharded frame's band outputs or band state (nested
    dicts, or one tensor), on every rank, for the frame of `cfg`: each band
    plane is all-gathered on its band (the render band and its decimations,
    the output band, the atlas's probes), every other tensor is returned as
    it is. For tests and checks; the frame itself never gathers a state
    plane."""
    bands = frame_bands(mesh, cfg)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if torch.is_tensor(x) and mesh.size > 1:
            lay = bands.layout(key, tuple(x.shape))
            if lay is not None and not lay[1]:
                return lay[0].gather(x, label="gather_frame")
        return x

    return walk(tree)


# ----------------------------------------------------------------------------
# The collective accounting
# ----------------------------------------------------------------------------

def compile_frame_sharded(ts, state, view, cfg, levels, mesh: Mesh,
                          axis: str = "tile"):
    """Run one sharded frame while the communicator records, and return the
    log of every rank's collectives (a `CollectiveLog`): the port's
    counterpart of the compiled program whose HLO the JAX function returns.
    The frame's results are dropped; nothing is compiled in eager mode."""
    with mesh.comm.recording() as log:
        render_frame_sharded(ts, state, view, cfg, levels, mesh, axis)
    merged = CollectiveLog()
    for part in mesh.comm.gather_objects(list(log)):
        merged.extend(part)
    return merged


def collective_summary(log):
    """Count and payload bytes of each collective kind in a log, with the
    JAX summary's keys: count, bytes, max_bytes, and the largest element of
    the screen-space collectives (plane_max_bytes) and of the irradiance
    cache's (cache_max_bytes); plus the bytes that crossed a host seam
    (inter_host_bytes), those staged through host memory, the host
    seconds spent in the calls (summed over the ranks), and the bytes of
    each label ("labels": the pass each collective serves)."""
    out = {}
    for e in log:
        ent = out.setdefault(e.kind, {"count": 0, "bytes": 0, "max_bytes": 0,
                                      "inter_host_bytes": 0,
                                      "staged_bytes": 0, "seconds": 0.0,
                                      "labels": {}})
        ent["count"] += 1
        ent["labels"][e.label] = ent["labels"].get(e.label, 0) + e.nbytes
        ent["seconds"] += e.seconds
        ent["bytes"] += e.nbytes
        ent["max_bytes"] = max(ent["max_bytes"], e.nbytes)
        ent["inter_host_bytes"] += e.inter_host_bytes
        ent["staged_bytes"] += e.staged_bytes
        key = "cache_max_bytes" if e.ircache else "plane_max_bytes"
        ent[key] = max(ent.get(key, 0), e.nbytes)
    return out


def check_sharding_quality(log, height: int, width: int,
                           warp_planes: int = 24,
                           cache_bytes: int = 8 << 20):
    """The sharding-quality contract of the JAX module, on the port's log.
    Returns (summary, problems); no problems = the contract holds: some
    collective ran, no screen-space element moves more than `warp_planes`
    frame planes (a replicated state would), no irradiance-cache element
    more than `cache_bytes`, and no halo message a whole plane."""
    summary = collective_summary(log)
    plane = height * width * 4
    problems = []
    if not summary:
        problems.append("no collectives at all: every pass ran on the whole "
                        "frame or nothing ran sharded")
    for kind, ent in summary.items():
        if ent.get("plane_max_bytes", 0) > warp_planes * plane:
            problems.append(
                f"{kind}: screen-space collective moves "
                f"{ent['plane_max_bytes']}B > {warp_planes} planes "
                f"({warp_planes * plane}B) - a replicated state?")
        if ent.get("cache_max_bytes", 0) > cache_bytes:
            problems.append(f"{kind}: ircache collective moves "
                            f"{ent['cache_max_bytes']}B > {cache_bytes}B")
    halo = summary.get("halo")
    if halo is not None and halo["max_bytes"] >= plane:
        problems.append(f"halo: a message moves {halo['max_bytes']}B, a "
                        f"whole plane or more ({plane}B)")
    return summary, problems


# ----------------------------------------------------------------------------
# Scene distribution and the sample-sharded path tracer
# ----------------------------------------------------------------------------

def _skeleton(obj, leaves):
    """A picklable copy of obj with every tensor replaced by its slot."""
    if torch.is_tensor(obj):
        leaves.append(obj)
        return ("tensor", len(leaves) - 1, tuple(obj.shape), obj.dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("dataclass", type(obj),
                {f.name: _skeleton(getattr(obj, f.name), leaves)
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return ("dict", type(obj), {k: _skeleton(v, leaves)
                                    for k, v in obj.items()})
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return ("seq", type(obj), [_skeleton(v, leaves) for v in obj])
    return ("value", obj)


def _rebuild(sk, leaves):
    kind = sk[0]
    if kind == "tensor":
        return leaves[sk[1]]
    if kind == "dataclass":
        vals = {k: _rebuild(v, leaves) for k, v in sk[2].items()}
        init = {f.name for f in dataclasses.fields(sk[1]) if f.init}
        obj = sk[1](**{k: v for k, v in vals.items() if k in init})
        for k, v in vals.items():
            if k not in init:
                setattr(obj, k, v)
        return obj
    if kind == "dict":
        return sk[1]((k, _rebuild(v, leaves)) for k, v in sk[2].items())
    if kind == "seq":
        return sk[1](_rebuild(v, leaves) for v in sk[2])
    return sk[1]


def distribute_scene(tree, mesh: Mesh | None = None, device=None):
    """Rank 0's scene on every rank: every tensor of a `GpuScene` /
    `TraceScene` (nested dataclasses, dicts and sequences: the trace tables,
    the BVH, the texture pages) broadcast from the first rank of the mesh,
    bit for bit. The other ranks pass None (or anything: it is replaced).
    Tensors arrive on the mesh's device. One process: identity."""
    if mesh is None:
        mesh = make_mesh(device=device)
    comm = mesh.comm
    if comm.size == 1:
        return tree
    dev = torch.device(device) if device is not None else comm.device
    leaves = []
    sk = _skeleton(tree, leaves) if comm.index == 0 else None
    sk = comm.broadcast_object(sk)
    if comm.index == 0:
        for t in leaves:
            comm.broadcast(t, label="distribute_scene")
        return tree
    slots = []

    def collect(s):
        if s[0] == "tensor":
            slots.append(s)
        elif s[0] in ("dataclass", "dict"):
            for v in s[2].values():
                collect(v)
        elif s[0] == "seq":
            for v in s[2]:
                collect(v)

    collect(sk)
    slots.sort(key=lambda s: s[1])
    out = [comm.broadcast(torch.empty(shape, dtype=dtype, device=dev),
                          label="distribute_scene")
           for _kind, _i, shape, dtype in slots]
    return _rebuild(sk, out)


def shard_rays_pt(ts, org, d, seed, mesh: Mesh, axis: str = "tile",
                  **pt_kwargs):
    """Sample-parallel reference path trace: each rank traces its contiguous
    slice of the flat (R, 3) rays (every rank passes all of them) through
    `renderers.reference.path_trace`; returns the all-gathered (R, 3)
    radiance. No communication until that gather."""
    from ..renderers.reference import path_trace

    slices = even_slices(org.shape[0], mesh.size)
    a, b = slices[mesh.index]
    rad = path_trace(ts, org[a:b], d[a:b], seed[a:b], **pt_kwargs)
    return mesh.comm.all_gather(rad, slices, label="shard_rays_pt")
