"""The collectives of the multi-device layer, over a `torch.distributed`
process group, and the log that counts them.

A frame's planes are held as row bands, one per rank (`Band`). A pass
computes only its own band, and every read outside it goes through one of
four collectives of `Comm`:

  * `halo`: the rows of the neighbouring bands that a bounded stencil reads
    (point-to-point sends between the ranks that hold them: the port's
    collective-permute). At the frame's top and bottom edges nothing is
    fetched, so a stencil run on the returned window clamps there exactly as
    it clamps on the whole frame;
  * `all_gather`: a whole plane from its uneven bands (for fetches at
    arbitrary uv);
  * `all_reduce`: a sum over the ranks (the exposure histogram);
  * `broadcast`: a tensor from one rank to all (scene distribution).

Under gloo, CUDA tensors are staged through pinned host buffers (gloo moves
host memory), and the staged bytes are counted. Every collective appends one
`Collective` per element it materializes on this rank to the log while one
is recording: its kind, bytes, whether it serves the irradiance cache, and
the bytes that crossed a host seam (ranks grouped into hosts by the mesh).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

KINDS = ("halo", "all_gather", "all_reduce", "broadcast")


@dataclass(frozen=True)
class Collective:
    """One collective element as this rank saw it."""

    kind: str                 # one of KINDS
    nbytes: int               # bytes of the element materialized here
    rank: int                 # the rank that logged it
    peer: int | None = None   # the sending rank of a halo message
    ircache: bool = False     # serves the irradiance cache
    inter_host_bytes: int = 0  # of nbytes, those that crossed a host seam
    staged_bytes: int = 0     # bytes copied through host memory (gloo)
    label: str = ""
    # host wall time of the call on this rank (a halo exchange's is split
    # over its messages); a staged copy first waits for the card's queue
    seconds: float = 0.0


class CollectiveLog(list):
    """The collectives of a run, in the order they were issued: the port's
    stand-in for the optimized HLO that the JAX package reads."""


def _as_bytes(t):
    """A contiguous uint8 view of t (any dtype, bool included), so that
    every backend moves it bit for bit."""
    t = t.contiguous()
    if t.dtype == torch.uint8:
        return t
    if t.ndim == 0:
        t = t.reshape(1)
    return t.view(torch.uint8)


def _from_bytes(b, like_dtype, shape):
    if like_dtype == torch.uint8:
        return b.reshape(shape)
    return b.view(like_dtype).reshape(shape)


@dataclass
class Comm:
    """Collectives among `ranks` (global ranks in band order) over `group`
    (None: the default group). `hosts[i]` is the host of member i."""

    ranks: tuple
    index: int                # this process's position in `ranks`
    backend: str
    device: torch.device
    group: object = None
    hosts: tuple = ()
    log: CollectiveLog | None = field(default=None)

    @property
    def size(self):
        return len(self.ranks)

    @contextlib.contextmanager
    def recording(self):
        """Log every collective issued inside the block; yields the log."""
        prev, self.log = self.log, CollectiveLog()
        try:
            yield self.log
        finally:
            self.log = prev

    def _record(self, kind, nbytes, peer=None, inter_host_bytes=0,
                staged_bytes=0, label="", ircache=False, seconds=0.0):
        if self.log is not None:
            self.log.append(Collective(
                kind=kind, nbytes=int(nbytes), rank=self.ranks[self.index],
                peer=peer, ircache=ircache,
                inter_host_bytes=int(inter_host_bytes),
                staged_bytes=int(staged_bytes), label=label,
                seconds=seconds))

    def _host(self, i):
        return self.hosts[i] if self.hosts else 0

    # -- staging ---------------------------------------------------------
    def _staged(self, t):
        return self.backend == "gloo" and t.is_cuda

    def _wire(self, t):
        """t as the backend moves it: a pinned host copy under gloo."""
        if not self._staged(t):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _empty_wire(self, shape, dtype):
        if self.backend == "gloo":
            pin = self.device.type == "cuda"
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        return torch.empty(shape, dtype=dtype, device=self.device)

    # -- the collectives -------------------------------------------------
    def halo(self, x, rows, height, top: int, bottom: int, label=""):
        """Rows [max(0, a - top), min(height, b + bottom)) of the plane whose
        band [a, b) = rows[index] this rank holds as `x`; member j holds
        rows[j]. Returns (window, rows of the window above the band). Every
        member calls it with the same top / bottom."""
        if self.size == 1 or (top == 0 and bottom == 0):
            return x, 0
        t0 = time.perf_counter()
        a, b = rows[self.index]
        lo, hi = max(0, a - top), min(height, b + bottom)
        payload = _as_bytes(x)
        row_shape = tuple(payload.shape[1:])

        def wanted(i):
            """Member i's halo intervals: (above, below)."""
            ai, bi = rows[i]
            return ((max(0, ai - top), ai), (bi, min(height, bi + bottom)))

        def overlap(iv, j):
            aj, bj = rows[j]
            return max(iv[0], aj), min(iv[1], bj)

        sends, recvs = [], []
        wire = None
        for i in range(self.size):
            if i == self.index:
                continue
            for tag, iv in enumerate(wanted(i)):
                s, e = overlap(iv, self.index)
                if s < e:
                    if wire is None:
                        wire = self._wire(payload)
                    sends.append((i, tag, wire[s - a:e - a].contiguous()))
        pieces = {0: [], 1: []}
        for tag, iv in enumerate(wanted(self.index)):
            for j in range(self.size):
                if j == self.index:
                    continue
                s, e = overlap(iv, j)
                if s < e:
                    buf = self._empty_wire((e - s,) + row_shape, torch.uint8)
                    recvs.append((j, tag, buf))
                    pieces[tag].append(buf)
        if self.backend == "nccl":
            ops = [dist.P2POp(dist.isend, t, self.ranks[i], self.group, tag)
                   for i, tag, t in sends]
            ops += [dist.P2POp(dist.irecv, t, self.ranks[j], self.group, tag)
                    for j, tag, t in recvs]
            reqs = dist.batch_isend_irecv(ops) if ops else []
        else:
            reqs = [dist.isend(t, self.ranks[i], group=self.group, tag=tag)
                    for i, tag, t in sends]
            reqs += [dist.irecv(t, self.ranks[j], group=self.group, tag=tag)
                     for j, tag, t in recvs]
        for r in reqs:
            r.wait()
        staging = self.backend == "gloo" and self.device.type == "cuda"
        # members are in row order, so the pieces are too
        window = torch.cat([buf.to(self.device) for buf in pieces[0]]
                           + [payload]
                           + [buf.to(self.device) for buf in pieces[1]])
        seconds = (time.perf_counter() - t0) / max(1, len(recvs))
        for j, _tag, buf in recvs:
            # staged: the sender's copy to the host and this rank's back
            nb = buf.numel()
            self._record("halo", nb, peer=self.ranks[j],
                         inter_host_bytes=nb if self._host(j) != self._host(
                             self.index) else 0,
                         staged_bytes=2 * nb if staging else 0, label=label,
                         seconds=seconds)
        return (_from_bytes(window, x.dtype, (hi - lo,) + tuple(x.shape[1:])),
                a - lo)

    def all_gather(self, x, rows, label="", ircache=False):
        """The whole plane from its bands: member j holds rows[j] as x."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        payload = _as_bytes(x)
        row_shape = tuple(payload.shape[1:])
        n_max = max(b - a for a, b in rows)
        n = payload.shape[0]
        wire = self._wire(payload)
        if n < n_max:
            pad = torch.zeros((n_max - n,) + row_shape, dtype=torch.uint8,
                              device=wire.device)
            wire = torch.cat([wire, pad])
        outs = [self._empty_wire((n_max,) + row_shape, torch.uint8)
                for _ in range(self.size)]
        dist.all_gather(outs, wire.contiguous(), group=self.group)
        full = torch.cat([o[:b - a] for o, (a, b) in zip(outs, rows)])
        if full.device != self.device:
            full = full.to(self.device)
        total = full.numel()
        row_b = total // max(1, full.shape[0])
        inter = sum((b - a) * row_b for j, (a, b) in enumerate(rows)
                    if self._host(j) != self._host(self.index))
        staged = (payload.numel() + total) if self._staged(x) else 0
        self._record("all_gather", total, inter_host_bytes=inter,
                     staged_bytes=staged, label=label, ircache=ircache,
                     seconds=time.perf_counter() - t0)
        height = rows[-1][1] - rows[0][0]
        return _from_bytes(full, x.dtype, (height,) + tuple(x.shape[1:]))

    def all_reduce(self, x, label="", ircache=False):
        """The elementwise sum of x over the members."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        wire = self._wire(x.contiguous()).clone()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.group)
        out = wire.to(self.device) if wire.device != self.device else wire
        nb = x.numel() * x.element_size()
        spans = len(set(self.hosts)) > 1 if self.hosts else False
        self._record("all_reduce", nb, inter_host_bytes=nb if spans else 0,
                     staged_bytes=2 * nb if self._staged(x) else 0,
                     label=label, ircache=ircache,
                     seconds=time.perf_counter() - t0)
        return out

    def broadcast(self, x, src_index: int = 0, label=""):
        """x of member `src_index` on every member; the others pass a tensor
        of the same shape and dtype to receive into."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        payload = _as_bytes(x)
        wire = (self._wire(payload) if self.index == src_index
                else self._empty_wire(payload.shape, torch.uint8))
        dist.broadcast(wire, self.ranks[src_index], group=self.group)
        out = wire.to(self.device) if wire.device != self.device else wire
        nb = payload.numel()
        self._record("broadcast", nb,
                     inter_host_bytes=nb if self._host(src_index)
                     != self._host(self.index) else 0,
                     staged_bytes=nb if self._staged(x) else 0, label=label,
                     seconds=time.perf_counter() - t0)
        return _from_bytes(out, x.dtype, tuple(x.shape))

    def broadcast_object(self, obj, src_index: int = 0):
        """A picklable object of member `src_index` on every member."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, self.ranks[src_index],
                                   group=self.group)
        return box[0]

    def gather_objects(self, obj):
        """Every member's picklable `obj`, in member order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


@dataclass(frozen=True)
class Band:
    """This rank's rows [y0, y1) of an (height, width[, C]) plane, and every
    member's, over `comm`. `scaled(k)` is the same band on a plane decimated
    k times (rows // k), as the frame's half- and quarter-res planes are."""

    comm: Comm
    rows: tuple               # every member's (a, b), in member order
    height: int
    width: int

    @property
    def y0(self):
        return self.rows[self.comm.index][0]

    @property
    def y1(self):
        return self.rows[self.comm.index][1]

    @property
    def n(self):
        return self.y1 - self.y0

    def scaled(self, k: int) -> "Band":
        return Band(self.comm, tuple((a // k, b // k) for a, b in self.rows),
                    self.height // k, self.width // k)

    def half(self) -> "Band":
        return self.scaled(2)

    def halvable(self) -> bool:
        """Whether a 2x reduce of every member's band is that member's band
        of the reduced plane (every band starts on an even row) and no half
        band is empty."""
        return all(a % 2 == 0 and b // 2 > a // 2 for a, b in self.rows)

    def rows_of(self, x):
        """x restricted to this band's rows (x a whole plane)."""
        return x[self.y0:self.y1]

    def halo(self, x, top: int, bottom: int | None = None, label="halo"):
        """(window, rows above the band): x extended by the neighbours' rows,
        clipped to the plane (a reach wider than a neighbour's band takes
        rows of the bands beyond it too)."""
        bottom = top if bottom is None else bottom
        return self.comm.halo(x, self.rows, self.height, top, bottom,
                              label=label)

    def window(self, x, needs, label="window"):
        """(window, its first row): rows [lo, hi) = needs[index] of the
        plane whose band this rank holds as x, where needs[j] are the rows
        member j reads (a resize between two resolutions, whose bands do not
        line up). One halo exchange whose reach is the widest of every
        member's; every member calls it with the same `needs`."""
        top = max(0, max(a - lo for (a, _b), (lo, _hi)
                         in zip(self.rows, needs)))
        bottom = max(0, max(hi - b for (_a, b), (_lo, hi)
                            in zip(self.rows, needs)))
        win, above = self.halo(x, top, bottom, label=label)
        start = self.y0 - above
        lo, hi = needs[self.comm.index]
        if lo < start or hi > start + win.shape[0]:
            raise ValueError(f"rows [{lo}, {hi}) lie outside the window "
                             f"[{start}, {start + win.shape[0]})")
        return win[lo - start:hi - start], lo

    def gather(self, x, label="all_gather", ircache=False):
        return self.comm.all_gather(x, self.rows, label=label,
                                    ircache=ircache)

    def all_reduce(self, x, label="all_reduce", ircache=False):
        return self.comm.all_reduce(x, label=label, ircache=ircache)


def even_slices(n: int, size: int):
    """`size` contiguous slices [a, b) that cover range(n), in member order:
    member i takes [i n / size, (i + 1) n / size) (a flat ray batch split
    over the ranks)."""
    bounds = [(i * n) // size for i in range(size + 1)]
    return tuple(zip(bounds[:-1], bounds[1:]))
