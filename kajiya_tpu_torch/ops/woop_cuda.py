"""Woop intersector kernels B (brute) and C (cluster-culled): wrappers, plain
PyTorch versions and the host-side cull. Port of
`kajiya_tpu/ops/woop_pallas.py`.

Each wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel in csrc/woop.cu or raises. The plain versions repeat the
kernels' arithmetic in the same order (no FMA contraction on either side),
so both return the same bits.

B  `intersect_brute_cuda`: every ray against the whole table (small scenes
   without cluster tables, e.g. cornell).
C  `intersect_culled_cuda`: per 512-ray chunk, a front-to-back list of
   active 128-triangle blocks from the beam/cone/reach-box cull
   (`active_blocks`) or from the rasterizer's screen-rect lists; closest hit
   stops once every ray's best t beats the next block's bound, any-hit once
   every live ray has a hit. The kernel takes those decisions per ray (a
   warp owns 32 rays and leaves a ray out of a block it cannot hit in: one
   whose bound lies above the ray's best t, or whose padded box the ray does
   not cross); `culled_plain(ray_skip=True)` is that walk in plain PyTorch,
   and returns the chunk-level walk's bits.

B's kernel rejects most pairs before the division, by tests that only drop
pairs the exact test drops too (`brute_reject_plain` is their plain model);
the plain version makes no such test and returns the same bits.

The tables the kernels read ((T, 21) rows for the plain versions and, padded
to (T, 24), for B; (T / 128, 21, 128) slabs and (T / 128, 8) padded block
boxes for C) are built once per scene refresh by `attach_coef_tables` and
travel in the `woop` dictionary.
"""
from __future__ import annotations

import numbers
from dataclasses import dataclass

import numpy as np
import torch

from ..core.profiling import pass_scope
from . import _native

INF = float(np.float32(1e30))
CULL_TB = 128            # triangles per culled block
CULL_RAY_BLOCK = 512     # rays per chunk (one block list; 16 warps of rays)
N_COEF = 21              # 12 a_o + 9 a_d coefficients per triangle
N_ROW = 24               # B's padded row: 6 float4

_BEPS = float(np.float32(1e-5))
_ONE_BEPS = float(np.float32(1.0 + 1e-5))
_RW_EPS = float(np.float32(1e-12))
_BOX_EPS = float(np.float32(1e-3))    # block box margin, of the scene size
_RAY_PAD = float(np.float32(1e-5))    # per-ray box pad, of |org|_1 + tmax
# B's limit reject: p = fl(fl(lim * (1 + 2^-20)) * |rw|), off below lim 1e-25
_REJECT_GROW = 1.0 + 2.0 ** -20
_LIM_FLOOR = float(np.float32(1e-25))


def _f32(x) -> float:
    return float(np.float32(x))


# ----------------------------------------------------------------------------
# Tables and inputs
# ----------------------------------------------------------------------------

def coef_rows(woop) -> torch.Tensor:
    """(T, 21) per-triangle coefficients [a_o u,v,w (4 each) | a_d u,v,w
    (3 each)] from build_woop's grouped (3T, 4) / (3T, 3) tables."""
    t = woop["a_d"].shape[0] // 3
    ao = woop["a_o"].reshape(3, t, 4).permute(1, 0, 2).reshape(t, 12)
    ad = woop["a_d"].reshape(3, t, 3).permute(1, 0, 2).reshape(t, 9)
    return torch.cat([ao, ad], dim=1).contiguous()


def coef_rows24(woop) -> torch.Tensor:
    """(T, 24): `coef_rows` followed by three zeros, 16-byte rows that
    kernel B reads as 6 float4."""
    c = coef_rows(woop)
    return torch.cat([c, c.new_zeros((c.shape[0], N_ROW - N_COEF))],
                     dim=1).contiguous()


def coef_blocks(woop) -> torch.Tensor:
    """(T / 128, 21, 128): one contiguous 21 x 128 slab per culled block."""
    c = coef_rows(woop)
    nt = c.shape[0] // CULL_TB
    return c.reshape(nt, CULL_TB, N_COEF).permute(0, 2, 1).contiguous()


def block_bounds(woop) -> torch.Tensor:
    """(T / 128, 8): each culled block's box [min xyz, 0 | max xyz, 0], grown
    by a thousandth of the scene's largest coordinate. The kernel's per-ray
    slab test reads it; the margin (with the per-ray pad the test adds) lies
    far above the rounding of that test and above the 1e-5 barycentric slack
    of the triangle test, so a ray that hits a triangle crosses its block's
    box."""
    cmin, cmax = woop["cmin64"], woop["cmax64"]
    big = torch.maximum(cmin.amin(dim=0).abs(), cmax.amax(dim=0).abs()).amax()
    eps = _BOX_EPS * big
    zero = cmin.new_zeros((cmin.shape[0], 1))
    return torch.cat([cmin - eps, zero, cmax + eps, zero], dim=1).contiguous()


def attach_coef_tables(woop):
    """Store the kernels' tables in the `woop` dictionary: "coef_rows",
    "coef_rows24" and, where the scene has cluster tables, "coef_blocks" and
    "block_bounds". Called where the dictionary is built, so the tables live
    exactly as long as the a_o / a_d they derive from."""
    woop["coef_rows"] = coef_rows(woop)
    woop["coef_rows24"] = coef_rows24(woop)
    if woop.get("cmin64") is not None:
        woop["coef_blocks"] = coef_blocks(woop)
        woop["block_bounds"] = block_bounds(woop)
    return woop


def stored_table(woop, key, build):
    """The table stored by `attach_coef_tables`, or a fresh one for a
    dictionary that comes straight from build_woop."""
    table = woop.get(key)
    return build(woop) if table is None else table


def ray_tmax(org, t_max) -> torch.Tensor:
    """(R,) float32 tmax from None (no limit), a number or per-ray values.
    A number is filled on the device: a copy from the host would make the
    host wait for the card."""
    r = org.shape[0]
    if t_max is None or isinstance(t_max, numbers.Real):
        return torch.full((r,), INF if t_max is None else float(t_max),
                          dtype=torch.float32, device=org.device)
    return torch.as_tensor(t_max, dtype=torch.float32,
                           device=org.device).expand(r).contiguous()


def _woop_math(c, o, d):
    """Per-triangle Woop terms; c[k] broadcast against o[..., j], d[..., j].
    Returns (t, u, v, rw_ok) in the kernel's evaluation order."""
    def aff(k):
        return ((c[k] * o[0] + c[k + 1] * o[1]) + c[k + 2] * o[2]) + c[k + 3]

    def lin(k):
        return (c[k] * d[0] + c[k + 1] * d[1]) + c[k + 2] * d[2]

    qu, qv, qw = aff(0), aff(4), aff(8)
    ru, rv, rw = lin(12), lin(15), lin(18)
    rw_ok = torch.abs(rw) >= _RW_EPS
    rw_safe = torch.where(rw_ok, rw, _RW_EPS)
    t = (-qw) / rw_safe
    u = qu + t * ru
    v = qv + t * rv
    return t, u, v, rw_ok


def _select_first_min(t, u, v, ok):
    """Closest candidate along the last axis, lowest index on ties.
    Returns (bt, idx, bu, bv); bt = INF where nothing qualifies."""
    t_m = torch.where(ok, t, INF)
    bt = t_m.amin(dim=-1, keepdim=True)
    lanes = torch.arange(t.shape[-1], device=t.device)
    idx = torch.where(t_m <= bt, lanes, t.shape[-1]).amin(dim=-1, keepdim=True)
    safe = idx.clamp(max=t.shape[-1] - 1)
    return (bt[..., 0], idx[..., 0], u.gather(-1, safe)[..., 0],
            v.gather(-1, safe)[..., 0])


# ----------------------------------------------------------------------------
# Kernel B: brute force over the whole table
# ----------------------------------------------------------------------------

def brute_plain(coef, org, d, tmax, t_min):
    """Plain version of kernel B: closest hit (also the any-hit answer: only
    the tri >= 0 mask is the any-hit contract)."""
    r, n_tris = org.shape[0], coef.shape[0]
    t_min = _f32(t_min)
    t_out = torch.full((r,), INF, dtype=torch.float32, device=org.device)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=org.device)
    u_out = torch.zeros((r,), dtype=torch.float32, device=org.device)
    v_out = torch.zeros((r,), dtype=torch.float32, device=org.device)
    c = coef.T                                          # (21, T)
    step = max(1, (1 << 22) // max(n_tris, 1))
    for s in range(0, r, step):
        e = min(r, s + step)
        o = [org[s:e, j:j + 1] for j in range(3)]
        dd = [d[s:e, j:j + 1] for j in range(3)]
        tm = tmax[s:e, None]
        t, u, v, rw_ok = _woop_math(c, o, dd)
        ok = (rw_ok & (u >= -_BEPS) & (v >= -_BEPS) & ((u + v) <= _ONE_BEPS)
              & (t > t_min) & (t < INF) & (t < tm))
        bt, idx, bu, bv = _select_first_min(t, u, v, ok)
        hit = bt < INF
        t_out[s:e] = bt
        tri_out[s:e] = torch.where(hit, idx, -1).to(torch.int32)
        u_out[s:e] = torch.where(hit, bu, 0.0)
        v_out[s:e] = torch.where(hit, bv, 0.0)
    return t_out, tri_out, u_out, v_out


def brute_reject_plain(coef, org, d, lim):
    """Plain model of kernel B's rejects before the division: (R, T) bool,
    True where the kernel drops ray r x triangle k without the exact test,
    for rays whose limit is lim = min(t_best, tmax) (R,). A pair is kept
    only if |rw| >= 1e-12, t = -qw / rw can be positive (qw and rw nonzero
    and of opposite signs) and |qw| < fl(fl(lim (1 + 2^-20)) |rw|) (no limit
    below lim 1e-25). The exact test drops every pair this drops, for any
    t_min >= 0 (the proof is in csrc/woop.cu); lim = 0 drops every pair, as
    the kernel's slots without a ray."""
    c = coef[:, :N_COEF].T                              # (21, T)
    o = [org[:, j:j + 1] for j in range(3)]
    dd = [d[:, j:j + 1] for j in range(3)]
    qw = ((c[8] * o[0] + c[9] * o[1]) + c[10] * o[2]) + c[11]
    rw = (c[18] * dd[0] + c[19] * dd[1]) + c[20] * dd[2]
    lim = lim.to(torch.float32)
    limg = torch.where(lim >= _LIM_FLOOR, lim * _REJECT_GROW,
                       torch.full_like(lim, float("inf")))
    limg = torch.where(lim == 0.0, 0.0, limg)[:, None]
    y = torch.where(torch.signbit(rw), -qw, qw)         # qw * sign(rw)
    keep = (rw.abs() >= _RW_EPS) & (y < 0.0) & (-y < limg * rw.abs())
    return ~keep


def check_t_min(t_min):
    """Kernel B's rejects rest on t_min >= 0 (every caller passes 1e-4)."""
    if not _f32(t_min) >= 0.0:
        raise ValueError(f"kernel B needs t_min >= 0, got {t_min}")


def brute_launch(rows, org, d, tmax, t_min, any_hit, counts=None):
    """Launch kernel B on CUDA tensors; `rows` is the (T, 24) table.
    `counts`, a zeroed int64 CUDA tensor of 3 elements, makes this a
    checking launch: the kernel adds the ray x row pairs its live rays
    visited, those its rejects kept, and those whose exact test a warp
    executed (a warp runs it for all its lanes when one needs it)."""
    check_t_min(t_min)
    _native.check_cuda(rows, org, d, tmax)
    r, n_tris = org.shape[0], rows.shape[0]
    _check(org, (r, 3))
    _check(d, (r, 3))
    _check(tmax, (r,))
    _check(rows, (n_tris, N_ROW))
    if counts is not None:
        _native.check_cuda(counts)
        _check(counts, (3,), torch.int64)
    outs = _empty_hits(r, org.device)
    if r == 0:
        return outs
    lib = _native.library()
    status = lib.kt_woop_brute(
        org.data_ptr(), d.data_ptr(), tmax.data_ptr(), rows.data_ptr(), r,
        n_tris, _f32(t_min), int(any_hit), *(x.data_ptr() for x in outs),
        None if counts is None else counts.data_ptr(),
        _native.stream_ptr(org))
    _native.check_status("woop_brute", status)
    _native.launches["woop_brute"] += 1
    return outs


def intersect_brute_cuda(woop, org, d, t_min=1e-4, t_max=None,
                         any_hit: bool = False):
    """Kernel B wrapper (port of `intersect_brute_pallas`): (t, tri, u, v),
    tri int32 with -1 on a miss."""
    tmax = ray_tmax(org, t_max)
    org, d = org.contiguous(), d.contiguous()
    if org.device.type == "cpu":
        return brute_plain(stored_table(woop, "coef_rows", coef_rows), org, d,
                           tmax, t_min)
    return brute_launch(stored_table(woop, "coef_rows24", coef_rows24), org,
                        d, tmax, t_min, any_hit)


# ----------------------------------------------------------------------------
# Kernel C: cluster-culled streaming intersector
# ----------------------------------------------------------------------------

def _chunk_beams(org, d, tmax, nrb, rb):
    """Per-chunk bounding beam: origin sphere + direction cone, the
    `coherent` flag, and the live-masked origin/direction AABBs."""
    o = org.reshape(nrb, rb, 3)
    dd = d.reshape(nrb, rb, 3)
    live = tmax.reshape(nrb, rb) > 0.0
    any_live = live.any(dim=1)
    oc = o.mean(dim=1)
    ro = torch.sqrt(torch.clamp(((o - oc[:, None]) ** 2).sum(-1),
                                min=0.0)).amax(dim=1)
    lf = live[..., None].to(dd.dtype)
    axis = (dd * lf).sum(dim=1) / lf.sum(dim=1)
    axis = torch.where(any_live[:, None], axis, 0.0)
    alen = torch.sqrt((axis * axis).sum(-1, keepdim=True))
    axis = axis / torch.clamp(alen, min=1e-8)
    mincos = torch.where(live, (dd * axis[:, None]).sum(-1), 1.0).amin(dim=1)
    coherent = (mincos >= 0.05) & (alen[:, 0] >= 1e-6) & any_live
    cosh = torch.clamp(mincos, 0.05, 1.0)
    tmax_c = tmax.reshape(nrb, rb).amax(dim=1)
    big = float(np.float32(3e38))
    lv = live[..., None]
    omin = torch.where(lv, o, big).amin(dim=1)
    omax = torch.where(lv, o, -big).amax(dim=1)
    dmin = torch.where(lv, dd, 1.0).amin(dim=1)
    dmax = torch.where(lv, dd, -1.0).amax(dim=1)
    return oc, ro, axis, cosh, tmax_c, coherent, (omin, omax, dmin, dmax)


def active_blocks(woop, org, d, tmax, nrb, rb):
    """(blist, bdist, count) per chunk from a conservative beam-vs-cluster
    test at CULL_TB granularity; divergent chunks skip the cone test."""
    cmin, cmax = woop["cmin64"], woop["cmax64"]
    c = (cmin + cmax) * 0.5
    rbnd = torch.sqrt(torch.clamp(((cmax - cmin) * 0.5) ** 2, min=0.0).sum(-1))
    rbnd = torch.where(torch.isfinite(rbnd), rbnd, -1.0)
    (oc, ro, axis, cosh, tmax_c, coherent,
     (omin, omax, dmin, dmax)) = _chunk_beams(org, d, tmax, nrb, rb)
    v = c[None, :, :] - oc[:, None, :]
    proj = (v * axis[:, None, :]).sum(-1)
    d2 = (v * v).sum(-1)
    dperp = torch.sqrt(torch.clamp(d2 - proj * proj, min=0.0))
    dist = torch.sqrt(d2)
    rr = ro[:, None] + rbnd[None, :]
    tanh_ = torch.sqrt(torch.clamp(1.0 - cosh * cosh, min=0.0)) / cosh
    cone_hit = ((proj >= -rr) & (proj - rr <= tmax_c[:, None])
                & (dperp <= torch.clamp(proj, min=0.0) * tanh_[:, None]
                   + rr / cosh[:, None]))
    sphere_hit = dist - rr <= tmax_c[:, None]
    reach_min = omin + tmax_c[:, None] * torch.clamp(dmin, max=0.0)
    reach_max = omax + tmax_c[:, None] * torch.clamp(dmax, min=0.0)
    box_hit = ((cmax[None] >= reach_min[:, None, :])
               & (cmin[None] <= reach_max[:, None, :])).all(dim=-1)
    hit = ((rbnd[None, :] >= 0.0) & box_hit
           & torch.where(coherent[:, None], cone_hit, sphere_hit))
    dlb = torch.clamp(dist - rr, min=0.0)
    return sort_blocks_by_distance(hit, dlb)


def sort_blocks_by_distance(hit, dlb):
    """(hit (n, C) bool, dlb (n, C)) -> (blist int32, dist, count int32):
    active blocks first, front-to-back by their t lower bound."""
    dkey = torch.where(hit, dlb, INF)
    dist_sorted, blist = torch.sort(dkey, dim=1, stable=True)
    count = hit.sum(dim=1).to(torch.int32)
    return blist.to(torch.int32), dist_sorted, count


@dataclass
class CulledBatch:
    """Kernel C's inputs: rays padded to whole chunks, the per-chunk block
    lists and the blocked coefficient table."""
    org: torch.Tensor       # (nrb * rb, 3)
    d: torch.Tensor         # (nrb * rb, 3)
    tmax: torch.Tensor      # (nrb * rb,) scene-AABB clamped; 0 = dead lane
    blist: torch.Tensor     # (nrb, nt) int32
    bdist: torch.Tensor     # (nrb, nt) float32
    count: torch.Tensor     # (nrb,) int32
    coef: torch.Tensor      # (nt, 21, 128)
    bounds: torch.Tensor    # (nt, 8) padded block boxes
    rb: int
    n_rays: int             # unpadded ray count

    @property
    def n_chunks(self):
        return self.count.shape[0]


def prepare_culled(woop, org, d, t_max=None, block_lists=None, rb=None):
    """Host-side half of the culled tracer: the scene-AABB tmax clamp, ray
    padding and (unless the caller gives `block_lists`) the beam cull."""
    if org.device.type != "cpu":
        _native.check_cuda(org, d)
    rtot = org.shape[0]
    t_max = ray_tmax(org, t_max)
    # nothing exists beyond the scene AABB: each ray's tmax ends at its box
    # exit (rays missing the box die), which arms the early stop for sky rays
    smin = woop["cmin64"].amin(dim=0)
    smax = woop["cmax64"].amax(dim=0)
    deps = _RW_EPS
    dinv = 1.0 / torch.where(torch.abs(d) < deps,
                             torch.where(d < 0, -deps, deps), d)
    ta = (smin[None] - org) * dinv
    tb = (smax[None] - org) * dinv
    tfar = torch.maximum(ta, tb).amin(dim=-1)
    tnear = torch.clamp(torch.minimum(ta, tb).amax(dim=-1), min=0.0)
    t_max = torch.where(tfar >= tnear,
                        torch.minimum(t_max, tfar * 1.001 + 1e-3), 0.0)
    rb = CULL_RAY_BLOCK if rb is None else rb
    if rb % 32 or not 32 <= rb <= 1024:
        raise ValueError(f"ray chunk {rb} must be a multiple of 32 in "
                         "[32, 1024] (a warp of the kernel owns 32 rays)")
    rpad = (-rtot) % rb
    if rpad:
        org = torch.cat([org, org.new_zeros((rpad, 3))])
        d = torch.cat([d, d.new_ones((rpad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros((rpad,))])
    nrb = org.shape[0] // rb
    if block_lists is None:
        blist, bdist, count = active_blocks(woop, org, d, t_max, nrb, rb)
    else:
        blist, bdist, count = block_lists
        if blist.shape[0] != nrb or count.shape[0] != nrb:
            raise ValueError(f"block lists for {blist.shape[0]} chunks, "
                             f"rays make {nrb}")
    return CulledBatch(org=org.contiguous(), d=d.contiguous(),
                       tmax=t_max.contiguous(),
                       blist=blist.to(torch.int32).contiguous(),
                       bdist=bdist.to(torch.float32).contiguous(),
                       count=count.to(torch.int32).contiguous(),
                       coef=stored_table(woop, "coef_blocks", coef_blocks),
                       bounds=stored_table(woop, "block_bounds", block_bounds),
                       rb=rb, n_rays=rtot)


def culled_plain(b: CulledBatch, t_min, any_hit: bool, early_stop: bool,
                 chunks_per_step: int = 64, visits=None, ray_visits=None,
                 ray_skip: bool = False):
    """Plain version of kernel C over every chunk: the chunk-level block
    walk, early stop and any-hit exit, with the chunks of one step processed
    side by side. Returns padded (t, tri, u, v) of shape (n_chunks * rb,).
    If `visits` is a list, each step's per-chunk count of visited blocks is
    appended to it (the work the bound counts). If `ray_visits` is a list,
    each step's per-chunk count of ray x block pairs that the kernel's
    per-ray walk tests is appended to it. `ray_skip` takes the kernel's
    per-ray decisions as well: a ray is left out of a block whose bound lies
    above its min(t_best, tmax) (closest hit, early stop), whose padded box
    it does not cross within (t_min, that limit) (early stop) or once it has
    a hit (any-hit), and dead rays (tmax <= t_min) are never tested. Bounds
    and boxes are conservative, so the results are the same bits either way
    (any-hit: the same occlusion mask)."""
    dev = b.org.device
    t_min = _f32(t_min)
    chunks = torch.arange(b.n_chunks, device=dev)
    rb, nblk = b.rb, b.coef.shape[0]
    org = b.org.reshape(-1, rb, 3)
    dirs = b.d.reshape(-1, rb, 3)
    tmax = b.tmax.reshape(-1, rb)
    outs = []
    for s in range(0, chunks.shape[0], chunks_per_step):
        g = chunks[s:s + chunks_per_step]
        n = g.shape[0]
        o = [org[g, :, j:j + 1] for j in range(3)]        # (n, rb, 1)
        dd = [dirs[g, :, j:j + 1] for j in range(3)]
        tm = tmax[g]
        cnt = b.count[g]
        per_ray = ray_skip or ray_visits is not None
        if per_ray and early_stop:
            inv = [_slab_inv(x[..., 0]) for x in dd]
            pad = _RAY_PAD * (((o[0].abs() + o[1].abs()) + o[2].abs())[..., 0]
                              + tm)
        tb = torch.full((n, rb), INF, dtype=torch.float32, device=dev)
        tri = torch.full((n, rb), -1, dtype=torch.int32, device=dev)
        ub = torch.zeros((n, rb), dtype=torch.float32, device=dev)
        vb = torch.zeros((n, rb), dtype=torch.float32, device=dev)
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        walked = torch.zeros((n,), dtype=torch.int64, device=dev)
        ray_walked = torch.zeros((n,), dtype=torch.int64, device=dev)
        for k in range(int(cnt.max()) if n else 0):
            go = alive & (k < cnt)
            if any_hit:
                go &= ((tri < 0) & (tm > t_min)).any(dim=1)
            elif early_stop:
                worst = torch.minimum(tb, tm).amax(dim=1)
                go &= b.bdist[g, k] <= worst
            alive = go
            if not bool(go.any()):
                break
            walked += go
            blk = b.blist[g, k].to(torch.int64).clamp(0, nblk - 1)
            need = go[:, None]
            if per_ray:
                # the rays a per-ray walk still tests against this block
                need = (tm > t_min) & need
                limit = torch.minimum(tb, tm)
                if any_hit:
                    need &= tri < 0
                elif early_stop:
                    need &= b.bdist[g, k][:, None] <= limit
                if early_stop:
                    need &= _crosses_box(b.bounds[blk],
                                         [x[..., 0] for x in o], inv, pad,
                                         t_min, limit)
                ray_walked += need.sum(dim=1)
            c = b.coef[blk]                                # (n, 21, 128)
            cb = [c[:, r, None, :] for r in range(N_COEF)]  # (n, 1, 128)
            t, u, v, rw_ok = _woop_math(cb, o, dd)
            ok = (rw_ok & (u >= -_BEPS) & (v >= -_BEPS)
                  & ((u + v) <= _ONE_BEPS) & (t > t_min)
                  & (t < tb[..., None]) & (t < tm[..., None])
                  & (need if ray_skip else go[:, None])[..., None])
            bt, idx, bu, bv = _select_first_min(t, u, v, ok)
            closer = bt < tb
            tb = torch.where(closer, bt, tb)
            tri = torch.where(closer, (blk[:, None] * CULL_TB + idx)
                              .to(torch.int32), tri)
            ub = torch.where(closer, bu, ub)
            vb = torch.where(closer, bv, vb)
        outs.append((tb, tri, ub, vb))
        if visits is not None:
            visits.append(walked)
        if ray_visits is not None:
            ray_visits.append(ray_walked)
    return tuple(torch.cat([x[i].reshape(-1) for x in outs])
                 if outs else torch.empty(0, device=dev) for i in range(4))


def _slab_inv(d):
    """The reciprocal the kernel's slab test multiplies by."""
    tiny = torch.where(d < 0, -_RW_EPS, _RW_EPS)
    return 1.0 / torch.where(d.abs() < _RW_EPS, tiny, d)


def _crosses_box(box, o, inv, pad, t_min, limit):
    """The kernel's per-ray slab test in its order of operations: box (n, 8)
    per chunk, o / inv lists of (n, rb), pad and limit (n, rb). True where
    the ray crosses the padded box within (t_min, limit)."""
    t_in = t_out = None
    for j in range(3):
        a = ((box[:, j, None] - pad) - o[j]) * inv[j]
        c = ((box[:, 4 + j, None] + pad) - o[j]) * inv[j]
        near, far = torch.minimum(a, c), torch.maximum(a, c)
        t_in = near if t_in is None else torch.maximum(t_in, near)
        t_out = far if t_out is None else torch.minimum(t_out, far)
    return ~((t_in > t_out) | (t_out < t_min) | (t_in > limit))


def culled_launch(b: CulledBatch, t_min, any_hit: bool, early_stop: bool,
                  tested=None):
    """Launch kernel C on a prepared batch; returns padded (t, tri, u, v).
    `tested`, a zeroed int64 CUDA tensor of one element, makes this a
    checking launch: the kernel adds the ray x block pairs it tested."""
    _native.check_cuda(b.org, b.d, b.tmax, b.blist, b.bdist, b.count, b.coef,
                       b.bounds)
    r, nrb = b.org.shape[0], b.n_chunks
    nt = b.blist.shape[1]
    _check(b.org, (r, 3))
    _check(b.d, (r, 3))
    _check(b.tmax, (r,))
    _check(b.blist, (nrb, nt), torch.int32)
    _check(b.bdist, (nrb, nt))
    _check(b.count, (nrb,), torch.int32)
    _check(b.coef, (b.coef.shape[0], N_COEF, CULL_TB))
    _check(b.bounds, (b.coef.shape[0], 8))
    if r != nrb * b.rb or b.rb % 32:
        raise ValueError("rays are not padded to whole chunks of a multiple "
                         "of 32 rays")
    if tested is not None:
        _native.check_cuda(tested)
        _check(tested, (1,), torch.int64)
    outs = _empty_hits(r, b.org.device)
    if nrb == 0:
        return outs
    lib = _native.library()
    status = lib.kt_woop_culled(
        b.org.data_ptr(), b.d.data_ptr(), b.tmax.data_ptr(),
        b.blist.data_ptr(), b.bdist.data_ptr(), b.count.data_ptr(), nrb,
        b.rb, nt, b.coef.data_ptr(), b.bounds.data_ptr(), _f32(t_min),
        int(any_hit), int(early_stop), *(x.data_ptr() for x in outs),
        None if tested is None else tested.data_ptr(),
        _native.stream_ptr(b.org))
    _native.check_status("woop_culled", status)
    _native.launches["woop_culled"] += 1
    return outs


def intersect_culled_cuda(woop, org, d, t_min=1e-4, t_max=None,
                          any_hit: bool = False, block_lists=None,
                          early_stop: bool = True, rb: int | None = None):
    """Kernel C wrapper (port of `intersect_culled_pallas`): (t, tri, u, v)
    for the unpadded rays. `block_lists` (blist, bdist, count) replaces the
    beam cull (the rasterizer's exact screen-rect lists)."""
    with pass_scope("cull"):
        b = prepare_culled(woop, org, d, t_max=t_max,
                           block_lists=block_lists, rb=rb)
    return tuple(x[:b.n_rays] for x in run_culled(b, t_min, any_hit,
                                                  early_stop))


def run_culled(b: CulledBatch, t_min, any_hit: bool, early_stop: bool = True):
    """Kernel C on a prepared batch: the plain version for CPU tensors, the
    kernel for CUDA tensors. Returns padded (t, tri, u, v)."""
    if b.org.device.type == "cpu":
        return culled_plain(b, t_min, any_hit, early_stop)
    return culled_launch(b, t_min, any_hit, early_stop)


def intersect_scene(woop, org, d, t_min=1e-4, t_max=None,
                    any_hit: bool = False, rb=None):
    """Scene-level entry: the culled kernel where the scene has cluster
    tables, the brute kernel otherwise."""
    if woop.get("cmin") is not None:
        return intersect_culled_cuda(woop, org, d, t_min=t_min, t_max=t_max,
                                     any_hit=any_hit, rb=rb)
    return intersect_brute_cuda(woop, org, d, t_min=t_min, t_max=t_max,
                                any_hit=any_hit)


# ----------------------------------------------------------------------------

def _check(t, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise ValueError(f"expected contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _empty_hits(r, device):
    return (torch.empty((r,), dtype=torch.float32, device=device),
            torch.empty((r,), dtype=torch.int32, device=device),
            torch.empty((r,), dtype=torch.float32, device=device),
            torch.empty((r,), dtype=torch.float32, device=device))
