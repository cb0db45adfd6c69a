"""Irradiance cache: a temporally recurrent volumetric radiance cache (port
of `kajiya_tpu/renderers/ircache.py`).

An eye-centred clipmap of `cascades` x grid_res^3 cells indexes sparse
probe entries that carry WORLD positions and L1 spherical-harmonics
irradiance. Every frame:
  * `build_grid` scatters the live entries into their cells (so the clipmap
    scrolls for free: entries that leave their cascade are no longer
    scattered and expire);
  * `allocate` touches the entries that quarter-res surface points query,
    allocates entries for queried cells that lack one (scatter-max winner
    per cell, cumsum ranks matched against the free slots) and nudges
    entries toward the winning query point of their cell;
  * `trace_update` traces `rays_per_entry` uniform-sphere rays for up to
    `active_budget` entries (round-robin), every `validate_period` frames
    along the previous trace's stored directions, and blends the SH
    estimate with hysteresis; the hit lighting's ambient term reads the
    cache itself, which makes the bounces infinite;
  * `build_value_grid` bakes each cell's entry payload into a 13-wide row
    so that a lookup is one row fetch.

With a row `band` (parallel/), the pool stays replicated, the same on
every rank: the frame gathers the query points (`allocate` then runs on the
whole frame's queries everywhere), each rank traces and shades a contiguous
slice of the entry wavefront, and the slices' radiance is all-gathered
before the SH projection and the write-back, which every rank runs alike.
A ray's trace and shading read only that ray and the replicated tables, so
a slice gives the bits the whole wavefront gives.

The JAX module's masked scatters write a neutral value into index 0
(`.at[where(m, idx, 0)].max(where(m, val, -1))`); here they are
`scatter_reduce(..., "amax")` over the same operands (ops/scan.py), which is
deterministic and gives the same integers. Its drop-mode scatter of the
traced subset writes dead lanes into a dump row past the end
(`_write_rows`): the live rows hold distinct entry ids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..brdf.sampling import uniform_sphere
from ..core import rng as rng_mod
from ..core.color import luminance
from ..ops.scan import inclusive_scan, scatter_max
from ..parallel.comm import even_slices
from ..sky.env import sample_env

# SH basis constants
_Y00 = 0.28209479
_Y1 = 0.48860251
_UNSEEN = -(10 ** 6)


@dataclass(frozen=True)
class IrcacheConfig:
    """Static configuration (the JAX one's fields and defaults): 64Ki
    entries, 12 cascades x 32^3 cells, 4 rays per entry per frame for at
    most 16Ki entries a frame."""
    cascades: int = 12
    grid_res: int = 32
    max_entries: int = 65536
    rays_per_entry: int = 4
    base_cell_size: float = 0.25
    expire_frames: int = 60
    hysteresis_frames: float = 32.0
    active_budget: int = 16384
    validate_period: int = 3
    validate_rel: float = 0.5
    reposition_rate: float = 0.25


def init_state(cfg: IrcacheConfig, device=None):
    e, s = cfg.max_entries, cfg.rays_per_entry

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "ircache_pos": z(e, 3),
        "ircache_sh": z(e, 3, 4),          # RGB x (Y00, Y1-1, Y10, Y11)
        "ircache_life": z(e),              # frames of history
        "ircache_seen": torch.full((e,), _UNSEEN, dtype=torch.int32,
                                   device=device),
        "ircache_valid": z(e, dtype=torch.bool),
        # the last trace's rays, for the every-Nth-frame validation re-trace
        "ircache_ray_dir": z(e, s, 3),
        "ircache_ray_rad": z(e, s, 3),
    }


# ----------------------------------------------------------------------------
# Cell math
# ----------------------------------------------------------------------------

def _cascade_of(pos, eye, cfg):
    """Finest cascade whose clipmap (centred at eye) contains pos. Returns
    (cascade (...,) int32, in_range (...,) bool)."""
    half_extent0 = cfg.base_cell_size * cfg.grid_res * 0.5
    d = torch.amax(torch.abs(pos - eye), dim=-1)
    # cascade c covers |d| < half_extent0 * 2^c
    c = torch.ceil(torch.log2(torch.clamp(d / half_extent0, min=1e-6)))
    c = torch.clamp(c, 0, cfg.cascades - 1).to(torch.int32)
    in_range = d < half_extent0 * (2.0 ** (cfg.cascades - 1))
    return c, in_range


def _cell_of(pos, eye, cascade, cfg):
    """Integer cell coordinates within the cascade grid + flat grid index."""
    cell_size = cfg.base_cell_size * torch.pow(2.0, cascade.to(torch.float32))
    origin_cell = torch.floor(eye / cell_size[..., None]).to(torch.int32)
    cell = torch.floor(pos / cell_size[..., None]).to(torch.int32)
    rel = cell - origin_cell + cfg.grid_res // 2
    ok = torch.all((rel >= 0) & (rel < cfg.grid_res), dim=-1)
    rel = torch.clamp(rel, 0, cfg.grid_res - 1)
    g = cfg.grid_res
    flat = (cascade * (g * g * g) + rel[..., 0] * (g * g) + rel[..., 1] * g
            + rel[..., 2])
    return flat, ok, cell_size


def _entry_cells(state, eye, cfg):
    cas, in_range = _cascade_of(state["ircache_pos"], eye, cfg)
    flat, ok, _ = _cell_of(state["ircache_pos"], eye, cas, cfg)
    live = state["ircache_valid"] & in_range & ok
    return flat, live


def build_grid(state, eye, cfg: IrcacheConfig):
    """(C*G^3,) int32 entry index per cell, -1 = empty: one scatter."""
    flat, live = _entry_cells(state, eye, cfg)
    dev = flat.device
    n_cells = cfg.cascades * cfg.grid_res ** 3
    grid = torch.full((n_cells,), -1, dtype=torch.int32, device=dev)
    ids = torch.arange(cfg.max_entries, dtype=torch.int32, device=dev)
    return scatter_max(grid, torch.where(live, flat, 0),
                       torch.where(live, ids, -1))


# ----------------------------------------------------------------------------
# Allocation
# ----------------------------------------------------------------------------

def build_value_grid(state, grid, cfg: IrcacheConfig):
    """(C, 13) f32 per-cell payload [SH(12), life] of the cell's entry; zero
    rows = empty cell (confidence 0 -> sky fallback in the lookup)."""
    e = cfg.max_entries
    rows = torch.cat([state["ircache_sh"].reshape(e, 12),
                      state["ircache_life"][:, None]], dim=-1)
    has = grid >= 0
    vg = rows[torch.where(has, grid, 0).long()]
    return torch.where(has[:, None], vg, 0.0)


def allocate(state, grid, query_pos, query_mask, eye, frame_idx,
             cfg: IrcacheConfig):
    """Allocate entries for queried cells that lack one and touch existing
    ones. query_pos: (Q, 3) surface points wanting GI. Returns new state."""
    dev = query_pos.device
    cas, in_range = _cascade_of(query_pos, eye, cfg)
    flat, ok, _ = _cell_of(query_pos, eye, cas, cfg)
    valid_q = query_mask & in_range & ok
    n_cells = cfg.cascades * cfg.grid_res ** 3
    flat_l = flat.long()

    fi = torch.as_tensor(frame_idx, device=dev).to(torch.int32)
    existing = grid[flat_l]                          # (Q,) entry id or -1
    # --- touch: update last-seen for queried entries (masked scatter-max)
    touch = valid_q & (existing >= 0)
    seen = scatter_max(state["ircache_seen"], torch.where(touch, existing, 0),
                       torch.where(touch, fi, _UNSEEN))

    # --- requests: one winner query per empty cell (scatter-max dedup)
    wants = valid_q & (existing < 0)
    qid = torch.arange(query_pos.shape[0], dtype=torch.int32, device=dev)
    req_grid = torch.full((n_cells,), -1, dtype=torch.int32, device=dev)
    req_grid = scatter_max(req_grid, torch.where(wants, flat, 0),
                           torch.where(wants, qid, -1))
    is_winner = wants & (req_grid[flat_l] == qid)

    # --- free slots: invalid or expired entries
    expired = (fi - seen) > cfg.expire_frames
    free = (~state["ircache_valid"]) | expired
    # prefix-scan compaction ranks
    free_rank = inclusive_scan(free.to(torch.int32)) - 1       # (E,)
    win_rank = inclusive_scan(is_winner.to(torch.int32)) - 1   # (Q,)

    # match winner k with the k-th free slot via an inverse map:
    # rank -> winning query id (unique indices)
    rank_to_q = torch.full((cfg.max_entries,), -1, dtype=torch.int32,
                           device=dev)
    w_ok = is_winner & (win_rank < cfg.max_entries)
    rank_to_q = scatter_max(rank_to_q, torch.where(w_ok, win_rank, 0),
                            torch.where(w_ok, qid, -1))

    # per-slot source query: the slot is free AND its free-rank has a winner
    src_q = torch.where(
        free, rank_to_q[torch.clamp(free_rank, 0, cfg.max_entries - 1).long()],
        -1)                                                     # (E,)
    writes = src_q >= 0
    sq = torch.clamp(src_q, min=0).long()

    # seed the probe AT the query point (new entries start on-surface)
    pos = torch.where(writes[:, None], query_pos[sq], state["ircache_pos"])
    sh = torch.where(writes[:, None, None], 0.0, state["ircache_sh"])
    life = torch.where(writes, 0.0, state["ircache_life"])
    seen = torch.where(writes, fi, seen)
    valid = torch.where(writes, True, state["ircache_valid"] & ~expired)
    # a recycled slot must not validate against its previous occupant's rays
    ray_dir = torch.where(writes[:, None, None], 0.0, state["ircache_ray_dir"])
    ray_rad = torch.where(writes[:, None, None], 0.0, state["ircache_ray_rad"])

    # --- reposition voting: existing entries drift toward the cell's winning
    # query point (one scatter-max elects the vote, a rate-limited nudge
    # applies it)
    vote_grid = torch.full((n_cells,), -1, dtype=torch.int32, device=dev)
    vote_grid = scatter_max(vote_grid, torch.where(touch, flat, 0),
                            torch.where(touch, qid, -1))
    ecas, e_in = _cascade_of(pos, eye, cfg)
    eflat, e_ok, _ = _cell_of(pos, eye, ecas, cfg)
    vq = torch.where(valid & e_in & e_ok, vote_grid[eflat.long()], -1)
    has_vote = (vq >= 0) & ~writes
    target = query_pos[torch.clamp(vq, min=0).long()]
    r = cfg.reposition_rate
    pos = torch.where(has_vote[:, None], pos * (1.0 - r) + target * r, pos)

    return {
        "ircache_pos": pos, "ircache_sh": sh, "ircache_life": life,
        "ircache_seen": seen, "ircache_valid": valid,
        "ircache_ray_dir": ray_dir, "ircache_ray_rad": ray_rad,
    }


# ----------------------------------------------------------------------------
# Trace + SH update
# ----------------------------------------------------------------------------

def active_entries(valid, frame_idx, budget: int):
    """The frame's round-robin active subset: (B,) int32 entry ids, -1 for
    empty rows. With more than `budget` live entries every entry is still
    refreshed within ceil(live / budget) frames."""
    e = valid.shape[0]
    dev = valid.device
    fi = torch.as_tensor(frame_idx, device=dev).to(torch.int32)
    rank = inclusive_scan(valid.to(torch.int32)) - 1          # (E,)
    n_live = torch.clamp(rank[-1] + 1, min=1)
    offset = (fi * budget) % n_live                          # round-robin
    slot = torch.where(valid, (rank - offset) % n_live, budget)
    sel = valid & (slot < budget)
    ids = torch.arange(e, dtype=torch.int32, device=dev)
    lst = torch.full((budget,), -1, dtype=torch.int32, device=dev)
    return scatter_max(lst, torch.where(sel, slot, 0),
                       torch.where(sel, ids, -1))


def entry_rays(state, frame_idx, cfg: IrcacheConfig):
    """The frame's entry wavefront: rays_per_entry rays for each entry of
    the round-robin active set, uniform over the sphere from a per-(entry,
    frame, ray) hash, or every `validate_period` frames along the previous
    trace's stored directions where one exists. Returns a dict: `lst` (B,)
    entry ids (-1 = empty row), `org`, `dir` (B*S, 3), `rng` (B*S,) seeds
    advanced past the two direction draws, `use_stored` (B*S,) bool. The
    frame index stays on the device: nothing here waits for the card."""
    e, s = cfg.max_entries, cfg.rays_per_entry
    b = min(cfg.active_budget, e)
    live = state["ircache_valid"]
    dev = live.device
    fi = torch.as_tensor(frame_idx, device=dev).to(torch.int32)

    lst = active_entries(live, fi, b)
    eidx = torch.clamp(lst, min=0).long()                     # (B,)
    pos_b = state["ircache_pos"][eidx]                        # (B, 3)

    # one flat wavefront of B*S rays (fixed shape; dead lanes masked)
    eid_r = eidx[:, None].expand(b, s).reshape(-1)
    sid_r = torch.arange(s, dtype=torch.int64, device=dev)[None, :].expand(
        b, s).reshape(-1)
    rngs = rng_mod.hash3(eid_r, fi, sid_r)
    u1, rngs = rng_mod.rand_u01(rngs)
    u2, rngs = rng_mod.rand_u01(rngs)
    d_fresh = uniform_sphere(u1, u2)                          # (B*S, 3)

    # validation frames re-trace the stored directions (where one exists)
    d_stored = state["ircache_ray_dir"][eidx].reshape(-1, 3)  # (B*S, 3)
    validate = (fi % cfg.validate_period) == 0
    use_stored = (torch.sum(d_stored * d_stored, dim=-1) > 0.25) & validate
    d = torch.where(use_stored[:, None], d_stored, d_fresh)
    o = pos_b[:, None, :].expand(b, s, 3).reshape(-1, 3) + d * 1e-3
    return {"lst": lst, "org": o, "dir": d, "rng": rngs,
            "use_stored": use_stored}


def _write_rows(buf, widx, rows):
    """`buf[widx] = rows` with the rows at index len(buf) dropped, as JAX's
    `.at[widx].set(rows, mode="drop")`: the write goes into a copy with one
    dump row appended, which is cut off again. The other indices are
    distinct, and no mask is read on the host."""
    ext = torch.cat([buf, buf[:1]])
    ext.index_copy_(0, widx, rows)
    return ext[:-1]


def trace_update(state, ts, sky_env, diffuse_env, eye, frame_idx,
                 cfg: IrcacheConfig, max_trace_steps=None,
                 secondary_full_shading: bool = False, band=None):
    """Trace the entry wavefront (`entry_rays`) and blend the SH estimates
    of the traced entries. On validation frames a large per-ray relative
    luminance change against the stored radiance on at least half the
    checked rays cuts the entry's history. `band`: this rank traces its
    slice of the wavefront and gathers the others' radiance."""
    from ..rt.trace import scene_trace_closest
    from .hit_lighting import hit_radiance

    s = cfg.rays_per_entry
    b = min(cfg.active_budget, cfg.max_entries)
    live = state["ircache_valid"]
    rays = entry_rays(state, frame_idx, cfg)
    lst, d, use_stored = rays["lst"], rays["dir"], rays["use_stored"]
    alive_b = lst >= 0
    eidx = torch.clamp(lst, min=0).long()
    live_r = alive_b[:, None].expand(b, s).reshape(-1)

    org, d_t, rng = rays["org"], d, rays["rng"]
    if band is not None:
        slices = even_slices(b * s, band.comm.size)
        lo, hi = slices[band.comm.index]
        org, d_t, rng = org[lo:hi], d_t[lo:hi], rng[lo:hi]
    hit = scene_trace_closest(ts, org, d_t, t_min=1e-4,
                              max_steps=max_trace_steps)

    # ambient at the hit comes from the cache itself (previous frame's SH)
    grid = build_grid(state, eye, cfg)

    def cache_lookup(p, n):
        return lookup_irradiance(state, grid, p, n, eye, diffuse_env, cfg)

    rad = hit_radiance(ts, hit, d_t, sky_env, diffuse_env,
                       ircache_lookup=cache_lookup,
                       max_trace_steps=max_trace_steps, rng=rng,
                       full_shading=secondary_full_shading)
    if band is not None:
        rad = band.comm.all_gather(rad, slices, label="ircache radiance",
                                   ircache=True)
    rad = torch.where(live_r[:, None], rad, 0.0)

    # --- validation verdict: per-ray relative luminance mismatch
    old_rad = state["ircache_ray_rad"][eidx].reshape(-1, 3)   # (B*S, 3)
    l_new = luminance(rad)
    l_old = luminance(old_rad)
    rel = torch.abs(l_new - l_old) / torch.clamp(
        torch.maximum(l_new, l_old), min=1e-3)
    mism = (use_stored & (rel > cfg.validate_rel)).reshape(b, s)
    checked = use_stored.reshape(b, s)
    # cut history when >= half the checked rays disagree
    n_checked = checked.sum(dim=1, dtype=torch.int32)
    cut = alive_b & (n_checked > 0) & (
        mism.sum(dim=1, dtype=torch.int32) * 2
        >= torch.clamp(n_checked, min=1))

    # project onto SH: L_lm = (4pi / S) * sum radiance * Y_lm(d)
    y = torch.stack([torch.full_like(d[:, 0], _Y00),
                     _Y1 * d[:, 1], _Y1 * d[:, 2], _Y1 * d[:, 0]], dim=-1)
    contrib = rad[:, :, None] * y[:, None, :]                 # (B*S, 3, 4)
    sh_new = contrib.reshape(b, s, 3, 4).sum(dim=1) * (4.0 * math.pi / s)

    life_b = state["ircache_life"][eidx]                      # (B,)
    life_b = torch.where(cut, torch.clamp(life_b, max=2.0), life_b)
    life_b = torch.clamp(life_b + 1.0, max=cfg.hysteresis_frames)
    alpha = (1.0 / torch.clamp(life_b, min=1.0))[:, None, None]
    sh_b = state["ircache_sh"][eidx] * (1 - alpha) + sh_new * alpha

    # --- write the traced subset back (dump row E for dead lanes)
    widx = torch.where(alive_b, eidx, cfg.max_entries)
    sh = _write_rows(state["ircache_sh"], widx, sh_b)
    life = _write_rows(state["ircache_life"], widx, life_b)
    sh = torch.where(live[:, None, None], sh, 0.0)
    life = torch.where(live, life, 0.0)
    ray_dir = _write_rows(state["ircache_ray_dir"], widx, d.reshape(b, s, 3))
    ray_rad = _write_rows(state["ircache_ray_rad"], widx,
                          rad.reshape(b, s, 3))

    out = dict(state)
    out["ircache_sh"] = sh
    out["ircache_life"] = life
    out["ircache_ray_dir"] = ray_dir
    out["ircache_ray_rad"] = ray_rad
    return out


# ----------------------------------------------------------------------------
# Lookup
# ----------------------------------------------------------------------------

def lookup_irradiance(state, grid, pos, normal, eye, diffuse_env,
                      cfg: IrcacheConfig):
    """E(n)/pi at world positions. Falls back to the convolved sky where no
    entry exists (young entries are blended in by history length). `grid` is
    the index grid of `build_grid` or the value grid of `build_value_grid`
    (None builds the index grid)."""
    if grid is None:
        grid = build_grid(state, eye, cfg)
    cas, in_range = _cascade_of(pos, eye, cfg)
    flat, ok, _ = _cell_of(pos, eye, cas, cfg)
    found = in_range & ok
    if grid.ndim == 2:
        # value grid: ONE 13-wide row fetch per query
        row = grid[torch.where(found, flat, 0).long()]
        row = torch.where(found[..., None], row, 0.0)
    else:
        entry = torch.where(found, grid[flat.long()], -1)
        e_total = state["ircache_sh"].shape[0]
        lut = torch.cat([state["ircache_sh"].reshape(e_total, 12),
                         state["ircache_life"][:, None]], dim=-1)
        row = lut[torch.clamp(entry, min=0).long()]          # (..., 13)
        row = torch.where((entry >= 0)[..., None], row, 0.0)
    sh = row[..., :12].reshape(row.shape[:-1] + (3, 4))
    n = normal
    # E(n)/pi = L00 Y00 + (2/3) sum L1m Y1m(n)
    b0 = _Y00
    b1 = (2.0 / 3.0) * _Y1 * n[..., 1]
    b2 = (2.0 / 3.0) * _Y1 * n[..., 2]
    b3 = (2.0 / 3.0) * _Y1 * n[..., 0]
    e_over_pi = torch.clamp(
        sh[..., 0] * b0 + sh[..., 1] * b1[..., None]
        + sh[..., 2] * b2[..., None] + sh[..., 3] * b3[..., None], min=0.0)

    # young entries blend toward the sky fallback by confidence; missing
    # entries carry a zero row (confidence 0)
    conf = torch.clamp(row[..., 12] / 4.0, 0.0, 1.0)[..., None]
    fallback = sample_env(diffuse_env, n)
    return e_over_pi * conf + fallback * (1 - conf)
