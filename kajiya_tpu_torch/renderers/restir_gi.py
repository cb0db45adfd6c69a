"""ReSTIR GI: reservoir-resampled diffuse final gather at half res (port of
`kajiya_tpu/renderers/restir_gi.py`).

Candidate rays feed per-pixel reservoirs that are resampled temporally
(reprojected history) and spatially (jittered neighbour taps gated by
geometry similarity). Reservoirs are planar tensors (ops/reservoir.py). The
payload is the reconnection data (radiance + world-space hit point + hit
normal), and every reuse re-derives the direction from the receiving surface
with the solid-angle jacobian. Target function p_hat = luminance(L) *
max(n . dir, 0); cosine-sampled candidates enter with the constant RIS
weight pi * luminance(L).

The spatial taps are golden-angle spiral offsets whose rotation is constant
per (8, 128) pixel tile, so each tap fetches the whole packed reservoir plane
with one per-tile shift (kernel S, ops/tileshift_cuda.py). The tile size is
part of the algorithm: it fixes which neighbour every pixel reuses.

With a row `band` (parallel/, half-res), each spatial pass fetches the
halo rows its taps reach and runs kernel S on that window, whose first row
is brought onto the tile grid with rows no tap reads; the temporal and
occlusion fetches read gathered sources.
"""
from __future__ import annotations

import math

import torch

from ..core import img as im
from ..core import rng as rng_mod
from ..core.color import luminance
from ..core.profiling import pass_scope
from ..device import const_tensor
from ..ops import reservoir as rsv
from ..ops import tileshift_cuda as tsc
from ..ops.smallvec import dot3, pow8

M_CLAMP_TEMPORAL = 20.0
M_CLAMP_SPATIAL = 4.0
JACOBIAN_CLAMP = 8.0        # firefly guard on the reconnection jacobian
GOLDEN_ANGLE = 2.39996323
# (radius in half-res pixels, taps) of the two spatial passes
SPATIAL_PASSES = ((12.0, 7), (6.0, 4))


def init_state(h: int, w: int, device=None):
    hh, hw = h // 2, w // 2

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "gi_res_payload_radiance": z(hh, hw, 3),
        "gi_res_payload_hit": z(hh, hw, 3),      # world hit point
        "gi_res_payload_hitn": z(hh, hw, 3),     # hit-surface normal
        "gi_res_w_sum": z(hh, hw),
        "gi_res_M": z(hh, hw),
        "gi_res_W": z(hh, hw),
        "gi_res_p_hat": z(hh, hw),
    }


def _pack(state):
    return {
        "payload": {
            "radiance": state["gi_res_payload_radiance"],
            "hit": state["gi_res_payload_hit"],
            "hitn": state["gi_res_payload_hitn"],
        },
        "w_sum": state["gi_res_w_sum"],
        "M": state["gi_res_M"],
        "W": state["gi_res_W"],
        "p_hat": state["gi_res_p_hat"],
    }


def _unpack(r):
    return {
        "gi_res_payload_radiance": r["payload"]["radiance"],
        "gi_res_payload_hit": r["payload"]["hit"],
        "gi_res_payload_hitn": r["payload"]["hitn"],
        "gi_res_w_sum": r["w_sum"],
        "gi_res_M": r["M"],
        "gi_res_W": r["W"],
        "gi_res_p_hat": r["p_hat"],
    }


def _res13(res):
    """Reservoir dict -> one (..., 13) plane."""
    return torch.cat([
        res["payload"]["radiance"], res["payload"]["hit"],
        res["payload"]["hitn"], res["w_sum"][..., None],
        res["M"][..., None], res["W"][..., None],
        res["p_hat"][..., None]], dim=-1)


def _unres13(p):
    return {"payload": {"radiance": p[..., 0:3], "hit": p[..., 3:6],
                        "hitn": p[..., 6:9]},
            "w_sum": p[..., 9], "M": p[..., 10], "W": p[..., 11],
            "p_hat": p[..., 12]}


def _reconnect(hit, pos):
    """Direction + distance from a surface point to a stored hit point."""
    d = hit - pos
    dist = torch.sqrt(torch.clamp(dot3(d, d), min=1e-12))
    return d / dist[..., None], dist


def _jacobian(hit, hitn, pos_owner, pos_receiver):
    """Solid-angle density ratio for reusing the owner's hit sample from the
    receiver's surface point: the cosine at the hit surface changes and so
    does the squared distance. Clamped to kill fireflies from grazing
    reconnections."""
    dir_a, da = _reconnect(hit, pos_owner)
    dir_b, db = _reconnect(hit, pos_receiver)
    ca = torch.clamp(dot3(hitn, -dir_a), min=1e-4)
    cb = torch.clamp(dot3(hitn, -dir_b), min=0.0)
    j = (cb / ca) * (da * da) / torch.clamp(db * db, min=1e-8)
    return torch.clamp(j, 0.0, JACOBIAN_CLAMP)


def _p_hat_at(payload, pos, normal):
    """Target function at a receiving surface: re-derived direction."""
    direction, _ = _reconnect(payload["hit"], pos)
    return luminance(payload["radiance"]) * torch.clamp(
        dot3(direction, normal), min=0.0)


def _occluded(pos, hit, vz_h, view, near, samples, max_px: float = 8.0,
              band=None, vz_whole=None):
    """Screen-space occlusion raymarch along the receiver -> hit segment:
    depth-test a few interior points against the half-res z buffer; a
    surface in front of the segment (within a relative thickness window)
    marks the reused sample occluded. The march is clamped to `max_px`
    screen pixels from the receiver: the occluders that matter are local,
    and every depth fetch stays a local warp (kernel W). With `band`, vz_h
    is the band's and `vz_whole` the gathered plane the warps read."""
    from .hit_lighting import _project_to_uv

    hh, hw = vz_h.shape if band is None else (band.height, band.width)
    uv0 = im.pixel_uv(hh, hw, device=vz_h.device, band=band)
    src = vz_h if vz_whole is None else vz_whole
    z0 = vz_h
    uv1, inb1 = _project_to_uv(view.world_to_clip, hit)
    wv = view.world_to_view
    z1 = -(wv[2, 0] * hit[..., 0] + wv[2, 1] * hit[..., 1]
           + wv[2, 2] * hit[..., 2] + wv[2, 3])
    delta = uv1 - uv0
    px_len = torch.sqrt((delta[..., 0] * hw) ** 2 + (delta[..., 1] * hh) ** 2)
    scale = torch.clamp(max_px / torch.clamp(px_len, min=1e-6), max=1.0)

    occ = torch.zeros(vz_h.shape, dtype=torch.bool, device=vz_h.device)
    for i in range(samples):
        s = (i + 1.0) / (samples + 1.0)
        uv = uv0 + delta * (scale * s)[..., None]
        # view-z approximately linear along the clamped screen segment
        z_e = z0 + (z1 - z0) * scale * s
        z_s = im.warp_nearest(src[..., None], torch.clamp(uv, 0.0, 1.0),
                              window_rows=40)[..., 0]
        rel = (z_e - z_s) / torch.clamp(z_s, min=1e-4)
        occ = occ | (inb1 & (rel > 0.05) & (rel < 0.6))
    return occ


def _geo_weight(vz, vz_n, n, n_n):
    w_z = (torch.abs(vz - vz_n) / (0.1 * vz + 1e-4)) < 1.0
    w_n = dot3(n, n_n) > 0.7
    return w_z & w_n


def spatial_offsets(hh: int, hw: int, frame_idx, pass_idx: int, device):
    """Per-tile tap offsets (dy, dx) of spatial pass `pass_idx`, each
    (n_taps, tiles) int32: golden-angle spiral taps whose rotation is one
    random angle per (8, 128) tile."""
    radius, n_taps = SPATIAL_PASSES[pass_idx]
    nty, ntx = tsc.tile_grid(hh, hw)
    trow = torch.arange(nty * ntx, dtype=torch.int64, device=device)
    t_rng = rng_mod.pixel_rng(trow % ntx, trow // ntx, frame_idx,
                              stream=47 + pass_idx)
    u_ang, _ = rng_mod.rand_u01(t_rng)                   # (tiles,)
    ks = const_tensor(tuple(float(k) for k in range(1, n_taps + 1)), device)
    ang = (ks[:, None] + u_ang[None, :]) * GOLDEN_ANGLE
    r = torch.sqrt(ks / n_taps)[:, None] * radius
    dy = torch.round(torch.sin(ang) * r).to(torch.int32)
    dx = torch.round(torch.cos(ang) * r).to(torch.int32)
    return dy, dx


def _tile_window(img, dy, dx, band, reach: int):
    """Kernel S's input for a band: the band with `reach` halo rows each
    side, preceded by as many zero rows as bring its first row onto the
    (TH, TW) tile grid, and the per-tile offsets of the window's tiles.
    Returns (window, rows above the band, dy, dx)."""
    win, above = band.halo(img, reach, reach, label="restir spatial")
    start = band.y0 - above
    pad = start % tsc.TH
    if pad:
        win = torch.cat([win.new_zeros((pad,) + tuple(win.shape[1:])), win])
    t0 = (start - pad) // tsc.TH
    nty_w, ntx = tsc.tile_grid(win.shape[0], win.shape[1])
    nty, _ = tsc.tile_grid(band.height, band.width)

    def cut(o):
        if t0 == 0 and nty_w == nty:
            return o
        return o.reshape(o.shape[0], nty, ntx)[:, t0:t0 + nty_w].reshape(
            o.shape[0], -1)

    return win, above + pad, cut(dy), cut(dx)


def restir_diffuse(state, candidates, gb_h, reproj, frame_idx,
                   ssao_h=None, near: float = 0.01, view=None,
                   occlusion_samples: int = 2, band=None):
    """Temporal + 2 spatial reservoir passes at half res.

    candidates: dict from rtdgi.finish_candidates. Returns (reservoir dict
    for resolve, new flat state). view + occlusion_samples > 0 enable the
    final spatial pass's screen-space occlusion raymarch, which rejects
    occluded taps and cuts the light leaks of bare reservoir reuse. `band`:
    gb_h's (half-res) row band."""
    hh, hw = gb_h["hit"].shape
    y0, full_hh = (0, hh) if band is None else (band.y0, band.height)
    dev = gb_h["hit"].device
    n = gb_h["normal"]
    pos = gb_h["pos"]
    vz = near / torch.clamp(gb_h["depth"], min=1e-12)

    px = torch.arange(y0 * hw, (y0 + hh) * hw, dtype=torch.int64,
                      device=dev).reshape(hh, hw)
    rng = rng_mod.pixel_rng(px % hw, px // hw, frame_idx, stream=41)

    # ---- candidate reservoir (M=1)
    cand_payload = {"radiance": candidates["radiance"],
                    "hit": candidates["hit_pos"],
                    "hitn": candidates["hit_normal"]}
    lum = luminance(candidates["radiance"])
    cosg = torch.clamp(dot3(candidates["ray_dir"], n), min=0.0)
    p_hat_c = lum * cosg
    w_c = math.pi * lum                       # p_hat / (cos/pi)
    cur = rsv.init((hh, hw), cand_payload)
    u, rng = rng_mod.rand_u01(rng)
    cur = rsv.update(cur, cand_payload, w_c, p_hat_c, u,
                     mask=candidates["valid"])

    # ---- temporal: reprojected previous reservoir. The reprojected lane
    # names ~the same surface point, so the jacobian is ~1; the direction is
    # still re-derived from the current surface.
    prev_uv = im.decimate2(reproj["prev_uv"])
    validity = im.decimate2(reproj["validity"])
    prev_f = _unres13(im.warp_nearest(_res13(_pack(state)), prev_uv,
                                      band=band))
    prev_f = rsv.clamp_m(prev_f, M_CLAMP_TEMPORAL)
    p_hat_t = _p_hat_at(prev_f["payload"], pos, n)
    u, rng = rng_mod.rand_u01(rng)
    cur = rsv.merge(cur, prev_f, p_hat_t, u,
                    mask=(validity > 0.5) & candidates["valid"])

    # the post-temporal reservoir is what persists to the next frame:
    # feeding the post-spatial result back would let samples random-walk
    # across the screen over frames
    next_state = _unpack(cur)

    # ---- spatial x2: all reservoir planes + geometry planes are packed
    # into one 20-channel plane so that each tap is one per-tile shift
    def pack(res):
        return torch.cat([_res13(res), n, vz[..., None], pos], dim=-1)

    def unpack(p):
        return (_unres13(p), p[..., 13:16], p[..., 16], p[..., 17:20])

    vz_whole = None
    for pass_idx, (radius, n_taps) in enumerate(SPATIAL_PASSES):
        with pass_scope(f"spatial{pass_idx}"):
            packed = pack(cur).contiguous()
            dy_s, dx_s = spatial_offsets(full_hh, hw, frame_idx, pass_idx,
                                         dev)
            above = 0
            if band is not None:
                packed, above, dy_s, dx_s = _tile_window(
                    packed, dy_s, dx_s, band, math.ceil(radius))
            do_occl = (pass_idx == 1 and view is not None
                       and occlusion_samples > 0)
            if do_occl and band is not None and vz_whole is None:
                vz_whole = band.gather(vz, label="occlusion depth")
            for k in range(n_taps):
                u, rng = rng_mod.rand_u01(rng)
                nb, n_nb, vz_nb, pos_nb = unpack(
                    tsc.tile_shift(packed, dy_s[k], dx_s[k])[above:above + hh])
                ok = _geo_weight(vz, vz_nb, n, n_nb) & candidates["valid"]
                if do_occl:
                    ok = ok & ~_occluded(pos, nb["payload"]["hit"], vz, view,
                                         near, occlusion_samples, band=band,
                                         vz_whole=vz_whole)
                # reconnection: the neighbour's hit sample evaluated from
                # our surface; density moved by the jacobian
                p_hat_nb = _p_hat_at(nb["payload"], pos, n)
                jac = _jacobian(nb["payload"]["hit"], nb["payload"]["hitn"],
                                pos_nb, pos)
                nb = rsv.clamp_m(nb, M_CLAMP_SPATIAL * M_CLAMP_TEMPORAL)
                cur = rsv.merge(cur, nb, p_hat_nb, u, mask=ok, w_scale=jac)

    return cur, next_state


VALIDATE_PERIOD = 3


def validation_rays(state, gb_h):
    """Ray batch for the quarter-res GI reservoir re-trace. Returns (org, d,
    ctx): ctx carries what apply_validation needs; org / d are (qh*qw, 3)
    flat rays that the frame batches into its shared secondary wavefront."""
    ray_eps = 1e-4
    pos_q = im.decimate2(gb_h["pos"])
    gn_q = im.decimate2(gb_h["geo_normal"])
    hit_q = im.decimate2(state["gi_res_payload_hit"])
    rad_q = im.decimate2(state["gi_res_payload_radiance"])

    d3, t_old = _reconnect(hit_q.reshape(-1, 3), pos_q.reshape(-1, 3))
    live = luminance(rad_q.reshape(-1, 3)) + t_old > 1e-3
    d = torch.where(live[:, None], d3,
                    const_tensor((0.0, 1.0, 0.0), d3.device))
    org = pos_q.reshape(-1, 3) + gn_q.reshape(-1, 3) * ray_eps * 8
    ctx = {"qh": hit_q.shape[0], "qw": hit_q.shape[1], "live": live,
           "t_old": t_old, "rad_q": rad_q}
    return org, d, ctx


def apply_validation(state, ctx, hit_t, fresh):
    """Second half of the reservoir validation: given the re-traced hit
    distances + fresh radiance of `validation_rays`, replace or cut stale
    reservoir lanes. Where the radiance disagrees,
      * if the hit distance still matches (same surface, changed lighting):
        replace the stored radiance, with firefly clamps on M and W;
      * if the hit moved (occlusion change): only cut history and let
        M-clamping re-weigh the stale sample.
    Returns (new_state, invalidity): invalidity (half-res, 0..1, the
    smoothstep of relative radiance change) feeds the temporal filter's
    history cut."""
    hh, hw = state["gi_res_w_sum"].shape
    qh, qw = ctx["qh"], ctx["qw"]
    live, t_old, rad_q = ctx["live"], ctx["t_old"], ctx["rad_q"]

    old = rad_q.reshape(-1, 3)
    rel = torch.abs(old - fresh) / torch.clamp(old + fresh, min=1e-3)
    rad_diff = torch.sqrt(dot3(rel, rel))
    inv_q = torch.where(
        live, _smoothstep(0.1, 0.5, rad_diff / math.sqrt(3.0)), 0.0)
    t_new = torch.clamp(hit_t, max=1e8)
    same_hit = (torch.abs(t_new - t_old)
                / torch.clamp(2.0 * t_old, min=1e-3)) < 0.2
    mismatch = inv_q > 0.0

    # scatter back to half res: only the top-left reservoir of each 2x2 was
    # re-traced along its ray; neighbours only get their history cut
    def up2(x):
        r = x.reshape((qh, qw) + tuple(x.shape[1:]))
        return r.repeat_interleave(2, 0).repeat_interleave(2, 1)[:hh, :hw]

    inv_h = up2(inv_q)
    block_replace = up2(mismatch & same_hit & live)
    block_occl = up2(mismatch & ~same_hit & live)
    dev = inv_h.device
    rows = torch.arange(hh, device=dev)[:, None]
    cols = torch.arange(hw, device=dev)[None, :]
    traced_lane = (rows % 2 == 0) & (cols % 2 == 0)
    # fresh payload only on the lane that was actually re-traced; its three
    # 2x2 neighbours (stale payload) and all occlusion-changed lanes just get
    # their history cut
    replace = block_replace & traced_lane
    cut_only = (block_replace & ~traced_lane) | block_occl

    fresh_h = up2(fresh)
    lum_old_h = luminance(state["gi_res_payload_radiance"])
    lum_new_h = luminance(fresh_h)
    ratio = lum_old_h / torch.clamp(lum_new_h, min=1e-8)
    # p_hat = lum * cos: the hit point (and thus dir) is unchanged on
    # replaced lanes, so rescale by the luminance ratio
    p_hat_new = torch.where(
        lum_old_h > 1e-8,
        state["gi_res_p_hat"] / torch.clamp(ratio, min=1e-8), lum_new_h)

    new = dict(state)
    new["gi_res_payload_radiance"] = torch.where(
        replace[..., None], fresh_h, state["gi_res_payload_radiance"])
    new["gi_res_p_hat"] = torch.where(replace, p_hat_new,
                                      state["gi_res_p_hat"])
    # firefly clamps: M shrinks by the luminance ratio when the scene got
    # brighter; W allows up to a 10x increment then dims
    m_f = torch.where(replace, torch.clamp(ratio, 0.03, 1.0), 1.0)
    w_f = torch.where(replace, torch.clamp(ratio * 10.0, 0.01, 1.0), 1.0)
    new["gi_res_M"] = state["gi_res_M"] * m_f
    new["gi_res_W"] = state["gi_res_W"] * w_f
    # keep w_sum consistent with W = w_sum / (M * p_hat) on replaced lanes
    new["gi_res_w_sum"] = torch.where(
        replace,
        new["gi_res_M"] * new["gi_res_W"]
        * torch.clamp(new["gi_res_p_hat"], min=0.0),
        state["gi_res_w_sum"])
    # occlusion-changed neighbours: a proportional M cut re-weighs them fast
    m_old = new["gi_res_M"]
    factor = torch.where(cut_only & (m_old > 1.0),
                         1.0 / torch.clamp(m_old, min=1.0), 1.0)
    new["gi_res_M"] = m_old * factor
    new["gi_res_w_sum"] = new["gi_res_w_sum"] * factor
    return new, inv_h


def validate_reservoirs(ts, state, gb_h, sky_env, diffuse_env, frame_idx,
                        prev_lit=None, prev_depth=None, view=None,
                        ircache_lookup=None, max_trace_steps=None,
                        secondary_full_shading: bool = False):
    """Standalone quarter-res reservoir validation (tests / non-batched
    callers): validation_rays -> trace -> shade -> apply_validation. The
    frame batches the rays into its shared secondary wavefront."""
    from ..rt.trace import scene_trace_closest
    from .hit_lighting import hit_radiance

    org, d, ctx = validation_rays(state, gb_h)
    hit = scene_trace_closest(ts, org, d, t_min=1e-4,
                              max_steps=max_trace_steps)
    fresh = hit_radiance(ts, hit, d, sky_env, diffuse_env,
                         prev_lit=prev_lit, prev_depth=prev_depth,
                         view=view, ircache_lookup=ircache_lookup,
                         max_trace_steps=max_trace_steps,
                         full_shading=secondary_full_shading)
    return apply_validation(state, ctx, hit.t, fresh)


def _smoothstep(lo, hi, x):
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


NEAR_FIELD_RADIUS_PX = 80.0


def resolve(reservoir, gb, candidates=None, ssao=None, near: float = 0.01,
            band=None):
    """Half-res reservoirs -> full-res E/pi: 4-tap joint-bilateral footprint;
    each reservoir contributes its estimator L * cos(n_full, dir) * W, with
    the direction re-derived from the full-res surface point and the
    reconnection jacobian applied.

    Near / far split (when `candidates` + `ssao` are passed): reservoir
    samples whose hit lies inside the near-field radius (80 px scaled by view
    depth) fade out and the pixel's own candidate ray covers that range
    instead, modulated by SSAO: in open areas the candidate takes over, in
    deep corners the reservoirs keep full weight.

    Each of the 4 output phases is computed entirely at half res (every tap
    is a static +-1 shift of a half-res plane with a constant bilinear
    weight) and the finished radiance is woven once at the end. `band`:
    gb's row band (parallel/)."""
    full_h = gb["depth"].shape[0] if band is None else band.height
    hb = None if band is None else band.half()
    vz_ph = im.phase_split(near / torch.clamp(gb["depth"], min=1e-12))
    n_ph = im.phase_split(gb["normal"])
    pos_ph = im.phase_split(gb["pos"])
    ssao_ph = im.phase_split(ssao) if ssao is not None else None
    # the half-res lattice samples full-res phase (0, 0)
    vz_h = vz_ph[0][0]
    n_h = n_ph[0][0]
    pos_h = pos_ph[0][0]
    rad_res = reservoir["payload"]["radiance"]
    hit_res = reservoir["payload"]["hit"]
    hitn_res = reservoir["payload"]["hitn"]
    w_res = reservoir["W"]
    split = candidates is not None and ssao is not None
    dev = vz_h.device

    # one 17-channel packed half-res plane; per phase the 4 bilinear taps
    # ride a stacked (4, hh, hw, 17) axis
    packed_h = torch.cat([
        vz_h[..., None], n_h, pos_h, hit_res, hitn_res,
        w_res[..., None], rad_res], dim=-1)

    out_ph = [[None, None], [None, None]]
    for py in (0, 1):
        for px in (0, 1):
            vz = vz_ph[py][px]
            nf = n_ph[py][px]
            pf = pos_ph[py][px]
            # near-field window scales with view depth and pixel footprint
            nf_end = vz * (NEAR_FIELD_RADIUS_PX / full_h * 0.5)
            nf_start = nf_end * 0.5
            infl = ssao_ph[py][px] if split else None
            offs = [(ky - 1 + py, kx - 1 + px) for ky in (0, 1)
                    for kx in (0, 1)]
            bw = const_tensor(tuple((0.75 if ky != py else 0.25)
                                    * (0.75 if kx != px else 0.25)
                                    for ky in (0, 1) for kx in (0, 1)),
                              dev)[:, None, None]
            s = im.shift_stack(packed_h, offs, hb)    # (4, hh, hw, 17)
            zz, nn = s[..., 0], s[..., 1:4]
            owner_pos = s[..., 4:7]
            hits, hitns = s[..., 7:10], s[..., 10:13]
            ww, rad = s[..., 13], s[..., 14:17]
            w_z = torch.exp(-torch.abs(zz - vz) / (0.05 * vz + 1e-4))
            w_n = pow8(torch.clamp(dot3(nn, nf), min=0.0))
            wt = bw * w_z * w_n + 1e-6
            dirs, dist = _reconnect(hits, pf)
            cosf = torch.clamp(dot3(dirs, nf), min=0.0)
            jac = _jacobian(hits, hitns, owner_pos, pf)
            contrib = cosf * jac * ww
            if split:
                far = _smoothstep(nf_start, nf_end, dist)
                contrib = contrib * (1.0 + (far - 1.0) * infl)
            acc = torch.sum(rad * (contrib * wt)[..., None], dim=0)
            accw = torch.sum(wt, dim=0)
            # the estimator integrates L cos / pdf == pi * E/pi
            e_over_pi = acc / accw[..., None] / math.pi
            if split:
                # the pixel's own candidate covers the faded-out near field
                # (cosine-sampled: its E/pi estimate is the radiance)
                _cdir, cdist = _reconnect(candidates["hit_pos"], pf)
                near_w = _smoothstep(nf_end, nf_start, cdist) * infl
                near_w = torch.where(candidates["valid"], near_w, 0.0)
                e_over_pi = (e_over_pi
                             + candidates["radiance"] * near_w[..., None])
            out_ph[py][px] = e_over_pi
    return im.weave2x2(out_ph)
