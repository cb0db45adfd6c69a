"""RTR: ray-traced reflections (half-res, VNDF-sampled) with ReSTIR temporal
reservoir reuse, validation and contact hardening (port of
`kajiya_tpu/renderers/rtr.py`).

Half-res GGX VNDF reflection rays are lit by the shared hit lighting,
exchanged through temporal reservoirs (target p_hat = luminance(L) *
pdf_vndf here, so the estimate (L / lum(L)) * w_sum / M reduces to the plain
traced one for a single fresh candidate), validated every third frame at
quarter res, joined by the diffuse GI candidates on rough lobes, resolved to
full res by a 13-tap BRDF-lobe footprint and filtered temporally with a
ray-length-driven history length. The deferred combine multiplies the
preintegrated FG term. The temporal fetch of the packed reservoirs and the
history reprojection go through the warp kernel (core/img.py).

With a row `band` (parallel/; every function takes the band of the
full-res g-buffer it is given), the RNG, blue noise and lane parities take
screen rows, the temporal fetches gather their source, the resolves fetch
their halo rows, and the footprint's size law reads the frame's height.
"""
from __future__ import annotations

import math

import torch

from ..brdf import ggx
from ..core import bluenoise
from ..core import img as im
from ..core import rng as rng_mod
from ..core.color import luminance
from ..core.profiling import pass_scope
from ..device import const_tensor
from ..ops import reservoir as rsv
from ..ops.smallvec import dot3, norm3
from ..rt.trace import scene_trace_closest
from .hit_lighting import hit_radiance
from .reprojection import reproject_planes

RAY_EPS = 1e-4
VALIDATE_PERIOD = 3       # re-check stored rays every 3rd frame (quarter res)
RTDGI_REUSE_ROUGHNESS = 0.55   # above this, rtdgi candidates join the RIS
KEYS = ("rtr_history", "rtr_hist_len", "rtr_ray_len", "rtr_res_radiance",
        "rtr_res_dir", "rtr_res_t", "rtr_res_w_sum", "rtr_res_M",
        "rtr_res_W", "rtr_res_p_hat")


def init_state(h: int, w: int, device=None):
    hh, hw = h // 2, w // 2

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "rtr_history": z(h, w, 3),
        "rtr_hist_len": z(h, w),
        "rtr_ray_len": z(h, w),
        # half-res reflection reservoirs
        "rtr_res_radiance": z(hh, hw, 3),
        "rtr_res_dir": z(hh, hw, 3),
        "rtr_res_t": z(hh, hw),
        "rtr_res_w_sum": z(hh, hw),
        "rtr_res_M": z(hh, hw),
        "rtr_res_W": z(hh, hw),
        "rtr_res_p_hat": z(hh, hw),
    }


def _half_y0(band):
    return 0 if band is None else band.half().y0


def reflection_rays(gb, frame_idx, band=None):
    """Half-res VNDF reflection ray batch. Returns (org, wi, pdf, rng); the
    frame batches these into the shared secondary trace + shade wavefront."""
    pos = im.decimate2(gb["pos"])
    n = im.decimate2(gb["normal"])
    gn = im.decimate2(gb["geo_normal"])
    rough = im.decimate2(gb["roughness"])
    hh, hw = rough.shape
    rd = im.decimate2(gb["ray_dir"])
    dev = rough.device

    y0 = _half_y0(band)
    px = torch.arange(y0 * hw, (y0 + hh) * hw, dtype=torch.int64, device=dev)
    rng = rng_mod.pixel_rng(px % hw, px // hw, frame_idx, stream=31)
    # blue-noise VNDF sample: glossy lobes get well-spread neighbour samples
    bu1, bu2 = bluenoise.blue_noise_pair(hh, hw, frame_idx, stream=2,
                                         device=dev, y0=y0)
    u1 = bu1.reshape(-1)
    u2 = bu2.reshape(-1)

    nf = n.reshape(-1, 3)
    wo = -rd.reshape(-1, 3)
    wi = ggx.sample_vndf(rough.reshape(-1), nf, wo, u1, u2)
    # reflect below-horizon samples back up
    below = dot3(wi, nf) < 1e-4
    wi = torch.where(below[:, None], wi - 2.0 * dot3(wi, nf)[:, None] * nf,
                     wi)
    wi = wi / torch.clamp(norm3(wi), min=1e-12)[:, None]
    pdf = ggx.pdf_vndf(rough.reshape(-1), nf, wo, wi)

    org = pos.reshape(-1, 3) + gn.reshape(-1, 3) * RAY_EPS * 8
    return org, wi, pdf, rng


def finish_reflections(gb, wi, pdf, hit_t, rad):
    """Assemble the half-res reflection dict from the wavefront's results."""
    hitm = im.decimate2(gb["hit"])
    hh, hw = hitm.shape
    valid = hitm.reshape(-1)
    return {
        "radiance": torch.where(valid[:, None], rad, 0.0).reshape(hh, hw, 3),
        "ray_t": torch.clamp(hit_t, max=1e8).reshape(hh, hw),
        "wi": wi.reshape(hh, hw, 3),
        "pdf": pdf.reshape(hh, hw),
        "valid": valid.reshape(hh, hw),
    }


def trace_reflections(ts, gb, frame_idx, sky_env, diffuse_env,
                      prev_lit=None, prev_depth=None, view=None,
                      ircache_lookup=None, max_trace_steps=None,
                      secondary_full_shading: bool = False, band=None):
    """Standalone half-res reflection trace (tests / non-batched callers);
    the frame batches reflection_rays into one shared wavefront."""
    org, wi, pdf, rng = reflection_rays(gb, frame_idx, band)
    hit = scene_trace_closest(ts, org, wi, t_min=RAY_EPS,
                              max_steps=max_trace_steps)
    rad = hit_radiance(ts, hit, wi, sky_env, diffuse_env,
                       prev_lit=prev_lit, prev_depth=prev_depth, view=view,
                       ircache_lookup=ircache_lookup,
                       max_trace_steps=max_trace_steps, rng=rng,
                       full_shading=secondary_full_shading)
    return finish_reflections(gb, wi, pdf, hit.t, rad)


# ----------------------------------------------------------------------------
# ReSTIR temporal reservoir exchange
# ----------------------------------------------------------------------------

def _pack_res(state):
    return {
        "payload": {"radiance": state["rtr_res_radiance"],
                    "dir": state["rtr_res_dir"],
                    "t": state["rtr_res_t"]},
        "w_sum": state["rtr_res_w_sum"],
        "M": state["rtr_res_M"],
        "W": state["rtr_res_W"],
        "p_hat": state["rtr_res_p_hat"],
    }


def _unpack_res(r):
    return {
        "rtr_res_radiance": r["payload"]["radiance"],
        "rtr_res_dir": r["payload"]["dir"],
        "rtr_res_t": r["payload"]["t"],
        "rtr_res_w_sum": r["w_sum"],
        "rtr_res_M": r["M"],
        "rtr_res_W": r["W"],
        "rtr_res_p_hat": r["p_hat"],
    }


def restir_reflections(state, half, gb, reproj, frame_idx,
                       rtdgi_candidates=None, band=None):
    """Temporal reservoir resampling for reflections. Returns
    (spec (hh, hw, 3) lobe-average radiance, ray_len (hh, hw), new reservoir
    state). Reuse from the previous frame is weighted by how well the stored
    direction fits the current lobe: mirrors do not bleed across lobes,
    rough pixels reuse freely."""
    hh, hw = half["valid"].shape
    n = im.decimate2(gb["normal"]).reshape(-1, 3)
    wo = -im.decimate2(gb["ray_dir"]).reshape(-1, 3)
    rough_h = im.decimate2(gb["roughness"])
    rough = rough_h.reshape(-1)
    dev = rough.device

    y0 = _half_y0(band)
    px = torch.arange(y0 * hw, (y0 + hh) * hw, dtype=torch.int64,
                      device=dev).reshape(hh, hw)
    rng = rng_mod.pixel_rng(px % hw, px // hw, frame_idx, stream=37)

    def p_hat_of(radiance, direction):
        dirf = direction.reshape(-1, 3)
        lum = luminance(radiance.reshape(-1, 3))
        pdf_here = ggx.pdf_vndf(rough, n, wo, dirf)
        cos_ok = dot3(dirf, n) > 0.0
        return torch.where(cos_ok, lum * pdf_here, 0.0).reshape(hh, hw)

    # ---- fresh candidate (M=1): w = p_hat / pdf_vndf = lum(L)
    cand_payload = {"radiance": half["radiance"], "dir": half["wi"],
                    "t": half["ray_t"]}
    p_hat_c = p_hat_of(half["radiance"], half["wi"])
    w_c = p_hat_c / torch.clamp(half["pdf"], min=1e-12)
    cur = rsv.init((hh, hw), cand_payload)
    u, rng = rng_mod.rand_u01(rng)
    cur = rsv.update(cur, cand_payload, w_c.reshape(hh, hw), p_hat_c, u,
                     mask=half["valid"])

    # ---- the diffuse candidate ray doubles as a second specular candidate
    # for rough lobes, at no extra ray; its source pdf is cosine
    if rtdgi_candidates is not None:
        gi_dir = rtdgi_candidates["ray_dir"]
        gi_rad = rtdgi_candidates["radiance"]
        gi_t = rtdgi_candidates["ray_t"]
        cosg = torch.clamp(dot3(gi_dir.reshape(-1, 3), n), min=0.0)
        pdf_cos = torch.clamp(cosg / math.pi, min=1e-12)
        p_hat_g = p_hat_of(gi_rad, gi_dir)
        w_g = (p_hat_g.reshape(-1) / pdf_cos).reshape(hh, hw)
        ok = (half["valid"] & rtdgi_candidates["valid"]
              & (rough_h > RTDGI_REUSE_ROUGHNESS))
        u, rng = rng_mod.rand_u01(rng)
        cur = rsv.update(
            cur, {"radiance": gi_rad, "dir": gi_dir, "t": gi_t},
            w_g, p_hat_g, u, mask=ok)

    # ---- temporal merge with the reprojected previous reservoir: all 11
    # channels in one nearest warp
    prev = _pack_res(state)
    packed_prev = torch.cat([
        prev["payload"]["radiance"], prev["payload"]["dir"],
        prev["payload"]["t"][..., None], prev["w_sum"][..., None],
        prev["M"][..., None], prev["W"][..., None],
        prev["p_hat"][..., None]], dim=-1)
    f = im.warp_nearest(packed_prev, im.decimate2(reproj["prev_uv"]),
                        band=None if band is None else band.half())
    prev_f = {
        "payload": {"radiance": f[..., 0:3], "dir": f[..., 3:6],
                    "t": f[..., 6]},
        "w_sum": f[..., 7], "M": f[..., 8], "W": f[..., 9],
        "p_hat": f[..., 10],
    }
    # roughness-scaled M clamp: mirrors keep little history, rough lobes
    # accumulate up to ~12 samples
    m_clamp = 1.0 + rough_h * 11.0
    prev_f = rsv.clamp_m(prev_f, m_clamp)
    p_hat_t = p_hat_of(prev_f["payload"]["radiance"], prev_f["payload"]["dir"])
    validity = im.decimate2(reproj["validity"])
    u, rng = rng_mod.rand_u01(rng)
    cur = rsv.merge(cur, prev_f, p_hat_t, u,
                    mask=(validity > 0.5) & half["valid"])

    # ---- unbiased lobe-average estimate:
    # E[L] ~= L * pdf_here * W  ==  (L / lum(L)) * w_sum / M
    sel_rad = cur["payload"]["radiance"]
    sel_phat = p_hat_of(sel_rad, cur["payload"]["dir"])
    est = sel_rad * (sel_phat * cur["W"])[..., None] / torch.clamp(
        luminance(sel_rad), min=1e-8)[..., None]
    # reservoirs that never saw a sample fall back to the fresh trace
    est = torch.where((cur["M"] > 0.0)[..., None], est, half["radiance"])
    ray_len = torch.where(cur["M"] > 0.0, cur["payload"]["t"], half["ray_t"])
    return est, ray_len, _unpack_res(cur)


def validation_rays(state, gb):
    """Ray batch for the quarter-res re-trace of the stored reflection
    reservoir rays. Returns (org, d, ctx); the frame batches the rays into
    its shared secondary wavefront."""
    pos_q = im.decimate2(im.decimate2(gb["pos"]))
    gn_q = im.decimate2(im.decimate2(gb["geo_normal"]))
    dir_q = im.decimate2(state["rtr_res_dir"])
    rad_q = im.decimate2(state["rtr_res_radiance"])

    d = dir_q.reshape(-1, 3)
    live = norm3(d) > 0.5
    d = torch.where(live[:, None], d, const_tensor((0.0, 1.0, 0.0), d.device))
    org = pos_q.reshape(-1, 3) + gn_q.reshape(-1, 3) * RAY_EPS * 8
    ctx = {"qh": dir_q.shape[0], "qw": dir_q.shape[1], "live": live,
           "rad_q": rad_q}
    return org, d, ctx


def _up2(x, hh, hw):
    return x.repeat_interleave(2, 0).repeat_interleave(2, 1)[:hh, :hw]


def apply_validation(state, ctx, hit_t, fresh, band=None):
    """Second half of the reflection validation: where the fresh radiance
    disagrees with the stored one, the stored sample is replaced and its
    history cut, so stale reflections die within one validation period."""
    hh, hw = state["rtr_res_t"].shape
    qh, qw = ctx["qh"], ctx["qw"]
    live, rad_q = ctx["live"], ctx["rad_q"]
    lum_old = luminance(rad_q.reshape(-1, 3))
    lum_new = luminance(fresh)
    mismatch = (torch.abs(lum_new - lum_old)
                > 0.3 * torch.clamp(torch.maximum(lum_old, lum_new),
                                    min=1e-3))
    invalid = (mismatch & live).reshape(qh, qw)

    # scatter back to half res: only the top-left reservoir of each 2x2 was
    # re-traced (along ITS stored dir), so only that lane gets the fresh
    # payload; the 3 neighbours keep theirs with their history cut
    inv_h = _up2(invalid, hh, hw)
    fresh_h = _up2(fresh.reshape(qh, qw, 3), hh, hw)
    t_h = _up2(torch.clamp(hit_t, max=1e8).reshape(qh, qw), hh, hw)
    dev = inv_h.device
    y0 = _half_y0(band)
    rows = torch.arange(y0, y0 + hh, device=dev)[:, None]
    cols = torch.arange(hw, device=dev)[None, :]
    traced_lane = (rows % 2 == 0) & (cols % 2 == 0)
    replace = inv_h & traced_lane
    cut_only = inv_h & ~traced_lane

    # p_hat = lum(L) * pdf_vndf(dir): dir is unchanged on the re-traced
    # lane, so the new p_hat is the old one rescaled by the luminance ratio
    lum_old_h = luminance(state["rtr_res_radiance"])
    lum_new_h = luminance(fresh_h)
    p_hat_new = torch.where(lum_old_h > 1e-8,
                            state["rtr_res_p_hat"] * lum_new_h
                            / torch.clamp(lum_old_h, min=1e-8),
                            lum_new_h)

    new = dict(state)
    new["rtr_res_radiance"] = torch.where(replace[..., None], fresh_h,
                                          state["rtr_res_radiance"])
    new["rtr_res_t"] = torch.where(replace, t_h, state["rtr_res_t"])
    new["rtr_res_p_hat"] = torch.where(replace, p_hat_new,
                                       state["rtr_res_p_hat"])
    # a replaced sample restarts with M=1, w_sum=lum: its estimate
    # (L/lum)*w_sum/M equals the fresh trace; W = w_sum/(M*p_hat)
    w_sum_r = lum_new_h
    new["rtr_res_w_sum"] = torch.where(replace, w_sum_r,
                                       state["rtr_res_w_sum"])
    new["rtr_res_W"] = torch.where(
        replace, w_sum_r / torch.clamp(p_hat_new, min=1e-8),
        state["rtr_res_W"])
    new["rtr_res_M"] = torch.where(replace, 1.0, state["rtr_res_M"])
    # neighbours: proportional M clamp (W = w_sum/(M*p_hat) invariant)
    m_old = new["rtr_res_M"]
    factor = torch.where(cut_only & (m_old > 1.0),
                         1.0 / torch.clamp(m_old, min=1.0), 1.0)
    new["rtr_res_M"] = m_old * factor
    new["rtr_res_w_sum"] = new["rtr_res_w_sum"] * factor
    return new


def validate_reservoirs(ts, state, gb, sky_env, diffuse_env, frame_idx,
                        prev_lit=None, prev_depth=None, view=None,
                        ircache_lookup=None, max_trace_steps=None,
                        secondary_full_shading: bool = False, band=None):
    """Standalone reservoir validation (tests / non-batched callers):
    validation_rays -> trace -> shade -> apply_validation."""
    org, d, ctx = validation_rays(state, gb)
    hit = scene_trace_closest(ts, org, d, t_min=RAY_EPS,
                              max_steps=max_trace_steps)
    fresh = hit_radiance(ts, hit, d, sky_env, diffuse_env,
                         prev_lit=prev_lit, prev_depth=prev_depth, view=view,
                         ircache_lookup=ircache_lookup,
                         max_trace_steps=max_trace_steps,
                         full_shading=secondary_full_shading)
    return apply_validation(state, ctx, hit.t, fresh, band)


_TAPS = ((0, 0),
         (0, 1), (0, -1), (1, 0), (-1, 0),
         (1, 1), (1, -1), (-1, 1), (-1, -1),
         (2, 2), (2, -2), (-2, 2), (-2, -2))


def _resolve_footprint(res_planes, spec_h, ray_len_h, gb, view,
                       near: float = 0.01, band=None):
    """Full-res BRDF-lobe footprint resolve: a static lattice of 13 half-res
    taps (centre, r=1 ring, r~2.8 ring) shared by the four output phases,
    each re-weighted like the reference's resolve:
      w = ring(sigma_px) * pdf_vndf_centre(dir to the neighbour's stored hit)
          * W_neighbour * measure_conversion
    with its rejections (neighbour much rougher than the centre, empty
    reservoirs) and kernel-size law (sigma ~ sqrt(roughness)/4 *
    ray_len/(ray_len+eye_dist), contact-sharpening clamp included).

    res_planes: dict with rtr_res_{radiance,dir,t,W,M} half-res planes.
    spec_h: the centre fallback for lanes whose neighbourhood is empty.
    The 13 taps ride one stacked axis (the JAX function loops over them):
    a few dozen launches per output phase instead of ~45 per tap.
    Returns (spec (H, W, 3), ray_len (H, W))."""
    hb = None if band is None else band.half()
    # the kernel-size law reads the frame's half height, not the band's
    hh = ray_len_h.shape[0] if hb is None else hb.height
    dev = ray_len_h.device

    # ---- packed half-res neighbour plane (one shift per tap moves all 10
    # channels): radiance(3), stored hit point(3), t, W, view z, roughness
    pos_h = im.decimate2(gb["pos"])
    vz_h = im.decimate2(near / torch.clamp(gb["depth"], min=1e-12))
    rough_h = im.decimate2(gb["roughness"])
    rad_nb = res_planes["rtr_res_radiance"]
    t_nb = res_planes["rtr_res_t"]
    hit_nb = pos_h + res_planes["rtr_res_dir"] * t_nb[..., None]
    w_nb = torch.where(res_planes["rtr_res_M"] > 0.0,
                       res_planes["rtr_res_W"], 0.0)
    packed = torch.cat([
        rad_nb, hit_nb, t_nb[..., None], w_nb[..., None],
        vz_h[..., None], rough_h[..., None]], dim=-1)
    taps = im.shift_stack(packed, _TAPS, hb)      # (13, hh, hw, 10)
    rad_k, hit_k = taps[..., 0:3], taps[..., 3:6]
    t_k, w_k = taps[..., 6], taps[..., 7]
    vz_k, rough_k = taps[..., 8], taps[..., 9]
    # -r^2 of each tap's ring radius, for the gaussian ring weight
    neg_r2 = const_tensor(tuple(-(r * r) for r in (
        math.hypot(dy, dx) for dy, dx in _TAPS)), dev)[:, None, None]

    # ---- centre planes per output phase (one packed split: 12 channels)
    center = torch.cat([
        gb["normal"], gb["roughness"][..., None], gb["ray_dir"],
        gb["pos"], (near / torch.clamp(gb["depth"], min=1e-12))[..., None],
        gb["hit"][..., None].to(torch.float32)], dim=-1)
    center_ph = im.phase_split(center)

    v2c11 = view.view_to_clip[1, 1]             # 1 / tan(fov_y / 2)
    eye = view.eye_position
    out_v = [[None, None], [None, None]]
    out_t = [[None, None], [None, None]]
    for py in (0, 1):
        for px in (0, 1):
            c = center_ph[py][px]
            n_c, rough_c = c[..., 0:3], c[..., 3]
            wo_c = -c[..., 4:7]
            pos_c, vz_c, hit_c = c[..., 7:10], c[..., 10], c[..., 11]
            dv = pos_c - eye
            d_c = torch.sqrt(torch.clamp(dot3(dv, dv), min=1e-8))

            # footprint sigma in HALF-res pixels (contact-sharpening clamp
            # included)
            rl = ray_len_h
            cl = torch.maximum(rl, 0.2 * d_c * _sstep(0.0, 0.05 * d_c, rl))
            tan_theta = torch.sqrt(torch.clamp(rough_c, min=1e-4)) * 0.25
            sigma = 0.25 * hh * tan_theta * v2c11 * cl / (cl + d_c)
            sigma = torch.clamp(sigma, 0.7, 5.0)
            inv2s2 = 1.0 / (2.0 * sigma * sigma)

            # all 13 taps at once on the stacked axis
            dvec = hit_k - pos_c
            c2h = torch.sqrt(torch.clamp(dot3(dvec, dvec), min=1e-12))
            wi = dvec / c2h[..., None]
            pdf_c = ggx.pdf_vndf(rough_c, n_c, wo_c, wi)
            # measure conversion, clamped to <= 1
            conv = torch.clamp((t_k / c2h) ** 2, max=1.0)
            ok = ((w_k > 0.0)
                  & (rough_k <= rough_c * 2.0 + 1e-3)
                  & (torch.abs(vz_k - vz_c) < 0.15 * vz_c + 1e-4)
                  & (dot3(wi, n_c) > 0.0))
            wt = (torch.exp(neg_r2 * inv2s2) * pdf_c * w_k * conv
                  * ok.to(torch.float32))
            acc = torch.sum(rad_k * wt[..., None], dim=0)
            wacc = torch.sum(wt, dim=0)
            tacc = torch.sum(t_k * wt, dim=0)
            lo = wacc > 1e-10
            out = torch.where(lo[..., None], acc / torch.clamp(
                wacc, min=1e-10)[..., None], spec_h)
            out_v[py][px] = torch.where(hit_c[..., None] > 0.5, out, 0.0)
            out_t[py][px] = torch.where(
                lo, tacc / torch.clamp(wacc, min=1e-10), ray_len_h)
    return im.weave2x2(out_v), im.weave2x2(out_t)


def _sstep(lo, hi, x):
    t = torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _pow16(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * x8


def _resolve_full(spec_h, ray_len_h, gb, near: float = 0.01, band=None):
    """Half -> full joint-bilateral resolve, roughness-aware, with contact
    hardening (a tap whose hit distance is much longer than the centre's
    does not blur into the contact region). Phase-major: each output phase
    is computed at half res from static +-1 shifts with constant bilinear
    weights, then the planes are woven once."""
    vz_ph = im.phase_split(near / torch.clamp(gb["depth"], min=1e-12))
    n_ph = im.phase_split(gb["normal"])
    vz_h = vz_ph[0][0]
    n_h = n_ph[0][0]
    dev = vz_h.device

    # 8-channel packed half-res plane: the 4 bilinear taps of each phase
    # ride one stacked axis
    packed_h = torch.cat([vz_h[..., None], n_h, ray_len_h[..., None],
                          spec_h], dim=-1)
    out_v = [[None, None], [None, None]]
    out_t = [[None, None], [None, None]]
    for py in (0, 1):
        for px in (0, 1):
            vz = vz_ph[py][px]
            nf = n_ph[py][px]
            t_center = ray_len_h
            offs = [(ky - 1 + py, kx - 1 + px) for ky in (0, 1)
                    for kx in (0, 1)]
            bw = const_tensor(tuple((0.75 if ky != py else 0.25)
                                    * (0.75 if kx != px else 0.25)
                                    for ky in (0, 1) for kx in (0, 1)),
                              dev)[:, None, None]
            s = im.shift_stack(packed_h, offs,
                               None if band is None else band.half())
            zz, nn = s[..., 0], s[..., 1:4]
            t, v = s[..., 4], s[..., 5:8]
            w_z = torch.exp(-torch.abs(zz - vz) / (0.05 * vz + 1e-4))
            w_n = _pow16(torch.clamp(dot3(nn, nf), min=0.0))
            w_t = 1.0 / (1.0 + 2.0 * torch.abs(t - t_center)
                         / (torch.minimum(t, t_center) + 1e-3))
            wt = bw * w_z * w_n * w_t + 1e-6
            accw = torch.sum(wt, dim=0)
            out_v[py][px] = (torch.sum(v * wt[..., None], dim=0)
                             / accw[..., None])
            out_t[py][px] = torch.sum(t * wt, dim=0) / accw
    return im.weave2x2(out_v), im.weave2x2(out_t)


def rtr_pipeline(ts, gb, view, frame_idx, state, reproj, sky_env, diffuse_env,
                 prev_lit=None, prev_depth=None, ircache_lookup=None,
                 max_trace_steps=None, half=None, mesh_light_specular=False,
                 rtdgi_candidates=None, use_restir: bool = True,
                 secondary_full_shading: bool = False,
                 validated: bool = False, band=None):
    """Full chain -> (specular radiance (H, W, 3), new_state).

    half: precomputed by the frame's shared secondary-ray wavefront; traced
    here standalone when absent. `validated` marks the reservoir state as
    already validated by the frame's batched validation; otherwise it is
    validated here on every VALIDATE_PERIOD-th frame (one host read of the
    frame index). `band`: gb's row band (parallel/); the frame passes
    `half` then (the reuse source of a standalone trace is not banded)."""
    if half is None:
        half = trace_reflections(
            ts, gb, frame_idx, sky_env, diffuse_env, prev_lit=prev_lit,
            prev_depth=prev_depth, view=view, ircache_lookup=ircache_lookup,
            max_trace_steps=max_trace_steps,
            secondary_full_shading=secondary_full_shading, band=band)

    if mesh_light_specular:
        # explicit emissive-triangle specular, added into the reflection
        # stream before its filtering
        from .lighting import sample_lights_specular

        half = dict(half)
        half["radiance"] = half["radiance"] + sample_lights_specular(
            ts, gb, frame_idx, max_trace_steps=max_trace_steps, band=band)

    res_keys = [k for k in state if k.startswith("rtr_res_")]
    if use_restir and res_keys:
        res_state = {k: state[k] for k in res_keys}
        if not validated and int(frame_idx) % VALIDATE_PERIOD == 0:
            res_state = validate_reservoirs(
                ts, res_state, gb, sky_env, diffuse_env, frame_idx,
                prev_lit=prev_lit, prev_depth=prev_depth, view=view,
                ircache_lookup=ircache_lookup,
                max_trace_steps=max_trace_steps,
                secondary_full_shading=secondary_full_shading, band=band)
        with pass_scope("rtr_restir"):
            spec_h, ray_len_h, res_state = restir_reflections(
                res_state, half, gb, reproj, frame_idx,
                rtdgi_candidates=rtdgi_candidates, band=band)
        res_planes = res_state
    else:
        spec_h, ray_len_h = half["radiance"], half["ray_t"]
        res_state = {k: state[k] for k in res_keys}
        # pseudo-reservoir from the fresh trace: W = 1/pdf makes the
        # footprint estimator plain MIS-weighted averaging
        res_planes = {
            "rtr_res_radiance": half["radiance"],
            "rtr_res_dir": half["wi"],
            "rtr_res_t": half["ray_t"],
            "rtr_res_W": 1.0 / torch.clamp(half["pdf"], min=1e-8),
            "rtr_res_M": half["valid"].to(torch.float32),
        }
    with pass_scope("rtr_resolve"):
        full, ray_len = _resolve_footprint(res_planes, spec_h, ray_len_h,
                                           gb, view, band=band)

    # temporal: rougher surfaces tolerate longer history; contact regions
    # (short rays) shorten it, since they move with parallax
    with pass_scope("rtr_temporal"):
        fetched = reproject_planes(
            {"h": state["rtr_history"], "l": state["rtr_hist_len"]}, reproj,
            band)
        hist = fetched["h"]
        hist_len = fetched["l"]
        contact = torch.clamp(ray_len / 0.2, 0.0, 1.0)
        max_len = (4.0 + gb["roughness"] * 24.0) * (0.35 + 0.65 * contact)
        hist_len = torch.minimum(hist_len * reproj["validity"] + 1.0, max_len)
        alpha = (1.0 / hist_len)[..., None]
        out = hist * (1 - alpha) + full * alpha

        m1, var = im.local_moments_3x3(full, band)
        sigma = torch.sqrt(torch.clamp(var, min=0.0))
        out = torch.minimum(torch.maximum(out, m1 - sigma * 3.0 - 1e-3),
                            m1 + sigma * 3.0 + 1e-3)

    new_state = {
        "rtr_history": out,
        "rtr_hist_len": hist_len,
        "rtr_ray_len": ray_len,
        **res_state,
    }
    return out, new_state
