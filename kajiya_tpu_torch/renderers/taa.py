"""Temporal anti-aliasing / super-resolution: the reference's 7-pass chain
(port of `kajiya_tpu/renderers/taa.py`).

  1. reproject history   - warp history by the dilated closest velocity
  2. filter input        - depth-aware 3x3 input filter + deviation
  3. filter history      - luma-clamped 3x3 (5x5 when upsampling) filter
  4. input probability   - P(input belongs to the history's distribution)
  5. filter prob         - 3x3 max of the probability
  6. filter prob 2       - 5x5 dilated soft mean (exponential squish)
  7. resolve             - coverage-accumulated dual-frequency resolve

Neighbourhood ops are static edge-clamped shifts; every temporal fetch is
one packed 9-channel bilinear warp (history 3 + coverage 1 + smooth var 3 +
velocity 2) at the dilated reprojection lattice, through the warp kernel
(core/img.py). Temporal state:

  taa_history   (Ho,Wo,3) linear radiance accumulator
  taa_coverage  (Ho,Wo)   effective sample count
  taa_smooth_var(Ho,Wo,3) temporally smoothed input variance
  taa_velocity  (Ho,Wo,2) the previous frame's closest velocity (uv/frame)

Super-resolution (output larger than render res): the frame is gathered to
the output lattice with the analytic unjitter kernel, 9 input taps
pre-shifted at render res and fetched by one 27-channel nearest warp; the
planes that cross between the two resolutions do so packed, in one nearest
resize each way.

With a row `band` (parallel/), the planes are the band's: every stencil
fetches its halo rows, the pixel lattices take screen rows, the history
fetch gathers its packed source, and the sizes that decide the path are the
frame's. Under super-resolution the render-res planes hold the render band
and the output-res planes the output band (`out_band`), whose edges are not
the render band's scaled: each resize, and the 27-channel fetch, reads a
window of the other resolution's rows that its output band reaches
(`Band.window`), its lattice built on the whole frame and cut to the band.
"""
from __future__ import annotations

import math

import torch

from ..core import img as im
from ..core.color import lin_to_ycbcr, ycbcr_to_lin
from ..core.profiling import pass_scope
from ..device import const_tensor
from ..ops.smallvec import dot3, pow8

_OFF3 = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_OFF3_F = tuple((float(dy), float(dx)) for dy, dx in _OFF3)
KEYS = ("taa_history", "taa_coverage", "taa_smooth_var", "taa_velocity")


def init_state(out_h: int, out_w: int, device=None):
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "taa_history": z(out_h, out_w, 3),
        "taa_coverage": z(out_h, out_w),
        "taa_smooth_var": z(out_h, out_w, 3),
        "taa_velocity": z(out_h, out_w, 2),
    }


# --- perceptual mapping: scale rgb by sqrt(max)/max
def decode_rgb(v):
    m = torch.clamp(torch.amax(v, dim=-1, keepdim=True), min=0.0)
    return v * torch.sqrt(m) / torch.clamp(m, min=1e-20)


def encode_rgb(v):
    m = torch.amax(v, dim=-1, keepdim=True)
    return v * (torch.clamp(m, min=0.0) ** 2) / torch.clamp(m, min=1e-20)


def _len3(v):
    return torch.sqrt(torch.clamp(
        v[..., 0] ** 2 + v[..., 1] ** 2 + v[..., 2] ** 2, min=0.0))


def _len2(v):
    return torch.sqrt(torch.clamp(v[..., 0] ** 2 + v[..., 1] ** 2, min=0.0))


def _closest_velocity(depth, vel, band=None):
    """3x3 velocity dilation toward the closest surface (reversed-Z: larger
    depth = closer); ties take the first tap."""
    packed = torch.cat([depth[..., None], vel], dim=-1)
    s = im.shift_stack(packed, _OFF3, band)          # (9, H, W, 3)
    k = torch.argmax(s[..., 0], dim=0)               # closest tap index
    best = torch.gather(s, 0, k[None, ..., None].expand(1, *s.shape[1:]))[0]
    return best[..., 1:3]


def _filter_input(iycc, depth, k_dist: float, band=None):
    """Two 3x3 passes: depth-weighted (accumulating the unweighted moments
    for the deviation), then again with a luma cutoff at the first pass's
    mean. Returns (filtered (H,W,3), deviation (H,W,3))."""
    packed = torch.cat([iycc, depth[..., None]], dim=-1)
    s = im.shift_stack(packed, _OFF3, band)          # (9, H, W, 4)
    sy, sd = s[..., :3], s[..., 3]
    d_c = torch.clamp(depth, min=1e-20)
    kd = const_tensor(tuple(math.exp(-k_dist * (dy * dy + dx * dx))
                            for dy, dx in _OFF3), depth.device)[:, None, None]
    rel = torch.abs(d_c / torch.clamp(sd, min=1e-20) - 1.0)
    w_base = torch.exp2(-torch.clamp(200.0 * rel, max=16.0)) * kd

    def one_pass(cutoff):
        w = w_base
        if cutoff is not None:
            w = w * pow8(torch.clamp(
                cutoff / torch.clamp(sy[..., 0], min=1e-20), 0.0, 1.0))
        wsum = torch.sum(w, dim=0)
        ex = torch.sum(sy * w[..., None], dim=0)
        return ex / torch.clamp(wsum, min=1e-20)[..., None]

    # unweighted moments -> deviation
    m1 = sy.mean(dim=0)
    m2 = (sy ** 2).mean(dim=0)
    dev = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))

    mean1 = one_pass(None)
    filtered = one_pass(mean1[..., 0] * 1.001)
    return filtered, dev


def _filter_history(hycc, k: int, band=None):
    """Two luma-cutoff passes of radius k with distance weights
    exp(-0.8/k^2 * d^2)."""
    offs = [(dy, dx) for dy in range(-k, k + 1) for dx in range(-k, k + 1)]
    s = im.shift_stack(hycc, offs, band)             # (N, H, W, 3)
    dw = const_tensor(tuple(math.exp(-(0.8 / (k * k)) * (dy * dy + dx * dx))
                            for dy, dx in offs), hycc.device)[:, None, None]

    def one_pass(cutoff):
        if cutoff is None:
            w = dw.expand(s.shape[:3])
        else:
            w = dw * pow8(torch.clamp(
                cutoff / torch.clamp(s[..., 0], min=1e-20), 0.0, 1.0))
        return (torch.sum(s * w[..., None], dim=0)
                / torch.clamp(torch.sum(w, dim=0), min=1e-20)[..., None])

    luma = one_pass(None)[..., 0]
    return one_pass(luma * 1.001)


def _input_prob(fi, dev, vel, closest_hist, smooth_var_rr, vel_hist_rr,
                band=None):
    """Input probability, its 3x3 max and its 5x5 dilated soft mean."""
    # spatial variance: 3x3 max of the deviation at stride-2 taps
    ivar = im.shift_stack(dev, [(dy * 2, dx * 2) for dy, dx in _OFF3],
                          band).amax(dim=0)
    ivar = ivar * ivar
    combined_var = torch.minimum(smooth_var_rr, ivar * 10.0)

    packed = torch.cat([fi, vel], dim=-1)
    s = im.shift_stack(packed, _OFF3, band)          # (9, H, W, 5)
    idiff = s[..., :3] - closest_hist
    v = s[..., 3:5]
    vdiff = _len2((v - vel_hist_rr)
                  / torch.clamp(torch.abs(v + vel_hist_rr), min=1.0))
    prob = torch.exp2(-_len3(idiff * idiff
                             / torch.clamp(combined_var, min=1e-6))
                      - 1000.0 * vdiff).amax(dim=0)

    # 3x3 max
    f1 = im.shift_stack(prob, _OFF3, band).amax(dim=0)

    # 5x5 dilated mean in exponential-squish space
    sq = torch.exp2(-torch.clamp(10.0 * f1, 0.0, 100.0))
    offs5 = [(dy * 2, dx * 2) for dy in (-2, -1, 0, 1, 2)
             for dx in (-2, -1, 0, 1, 2)]
    acc = im.shift_stack(sq, offs5, band).mean(dim=0)
    return torch.clamp(-0.1 * torch.log2(1e-30 + acc), min=0.0)


def _unjitter_sample(iycc, jitter_px, h, w, out_h, out_w, kernel_scale,
                     band=None, taps=None):
    """Gather the current frame to the output lattice, undoing the sub-pixel
    jitter with an analytic kernel. Returns (color_sum, coverage, ex, ex2).

    Same-res: taps are static shifts and the offsets are per-frame scalars.
    Upsampling: the 9 taps of `_superres_taps` with per-output-pixel
    weights. `band` (same-res): iycc's row band."""
    same_res = (out_h == h and out_w == w)
    dev = iycc.device
    jx, jy = jitter_px[0], jitter_px[1]
    dyx = const_tensor(_OFF3_F, dev)                 # (9, 2)

    if same_res:
        col = im.shift_stack(iycc, _OFF3, band)      # (9, H, W, 3)
        ox = (dyx[:, 1] + jx) * kernel_scale
        oy = (dyx[:, 0] + jy) * kernel_scale
        d2 = (ox * ox + oy * oy)[:, None, None, None]    # (9, 1, 1, 1)
        dev_wt = torch.exp2(-d2)
        wt = torch.exp2(-10.0 * d2)
        res = torch.sum(col * wt, dim=0)
        wt_sum = torch.sum(wt, dim=0)[..., 0]
        ex = torch.sum(col * dev_wt, dim=0)
        ex2 = torch.sum(col * col * dev_wt, dim=0)
        dev_wt_sum = torch.sum(dev_wt, dim=0)
        cov = wt_sum.expand(iycc.shape[0], out_w)
        return res, cov, ex / dev_wt_sum, ex2 / dev_wt_sum

    # --- super-res path
    col, fx, fy, sx, sy = taps
    ox = (fx[None] + (dyx[:, 1] / sx)[:, None, None]) * kernel_scale
    oy = (fy[None] + (dyx[:, 0] / sy)[:, None, None]) * kernel_scale
    d2 = (ox * ox + oy * oy) * sx                    # (9, H, W)
    dev_wt = torch.exp2(-d2)[..., None]
    wt = torch.exp2(-10.0 * d2)[..., None]
    res = torch.sum(col * wt, dim=0)
    wt_sum = torch.sum(wt, dim=0)
    ex = torch.sum(col * dev_wt, dim=0)
    ex2 = torch.sum(col * col * dev_wt, dim=0)
    dev_wt_sum = torch.sum(dev_wt, dim=0)
    return (res, wt_sum[..., 0],
            ex / torch.clamp(dev_wt_sum, min=1e-20),
            ex2 / torch.clamp(dev_wt_sum, min=1e-20))


def _rows_reached(a: int, b: int, scale: float, n: int, reach: int = 0):
    """The rows [lo, hi) of an n-row plane that a nearest lattice
    floor((Y + 0.5) * scale) reads for the rows [a, b) of another plane,
    widened by `reach` rows each way (a stencil's) and by one more for the
    float32 rounding of the lattice, clipped to the plane."""
    lo = math.floor((a + 0.5) * scale) - reach - 1
    hi = math.floor((b - 0.5) * scale) + reach + 2
    return max(0, lo), min(n, hi)


def _superres_taps(iycc, jitter_px, h, w, out_h, out_w, band=None,
                   out_band=None):
    """The super-res unjitter's inputs, shared by its two kernel scales:
    (col (9, Ho, Wo, 3), fx, fy, sx, sy). col holds the 3x3 taps around
    each output pixel's base source pixel, fetched by one 27-channel nearest
    warp of the pre-shifted frame; (fx, fy) is the offset of that source
    pixel's jittered centre from the output sample, in output pixels. The
    lattices are built on the whole output frame and cut to `out_band`'s
    rows; with bands, the source is the window of render rows the band's
    base pixels reach, one more each way for the taps."""
    dev = iycc.device
    jx, jy = jitter_px[0], jitter_px[1]
    sx, sy = w / out_w, h / out_h  # input resolution fraction (< 1)
    ox_pix = (torch.arange(out_w, dtype=torch.float32, device=dev)
              + 0.5)[None, :]
    oy_pix = (torch.arange(out_h, dtype=torch.float32, device=dev)
              + 0.5)[:, None]
    bx = torch.floor(ox_pix * sx)  # base source pixel
    by = torch.floor(oy_pix * sy)
    # fractional offset of (base source texel + jitter) vs the output
    # sample, in OUTPUT pixel units
    fx = (bx + 0.5 + jx) / sx - ox_pix
    fy = (by + 0.5 + jy) / sy - oy_pix
    base_v = (by + 0.5) / h
    if out_band is not None:
        fy, base_v = out_band.rows_of(fy), out_band.rows_of(base_v)
    rows = fy.shape[0]
    base_uv = torch.stack([((bx + 0.5) / w).expand(rows, out_w),
                           base_v.expand(rows, out_w)], dim=-1)
    if band is None:
        src, row0 = iycc, 0
    else:
        src, row0 = band.window(
            iycc, tuple(_rows_reached(a, b, sy, h, reach=1)
                        for a, b in out_band.rows),
            label="taa super-res source")
    # one 27-channel nearest warp of the 9 pre-shifted taps (on a window,
    # its edge rows clamp wrongly, and the lattice never reads them)
    shifted = im.shift_stack(src, _OFF3).permute(1, 2, 0, 3).reshape(
        src.shape[0], w, 27)
    fetched = (im.warp_nearest(shifted, base_uv) if band is None
               else im.warp_nearest_rows(shifted, row0, h, base_uv))
    col = fetched.reshape(rows, out_w, 9, 3).permute(2, 0, 1, 3)
    return (col, fx.expand(rows, out_w), fy.expand(rows, out_w), sx, sy)


def _to_out(x, h, out_h, out_w, band=None, out_band=None):
    """Nearest resize render res -> output res. With bands, x holds the
    render band's rows and the result the output band's, read from the
    window of render rows they reach."""
    x3 = x if x.ndim == 3 else x[..., None]
    uv = im.pixel_uv(out_h, out_w, device=x.device, band=out_band)
    if band is None:
        return im.warp_nearest(x3, uv)
    win, row0 = band.window(
        x3, tuple(_rows_reached(a, b, h / out_h, h) for a, b in out_band.rows),
        label="taa resize window")
    return im.warp_nearest_rows(win, row0, h, uv)


def _to_render(x, h, w, out_h, out_band=None, band=None):
    """Nearest resize output res -> render res. With bands, x holds the
    output band's rows and the result the render band's."""
    uv = im.pixel_uv(h, w, device=x.device, band=band)
    if band is None:
        return im.warp_nearest(x, uv)
    win, row0 = out_band.window(
        x, tuple(_rows_reached(a, b, out_h / h, out_h) for a, b in band.rows),
        label="taa resize window")
    return im.warp_nearest_rows(win, row0, out_h, uv)


def taa(input_img, state, reproj, depth, jitter_px, out_h: int, out_w: int,
        pre_delta=None, band=None, out_band=None):
    """input_img: (H, W, 3) lit radiance at render res (pre-exposed when the
    pre-exposure split is on); depth: (H, W) reversed-Z depth; jitter_px:
    (2,) this frame's sub-pixel jitter. pre_delta: this frame's pre-exposure
    over last frame's; the history, accumulated at the old pre-exposure, is
    rescaled by it (and the variance accumulator, which lives in
    sqrt-encoded space, by the same factor).
    `band`: the row band of the render-res frame that the render-res planes
    hold; `out_band`: that of the output frame, which the state and the
    result hold (under super-resolution; otherwise it is `band`).
    Returns ((out_h, out_w, 3), new_state)."""
    h, w = input_img.shape[:2] if band is None else (band.height, band.width)
    dev = input_img.device
    same_res = (out_h == h and out_w == w)
    ob = band if same_res else out_band
    if band is not None and ob is None:
        raise ValueError("TAA's super-resolution on a row band needs the "
                         "output band")
    frac_x, frac_y = w / out_w, h / out_h

    def to_out(x):
        return x if same_res else _to_out(x, h, out_h, out_w, band, ob)

    def to_render(x):
        return x if same_res else _to_render(x, h, w, out_h, ob, band)

    # ---- pass 2: filter input (+ deviation) at render res, perceptual YCbCr
    iycc_raw = lin_to_ycbcr(decode_rgb(input_img))
    with pass_scope("filter_input"):
        fi, dev_in = _filter_input(iycc_raw, depth, 0.8, band)

    # ---- closest-velocity dilation at render res
    uv_rr = im.pixel_uv(h, w, device=dev, band=band)
    vel = reproj["prev_uv"] - uv_rr
    with pass_scope("closest_vel"):
        cvel_rr = _closest_velocity(depth, vel, band)

    # the render-res planes the output lattice reads, resized in one fetch
    if same_res:
        cvel_out = cvel_rr
        validity_out, in_bounds_out = reproj["validity"], reproj["in_bounds"]
    else:
        o = to_out(torch.cat([cvel_rr, reproj["validity"][..., None],
                              reproj["in_bounds"][..., None]], dim=-1))
        cvel_out, validity_out, in_bounds_out = o[..., :2], o[..., 2], \
            o[..., 3]

    # ---- pass 1: reproject all temporal planes with one packed 9-channel
    # warp at the dilated closest-velocity lattice
    uv_out = im.pixel_uv(out_h, out_w, device=dev, band=ob)
    prev_uv_out = uv_out + cvel_out
    packed = torch.cat([state["taa_history"],
                        state["taa_coverage"][..., None],
                        state["taa_smooth_var"],
                        state["taa_velocity"]], dim=-1)
    with pass_scope("warp9"):
        fetched = im.warp_bilinear(packed, prev_uv_out, band=ob)
    hist_lin = torch.clamp(fetched[..., 0:3], min=0.0)
    rsvar = torch.clamp(fetched[..., 4:7], min=0.0)
    if pre_delta is not None:
        # history is stored linear: scale by the full delta before the
        # perceptual decode; the variance accumulator scales by delta too
        hist_lin = hist_lin * pre_delta
        rsvar = rsvar * pre_delta
    rhist = decode_rgb(hist_lin)                             # perceptual
    rcov = torch.clamp(fetched[..., 3], min=0.0)
    rvel = fetched[..., 7:9]

    # ---- pass 3: filtered history at render res (the history, variance
    # and velocity resized in one fetch)
    if same_res:
        hist_rr, svar_rr, vhist_rr = rhist, rsvar, rvel
    else:
        r = to_render(torch.cat([rhist, rsvar, rvel], dim=-1))
        hist_rr, svar_rr, vhist_rr = r[..., 0:3], r[..., 3:6], r[..., 6:8]
    with pass_scope("filter_history"):
        fh = _filter_history(lin_to_ycbcr(hist_rr),
                             2 if 1.0 / frac_x > 1.75 else 1, band)

    # ---- passes 4-6: input probability
    with pass_scope("input_prob"):
        prob_rr = _input_prob(fi, dev_in, vel, fh, svar_rr, vhist_rr, band)
    input_prob = prob_rr if same_res else to_out(prob_rr)[..., 0]

    # ---- pass 7: final resolve at output res
    hist_ycc = lin_to_ycbcr(rhist)
    hcov = rcov

    # blurred history: separable gaussian with w = exp(-d^2)
    g = [math.exp(-(d * d)) for d in (-2, -1, 0, 1, 2)]
    gs = sum(g)
    taps = tuple(x / gs for x in g)
    bhist_p = im.separable_blur(
        torch.cat([rhist, rcov[..., None]], dim=-1), taps, ob)
    bhist_ycc = lin_to_ycbcr(bhist_p[..., 0:3])
    bcov = bhist_p[..., 3]

    with pass_scope("unjitter"):
        sr_taps = None if same_res else _superres_taps(
            iycc_raw, jitter_px, h, w, out_h, out_w, band, ob)
        center, coverage, ex, ex2 = _unjitter_sample(
            iycc_raw, jitter_px, h, w, out_h, out_w, 1.0, band, sr_taps)
        bsum, bcover, _, _ = _unjitter_sample(
            iycc_raw, jitter_px, h, w, out_h, out_w, 0.333, band, sr_taps)
    bcenter = bsum / torch.clamp(bcover, min=1e-20)[..., None]

    # low-coverage lanes fall back to the filtered current frame
    hist_ycc = hist_ycc + (bcenter - hist_ycc) * torch.clamp(
        1.0 - hcov, 0.0, 1.0)[..., None]
    bhist_ycc = bhist_ycc + (bcenter - bhist_ycc) * torch.clamp(
        1.0 - bcov, 0.0, 1.0)[..., None]

    var = torch.clamp(ex2 - ex * ex, min=0.0)
    input_dev = torch.sqrt(var)

    # smooth variance update
    prev_var = rsvar[..., 0:1]
    vel_now = cvel_out
    vel_prev = rvel
    vel_diff = _len2((vel_now - vel_prev)
                     / torch.clamp(torch.abs(vel_now + vel_prev), min=1.0))
    var_blend = torch.clamp(0.3 + 0.7 * (1.0 - validity_out) + vel_diff,
                            0.0, 1.0)[..., None]
    # lerp(prev_var, var, var_blend), bounded below by this frame's var
    smooth_var = torch.maximum(var, prev_var + (var - prev_var) * var_blend)
    var_prob_blend = torch.clamp(input_prob, 0.0, 1.0)[..., None]
    smooth_var = var + (smooth_var - var) * var_prob_blend

    # ---- neighbourhood clamp / dual-frequency history reconstruction
    box_n = 0.8 + (3.0 - 0.8) * var_prob_blend
    nmin = ex - input_dev * box_n
    nmax = ex + input_dev * box_n
    clamped_bhistory = torch.minimum(torch.maximum(bhist_ycc, nmin), nmax)

    clamping_event = _len3(
        torch.clamp(torch.maximum(bhist_ycc - nmax, nmin - bhist_ycc),
                    min=0.0)
        / torch.clamp(ex, min=0.01))
    outlier3 = torch.clamp(
        torch.maximum(nmin - hist_ycc, hist_ycc - nmax), min=0.0) / (
        0.1 + torch.clamp(torch.maximum(torch.abs(hist_ycc), torch.abs(ex)),
                          min=1e-5))
    boutlier3 = torch.clamp(
        torch.maximum(nmin - bhist_ycc, bhist_ycc - nmax), min=0.0) / (
        0.1 + torch.clamp(torch.maximum(torch.abs(bhist_ycc), torch.abs(ex)),
                          min=1e-5))
    outlier = torch.amax(outlier3, dim=-1)
    boutlier = torch.amax(boutlier3, dim=-1)

    non_disocc = torch.clamp(outlier - boutlier, min=0.0) * 10.0
    unclamped_detail = hist_ycc - clamped_bhistory
    temporal_clamping_detail = torch.abs(
        unclamped_detail[..., 0]
        / torch.clamp(input_dev[..., 0], min=1e-3)) * 0.05
    temporal_stability = torch.clamp(1.0 - temporal_clamping_detail,
                                     0.0, 1.0)
    allow_unclamped = torch.clamp(non_disocc, 0.0, 1.0) * temporal_stability

    history_detail = hist_ycc - bhist_ycc
    history_detail = history_detail + (
        unclamped_detail - history_detail) * allow_unclamped[..., None]

    dot_num = dot3(clamped_bhistory - bhist_ycc, bcenter - bhist_ycc)
    denom = torch.clamp(_len3(clamped_bhistory - bhist_ycc)
                        * _len3(bcenter - bhist_ycc), min=1e-5)
    initial_bclamp = torch.clamp(dot_num / denom, 0.0, 1.0)
    effective_clamp = initial_bclamp * (1.0 - allow_unclamped)
    keep_detail = 1.0 - effective_clamp
    history_detail = history_detail * keep_detail[..., None]

    clamped_history_v = clamped_bhistory + history_detail
    if frac_x < 1.0:
        # temporal super-res: damp coverage after clamping events so the
        # reduced-res input re-converges quickly
        hcov = hcov * ((0.9 * keep_detail)
                       + (1.0 - 0.9 * keep_detail)
                       * torch.clamp(10.0 * clamping_event, 0.0, 1.0))

    history_valid = in_bounds_out > 0.5
    clamped_history_v = torch.where(history_valid[..., None],
                                    clamped_history_v, clamped_bhistory)
    center = torch.where(history_valid[..., None], center, bcenter)
    coverage = torch.where(history_valid, coverage, 1.0)
    hcov = torch.where(history_valid, hcov, 0.0)

    # confidence-based blend: high input probability keeps unclamped history
    conf = torch.clamp((var_prob_blend[..., 0] - 0.5) / 0.5, 0.0, 1.0)
    conf = conf * conf * (3.0 - 2.0 * conf)  # smoothstep(0.5, 1, prob)
    clamped_history_v = clamped_history_v + (
        hist_ycc - clamped_history_v) * conf[..., None]

    # ---- coverage-weighted accumulation
    total_cov = torch.clamp(hcov + coverage, min=1e-5)
    temporal = ((clamped_history_v * hcov[..., None] + center)
                / total_cov[..., None])
    max_cov = max(2.0, 8.0 / (frac_x * frac_y))  # target sample count 8
    total_cov = torch.clamp(total_cov, max=max_cov)

    out_lin = torch.clamp(encode_rgb(ycbcr_to_lin(temporal)), min=0.0)

    new_state = {
        "taa_history": out_lin,
        "taa_coverage": total_cov,
        "taa_smooth_var": smooth_var,
        "taa_velocity": cvel_out,
    }
    return out_lin, new_state
