"""Post-processing: histogram exposure, glare pyramid, display transform,
Bezold-Bruecke shift, CAS (port of `kajiya_tpu/renderers/post.py`).

With a row `band` (parallel/), the histogram's counts are summed over the
ranks (all-reduce: integers below 2^24, exact in float32), the glare
pyramid's fine levels stay banded while every band halves onto its own rows
and its coarse levels are gathered whole, and the stencils fetch their halo
rows."""
from __future__ import annotations

import math

import numpy as _np
import torch

from ..core import img as im
from ..core.color import luminance, srgb_encode
from ..ops.smallvec import matvec

HIST_BINS = 256
EV_MIN, EV_MAX = -16.0, 16.0


def luminance_histogram(rgb, band=None):
    """(HIST_BINS,) normalized log2-luminance histogram, metered on an
    8x8-decimated image; cumulative counts via bin-edge comparisons."""
    small = im.decimate2(im.decimate2(im.decimate2(rgb)))
    lum = torch.clamp(luminance(small), min=1e-8)
    ev = torch.clamp(torch.log2(lum), EV_MIN, EV_MAX).reshape(-1)
    scale = (HIST_BINS - 1) / (EV_MAX - EV_MIN)
    q = (ev - EV_MIN) * scale
    edges = torch.arange(1, HIST_BINS + 1, dtype=torch.float32,
                         device=rgb.device)
    cum = (q[None, :] < edges[:, None]).sum(dim=1).to(torch.float32)
    if band is not None:
        cum = band.all_reduce(cum, label="exposure histogram")
    hist = torch.diff(cum, prepend=cum.new_zeros(1))
    return hist / torch.clamp(hist.sum(), min=1.0)


def exposure_from_histogram(hist, low_frac=0.6, high_frac=0.95,
                            ev_shift: float = 0.0):
    """Mean EV of the [low, high] percentile band -> target exposure EV."""
    cdf = torch.cumsum(hist, dim=0)
    cdf_lo = torch.cat([hist.new_zeros(1), cdf[:-1]])
    centers = torch.linspace(EV_MIN, EV_MAX, HIST_BINS, device=hist.device)
    overlap = torch.clamp(torch.clamp(cdf, max=high_frac)
                          - torch.clamp(cdf_lo, min=low_frac), min=0.0)
    w = torch.clamp(overlap.sum(), min=1e-6)
    mean_ev = (overlap * centers).sum() / w
    return -mean_ev + ev_shift


def init_exposure_state(device=None):
    return {"smoothed_ev": torch.zeros((), dtype=torch.float32, device=device),
            "pre_mult": torch.ones((), dtype=torch.float32, device=device)}


def update_exposure(state, lit, dt: float = 1.0 / 60.0, speed: float = 2.5,
                    ev_shift: float = 0.0, band=None):
    """Smoothed dynamic exposure. Returns (exposure_multiplier, new_state)."""
    target = exposure_from_histogram(luminance_histogram(lit, band),
                                     ev_shift=ev_shift)
    t = float(_np.float32(1.0) - _np.exp(_np.float32(-speed * dt)))
    ev = state["smoothed_ev"] + (target - state["smoothed_ev"]) * t
    return torch.exp2(ev), {"smoothed_ev": ev}


def glare_pyramid(lit, levels: int = 6, band=None):
    """Downsample chain with a gaussian prefilter, then reverse accumulate;
    in bfloat16 like the JAX module."""
    if band is not None:
        return _glare_pyramid_banded(lit, levels, band)
    x = lit.to(torch.bfloat16)
    mips = [x]
    for _ in range(levels):
        if min(x.shape[0], x.shape[1]) < 4:
            break
        x = im.downsample_2x(_blur3(x))
        mips.append(x)
    acc = mips[-1]
    # the blend weights are rounded to bfloat16 first, as JAX rounds a
    # Python scalar to the array's dtype
    w6, w4 = (torch.tensor(c, dtype=torch.bfloat16, device=lit.device)
              for c in (0.6, 0.4))
    for m in reversed(mips[:-1]):
        acc = _blur3(im.upsample_bilinear(acc, m.shape[0], m.shape[1])
                     .to(torch.bfloat16)) * w6 + m * w4
    return acc.to(torch.float32)


def _glare_pyramid_banded(lit, levels: int, band):
    """`glare_pyramid` of a row band: a level stays banded while every
    band's 2x reduce is that band of the next level (`Band.halvable`);
    below that the level is gathered whole and the rest of the chain runs
    on every rank. On the way up a banded accumulator is upsampled on its
    band where the step is an exact 2x, otherwise gathered."""
    x, xb = lit.to(torch.bfloat16), band
    h, w = band.height, band.width
    mips = [(x, xb, h, w)]
    for _ in range(levels):
        if min(h, w) < 4:
            break
        if xb is not None and not xb.halvable():
            x, xb = xb.gather(x, label="glare level"), None
        x = im.downsample_2x(_blur3(x, xb))
        xb = None if xb is None else xb.half()
        h, w = h // 2, w // 2
        mips.append((x, xb, h, w))
    acc, acc_b, ah, aw = mips[-1]
    w6, w4 = (torch.tensor(c, dtype=torch.bfloat16, device=lit.device)
              for c in (0.6, 0.4))
    for m, mb, mh, mw in reversed(mips[:-1]):
        if acc_b is not None and mh == 2 * ah and mw == 2 * aw:
            up = im.upsample2x_bilinear(acc, acc_b)
        else:
            whole = acc if acc_b is None else acc_b.gather(
                acc, label="glare level")
            up = im.upsample_bilinear(whole, mh, mw)
            if mb is not None:
                up = mb.rows_of(up)
        acc = _blur3(up.to(torch.bfloat16), mb) * w6 + m * w4
        acc_b, ah, aw = mb, mh, mw
    return acc.to(torch.float32)


def _blur3(img, band=None):
    return im.separable_blur(img, (0.25, 0.5, 0.25), band)


_OKLAB_M1 = _np.array([[0.4122214708, 0.5363325363, 0.0514459929],
                       [0.2119034982, 0.6806995451, 0.1073969566],
                       [0.0883024619, 0.2817188376, 0.6299787005]])
_OKLAB_M2 = _np.array([[0.2104542553, 0.7936177850, -0.0040720468],
                       [1.9779984951, -2.4285922050, 0.4505937099],
                       [0.0259040371, 0.7827717662, -0.8086757660]])
# the JAX module holds these as float32 arrays and inverts the float32 ones
_OKLAB_M1_INV = _np.linalg.inv(_OKLAB_M1.astype(_np.float32))
_OKLAB_M2_INV = _np.linalg.inv(_OKLAB_M2.astype(_np.float32))


def _mat(m, ref):
    return torch.as_tensor(_np.asarray(m, _np.float32), device=ref.device)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _srgb_to_oklab(rgb):
    lms = _cbrt(matvec(_mat(_OKLAB_M1, rgb), torch.clamp(rgb, min=0.0)))
    return matvec(_mat(_OKLAB_M2, rgb), lms)


def _oklab_to_srgb(lab):
    lms = matvec(_mat(_OKLAB_M2_INV, lab), lab) ** 3
    return matvec(_mat(_OKLAB_M1_INV, lab), lms)


def tonemap_filmic(x):
    """Display transform (notorious6 structure): Siragusano/Smith
    tonescale on luminance, chromaticity-preserving scale, Oklab path to
    white, per-channel p=12 soft roll-off."""
    eps = 1e-8
    lum = torch.clamp(luminance(x), min=0.0)
    peak = torch.clamp(x.amax(dim=-1), min=eps)
    max_rgb = torch.clamp(x, min=0.0) / peak[..., None]
    max_lum = torch.clamp(luminance(max_rgb), min=eps)
    compressed = torch.clamp(1.0205 * (lum / (lum + 1.0)) ** 1.2, 0.0, 1.0)
    out = max_rgb * (compressed / max_lum)[..., None]
    white = torch.clamp(compressed, max=1.0)
    sat = max_rgb.amax(dim=-1) - max_rgb.amin(dim=-1)
    expo = 4.0 - sat * 0.4 * (4.0 - 3.0)
    t = torch.clamp(compressed / 1.03, 0.0, 1.0)
    atten = t ** expo
    lab = _srgb_to_oklab(out)
    lab_w = _srgb_to_oklab(white[..., None].expand(white.shape + (3,)))
    out = _oklab_to_srgb(lab + (lab_w - lab) * atten[..., None])
    out = torch.clamp(out, min=0.0)
    p = 12.0
    out = out * (out ** p + 1.0) ** (-1.0 / p)
    max_c = out.amax(dim=-1)
    max_dist = max_c - out.amin(dim=-1)
    out = out / ((0.5 + 0.5 * max_dist) ** (1.0 / p))[..., None]
    return torch.clamp(out, 0.0, 1.0)


def cas_sharpen(img, amount: float = 0.4, band=None):
    """Contrast-adaptive sharpening on the tonemapped image."""
    taps = im.shift_stack(img, [(-1, 0), (1, 0), (0, -1), (0, 1)], band)
    mn, mx = img, img
    for k in range(4):
        mn = torch.minimum(mn, taps[k])
        mx = torch.maximum(mx, taps[k])
    a = torch.sqrt(torch.clamp(torch.minimum(mn, 1.0 - mx)
                               / torch.clamp(mx, min=1e-4), 0.0, 1.0))
    w = -a * (amount * 0.2)
    cross = ((taps[0] + taps[1]) + taps[2]) + taps[3]
    out = (img + cross * w) / torch.clamp(1.0 + 4.0 * w, min=1e-4)
    return torch.clamp(out, 0.0, 1.0)


# Pridmore (1999) Bezold-Bruecke wavelength-shift data, Fourier-fit once
_PRIDMORE_T_NM = _np.array([
    [0.0, 0.0], [0.084, -5.0], [0.152, -5.0], [0.2055, -4.0], [0.25, 0.0],
    [0.265, 2.3], [0.291, 5.0], [0.31, 6.0], [0.3285, 6.5], [0.356, 5.4],
    [0.395, 4.4], [0.4445, 3.93], [0.551, -4.9], [0.585, -6.0],
    [0.6065, -6.0], [0.6133, -3.0], [0.621, 1.42], [0.6245, 1.9],
    [0.633, 2.55], [0.92495, 2.55], [0.92525, 3.35], [0.9267, 4.8],
    [0.93, 6.15], [0.934, 7.0], [0.942, 5.95], [0.956, 4.0]])


def _fit_bb_fourier(n_harm: int = 10, n_pts: int = 512):
    ts = _np.linspace(0.0, 1.0, n_pts, endpoint=False)
    xp = _np.concatenate([_PRIDMORE_T_NM[:, 0], [_PRIDMORE_T_NM[0, 0] + 1.0]])
    fp = _np.concatenate([_PRIDMORE_T_NM[:, 1], [_PRIDMORE_T_NM[0, 1]]])
    vals = _np.interp(ts, xp, fp)
    cols = [_np.ones_like(ts)]
    for k in range(1, n_harm + 1):
        cols.append(_np.cos(2 * _np.pi * k * ts))
        cols.append(_np.sin(2 * _np.pi * k * ts))
    coef, *_ = _np.linalg.lstsq(_np.stack(cols, -1), vals, rcond=None)
    return coef.astype(_np.float32), n_harm


_BB_COEF, _BB_HARM = _fit_bb_fourier()
_RGB2XYZ = _np.array([[0.4124564, 0.3575761, 0.1804375],
                      [0.2126729, 0.7151522, 0.0721750],
                      [0.0193339, 0.1191920, 0.9503041]])
_XYZ2RGB = _np.linalg.inv(_RGB2XYZ)
_D65_XY = (0.31272, 0.32903)
_BB_RAD_PER_NM = 0.02


def bezold_brucke_shift(rgb, amount):
    """Bezold-Bruecke hue shift: rotate the chromaticity offset from D65 by
    the Fourier-evaluated wavelength shift scaled to hue angle."""
    xyz = matvec(_mat(_RGB2XYZ, rgb), torch.clamp(rgb, min=0.0))
    s = torch.clamp(xyz.sum(-1), min=1e-8)
    x = xyz[..., 0] / s
    y = xyz[..., 1] / s
    ox = x - _D65_XY[0]
    oy = y - _D65_XY[1]
    theta = torch.atan2(oy, ox)
    t = torch.remainder((-theta / math.pi) * 0.5 + 0.61, 1.0)
    coef = torch.as_tensor(_BB_COEF, device=rgb.device)
    ks = torch.arange(1, _BB_HARM + 1, dtype=torch.float32, device=rgb.device)
    ang = 2 * math.pi * t[..., None] * ks
    nm = coef[0] + torch.sum(coef[1::2] * torch.cos(ang)
                             + coef[2::2] * torch.sin(ang), dim=-1)
    delta = nm * _BB_RAD_PER_NM * amount
    c, sn = torch.cos(delta), torch.sin(delta)
    nx = _D65_XY[0] + ox * c - oy * sn
    ny = _D65_XY[1] + ox * sn + oy * c
    ny_safe = torch.clamp(ny, min=1e-6)
    big_y = xyz[..., 1]
    out = torch.stack([nx * big_y / ny_safe, big_y,
                       (1.0 - nx - ny) * big_y / ny_safe], dim=-1)
    return torch.clamp(matvec(_mat(_XYZ2RGB, rgb), out), min=0.0)


def post_combine(lit, exposure_mult, glare_amount: float = 0.07,
                 contrast: float = 1.03, glare=None, band=None):
    """Glare blend, exposure, B-B shift, tone map, contrast, CAS, sRGB.
    Returns display-ready (H, W, 3) in [0,1]. `glare`: a precomputed glare
    plane (default: `glare_pyramid(lit)`)."""
    if glare is None:
        glare = glare_pyramid(lit, band=band)
    x = lit * (1.0 - glare_amount) + glare * glare_amount
    x = x * exposure_mult
    lum = luminance(x)
    x = bezold_brucke_shift(x, lum / (lum + 5.0))
    t = tonemap_filmic(x)
    t = torch.clamp(0.18 * torch.pow(torch.clamp(t, min=1e-6) / 0.18,
                                     contrast), 0.0, 1.0)
    return srgb_encode(cas_sharpen(t, band=band))
