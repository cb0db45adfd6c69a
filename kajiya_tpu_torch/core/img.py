"""Image-space utilities shared by the screen-space passes (port of
`kajiya_tpu/core/img.py`).

Convention: images are (H, W) or (H, W, C); uv has its origin at the top-left
with v pointing down. The JAX module writes resampling as one-hot matmuls to
avoid TPU gathers; on the GPU they are plain strided slices and index
selects, with the same summation order so float results agree.
`warp_bilinear` / `warp_nearest` dispatch to the warp kernel
(ops/warp_cuda.py) for CUDA tensors.

Row bands (parallel/): the stencil helpers and the pixel lattice take an
optional `band` (parallel/comm.py `Band`, at the image's resolution), the
image then being that band's rows of the frame's plane. A stencil fetches
the neighbouring bands' rows it reads (`Band.halo`), runs on that window
and keeps the band's rows: at the frame's edges the window ends where the
frame does, so the clamp is the whole frame's. A warp at arbitrary uv
all-gathers its source. `band=None` is the whole frame, as before.
"""
from __future__ import annotations

import torch

from ..device import const_tensor


def _gather2d(img, iy, ix, height=None, row0: int = 0):
    """img[(iy, ix)] with integer indices clamped to a plane of `height`
    rows (default img's), of which img holds rows [row0, row0 + len)."""
    n, w = img.shape[0], img.shape[1]
    h = n if height is None else height
    iy = iy.clamp(0, h - 1)
    if row0:
        iy = iy - row0
    idx = iy * w + ix.clamp(0, w - 1)
    return img.reshape((n * w,) + tuple(img.shape[2:]))[idx]


def sample_nearest(img, uv):
    """Nearest sample at uv in [0,1)^2. uv: (..., 2) -> (..., C)."""
    h, w = img.shape[0], img.shape[1]
    ix = torch.floor(uv[..., 0] * w).to(torch.int64)
    iy = torch.floor(uv[..., 1] * h).to(torch.int64)
    return _gather2d(img, iy, ix)


def sample_bilinear(img, uv, height=None, row0: int = 0):
    """Bilinear sample at uv with clamp-to-edge addressing per tap. With
    `height`, img is rows [row0, row0 + len) of a plane of that many rows
    (a halo window): the coordinates and the clamp are the plane's, so the
    taps are the whole plane's bit for bit (every row they reach must lie in
    the window)."""
    h = img.shape[0] if height is None else height
    w = img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    c00 = _gather2d(img, y0i, x0i, h, row0)
    c10 = _gather2d(img, y0i, x0i + 1, h, row0)
    c01 = _gather2d(img, y0i + 1, x0i, h, row0)
    c11 = _gather2d(img, y0i + 1, x0i + 1, h, row0)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def bilinear_weights_and_indices(img_hw, uv):
    """The four taps and weights of a bilinear footprint (for filters with
    weights of their own). Returns (iy, ix, w), each (..., 4); the indices
    are int32 and not clamped."""
    h, w = img_hw
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    iy = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=-1)
    ix = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=-1)
    ww = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                      fx * fy], dim=-1)
    return iy, ix, ww


def pixel_uv(h: int, w: int, device=None, band=None):
    """(H, W, 2) pixel-center uv lattice of an (h, w) image; with `band`,
    its rows [band.y0, band.y1)."""
    y0, n = (0, h) if band is None else (band.y0, band.n)
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    v = (torch.arange(y0, y0 + n, dtype=torch.float32, device=device)
         + 0.5) / h
    return torch.stack([u[None, :].expand(n, w), v[:, None].expand(n, w)],
                       dim=-1)


def warp_bilinear(img, uv, band=None):
    """Bilinear sample for local warps (reprojection / temporal fetches):
    the warp kernel on CUDA, `sample_bilinear` on the CPU. With `band`, img
    is the band of the source plane: the whole source is gathered first."""
    from ..ops.warp_cuda import warp2d

    if band is not None:
        img = band.gather(img, label="warp source")
    return warp2d(img, uv, bilinear=True)


def warp_nearest(img, uv, window_rows=None, band=None):
    """Nearest-sample twin of `warp_bilinear`. `window_rows` (the height of
    the TPU kernel's source window) is accepted and has no meaning here."""
    from ..ops.warp_cuda import warp2d

    if band is not None:
        img = band.gather(img, label="warp source")
    return warp2d(img, uv, bilinear=False)


def warp_nearest_rows(win, row0: int, height: int, uv):
    """`warp_nearest` of a plane of `height` rows at uv, of which `win`
    holds rows [row0, row0 + len) (a `Band.window`): each sample's row is
    taken on the plane's lattice (floor(v * height), clamped to the plane,
    as the kernel and the plain sampler take it) and moved into the window,
    where a v at the row's centre picks it again, so the fetch copies the
    whole plane's elements bit for bit (every row uv reaches must lie in the
    window)."""
    iy = torch.clamp(torch.floor(uv[..., 1] * height), 0, height - 1)
    v = ((iy - row0) + 0.5) / win.shape[0]
    return warp_nearest(win, torch.stack([uv[..., 0], v], dim=-1))


def _avg_axis(x, axis: int):
    """0.5 * (x[2i] + x[2i+1]) along axis 0 or 1 (even extent), summed in
    float32 and rounded to x's dtype once: the two-hot averaging matmul of
    the JAX module."""
    if axis == 0:
        ev, od = x[0::2], x[1::2]
    else:
        ev, od = x[:, 0::2], x[:, 1::2]
    return ((ev.float() + od.float()) * 0.5).to(x.dtype)


def downsample_2x(img):
    """2x2 box reduce. Same stage order as the JAX matmul form: (H, W) images
    reduce columns first, (H, W, C) images rows first."""
    x = img[:img.shape[0] // 2 * 2, :img.shape[1] // 2 * 2]
    if x.ndim == 2:
        return _avg_axis(_avg_axis(x, 1), 0)
    return _avg_axis(_avg_axis(x, 0), 1)


def decimate2(img):
    """img[::2, ::2] (even extent)."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    return img[:h:2, :w:2]


def downsample_nearest(img):
    return decimate2(img)


def phase_extract(img, py: int, px: int):
    """img[py::2, px::2] (even extent)."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    return img[py:h:2, px:w:2]


def downsample_min(img):
    """2x2 min reduce: the elementwise min of the four phase planes."""
    a, b = phase_extract(img, 0, 0), phase_extract(img, 0, 1)
    c, d = phase_extract(img, 1, 0), phase_extract(img, 1, 1)
    return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))


def phase_split(x):
    """(H, W[, C]) -> nested [[p00, p01], [p10, p11]] half-res phase planes
    (p[py][px][i, j] = x[2i+py, 2j+px])."""
    return [[phase_extract(x, py, px) for px in (0, 1)] for py in (0, 1)]


def weave2x2(ph):
    """Inverse of phase_split: out[2i+py, 2j+px] = ph[py][px][i, j]."""
    p00 = ph[0][0]
    hh, hw = p00.shape[0], p00.shape[1]
    out = p00.new_empty((2 * hh, 2 * hw) + tuple(p00.shape[2:]))
    for py in (0, 1):
        for px in (0, 1):
            out[py::2, px::2] = ph[py][px]
    return out


def upsample_bilinear(img, out_h: int, out_w: int, band=None,
                      out_band=None):
    """Bilinear resize with clamped hat-function weights, as separable
    products; exact 2x takes `upsample2x_bilinear`. With `band` (img's) and
    `out_band` (the result's, at out_h x out_w), img is a row band of the
    source: the source is gathered (the resizes of the frame read small
    planes) and the resize of the whole is cut to `out_band`'s rows. A
    matmul's rounding may depend on its shape, so the band's rows come from
    the same products as the whole frame's."""
    if band is not None:
        return out_band.rows_of(upsample_bilinear(
            band.gather(img, label="resize source"), out_h, out_w))
    h, w = img.shape[0], img.shape[1]
    if out_h == h * 2 and out_w == w * 2:
        return upsample2x_bilinear(img)
    dev = img.device

    def weights(n_out, n_in):
        pos = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
               * (n_in / n_out) - 0.5).clamp(0.0, n_in - 1.0)
        cols = torch.arange(n_in, dtype=torch.float32, device=dev)
        return torch.clamp(1.0 - torch.abs(cols[None, :] - pos[:, None]),
                           min=0.0)

    wy = weights(out_h, h)
    wx = weights(out_w, w)
    squeeze = img.ndim == 2
    x = (img[..., None] if squeeze else img).float()
    t = torch.tensordot(wy, x, dims=([1], [0]))          # (H2, W, C)
    out = torch.tensordot(wx, t, dims=([1], [1]))        # (W2, H2, C)
    out = out.permute(1, 0, 2)
    return out[..., 0] if squeeze else out


def shift_stack(img, offsets, band=None):
    """All static shifts of `img`, edge-clamped, stacked: (N, H, W[, C]).
    Tap k is out[k][i, j] = img[clamp(i + dy), clamp(j + dx)]. With `band`,
    the rows clamp at the frame's edges (halo rows fetched)."""
    if band is not None:
        top = max(0, -min(dy for dy, _ in offsets))
        bottom = max(0, max(dy for dy, _ in offsets))
        win, above = band.halo(img, top, bottom)
        return shift_stack(win, offsets)[:, above:above + img.shape[0]]
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    taps = []
    for dy, dx in offsets:
        t = img.index_select(0, (ys + dy).clamp(0, h - 1))
        taps.append(t.index_select(1, (xs + dx).clamp(0, w - 1)))
    return torch.stack(taps, dim=0)


def shift2d(img, dy: int, dx: int):
    """Shift with edge clamp (static offsets)."""
    return shift_stack(img, [(dy, dx)])[0]


def separable_blur(img, taps, band=None):
    """Separable odd-length blur with static weights."""
    r = len(taps) // 2
    wt = const_tensor(tuple(taps), img.device, img.dtype).reshape(
        (-1,) + (1,) * img.ndim)
    sx = shift_stack(img, [(0, i - r) for i in range(len(taps))])
    acc = torch.sum(sx * wt, dim=0)
    sy = shift_stack(acc, [(i - r, 0) for i in range(len(taps))], band)
    return torch.sum(sy * wt, dim=0)


GAUSS5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def interleave_rows(a, b):
    """out[2i] = a[i], out[2i+1] = b[i]."""
    return torch.stack([a, b], dim=1).reshape(
        (2 * a.shape[0],) + tuple(a.shape[1:]))


def interleave_cols(a, b):
    return torch.stack([a, b], dim=2).reshape(
        (a.shape[0], 2 * a.shape[1]) + tuple(a.shape[2:]))


def upsample2x_bilinear(img, band=None):
    """Exact 2x bilinear upsample: per-axis phase blend + interleave. With
    `band` (img's), the result is the band's rows of the upsampled plane."""
    a = shift_stack(img, [(-1, 0), (0, 0), (1, 0)], band)
    r = interleave_rows(0.25 * a[0] + 0.75 * a[1], 0.75 * a[1] + 0.25 * a[2])
    b = shift_stack(r, [(0, -1), (0, 0), (0, 1)])
    return interleave_cols(0.25 * b[0] + 0.75 * b[1],
                           0.75 * b[1] + 0.25 * b[2])


def sample_const_offset(img, dx_px, dy_px):
    """Bilinear sample of the whole image at one constant pixel offset in
    [-1, 1] (a number or a 0-d tensor): 3x3 edge-clamped shifts blended
    with offset-derived weights."""
    dx = torch.as_tensor(dx_px, dtype=torch.float32, device=img.device)
    dy = torch.as_tensor(dy_px, dtype=torch.float32, device=img.device)
    fx = dx - torch.floor(dx)
    fy = dy - torch.floor(dy)
    neg_x = torch.floor(dx) < 0
    neg_y = torch.floor(dy) < 0

    def axis_blend(m1, z, p1, f, neg):
        lo = torch.where(neg, m1, z)
        hi = torch.where(neg, z, p1)
        return lo * (1 - f) + hi * f

    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    row = axis_blend(shift2d(img, 0, -1), img, shift2d(img, 0, 1), fx, neg_x)
    return axis_blend(shift2d(row, -1, 0), row, shift2d(row, 1, 0), fy,
                      neg_y)


def half_to_full_taps(half):
    """The four half-res taps of every full-res pixel's bilinear footprint
    (x_h = X/2 - 0.25), as full-res images interleaved from static shifts:
    the shift form of `bilinear_weights_and_indices` for an exact 2x
    upsample. Returns (taps, weights): four (2h, 2w[, C]) tap images and
    four (2h, 2w) weight images."""
    hh, hw = half.shape[0], half.shape[1]

    def tap(ky, kx):
        r = interleave_rows(*(shift2d(half, ky - 1 + py, 0) for py in (0, 1)))
        return interleave_cols(*(shift2d(r, 0, kx - 1 + px) for px in (0, 1)))

    taps = [tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)]
    w2 = torch.tensor([0.25, 0.75], dtype=torch.float32, device=half.device)
    wy0, wx0 = w2.repeat(hh), w2.repeat(hw)
    wy = [wy0[:, None], (1.0 - wy0)[:, None]]
    wx = [wx0[None, :], (1.0 - wx0)[None, :]]
    weights = [(a * b).expand(2 * hh, 2 * hw)
               for a, b in ((wy[0], wx[0]), (wy[0], wx[1]), (wy[1], wx[0]),
                            (wy[1], wx[1]))]
    return taps, weights


OFF3X3 = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def local_moments_3x3(img, band=None):
    """Per-pixel mean and variance over the 3x3 neighborhood."""
    s = shift_stack(img, OFF3X3, band)
    m1 = s.mean(dim=0)
    m2 = (s * s).mean(dim=0)
    return m1, torch.clamp(m2 - m1 * m1, min=0.0)


def minmax_3x3(img, band=None):
    s = shift_stack(img, OFF3X3, band)
    return s.amin(dim=0), s.amax(dim=0)
