"""Texture pages: decoded, mip-mapped material textures as dense tensors
(port of `kajiya_tpu/scene/textures.py`).

The bake runs on the host, as in the JAX package: each image is decoded to
RGBA8, resized to a square size bucket (128 ... 2048) with a
Lanczos filter, shelf-packed into square pages (slot 0 a white page), box
mip-mapped and laid out as one (N, S, S + S/2, 4) uint8 atlas (mip 0 at
x < S, mip m >= 1 in the right column at x = S, y = S - 2 (S >> m)), with a
(P, 4) int32 `page_sub` table of [page, size, ox, oy] per slot. The atlas is
then uploaded once. The JAX package decodes and resizes with PIL; the port
has its own decoders, each giving PIL's `convert("RGBA")` bytes (PNG in
`png.py`, JPEG in `jpeg.py`, DDS in `dds.py`, BMP and DIB in `bmp.py`,
ICO and CUR in `ico.py`, TGA in `tga.py`, GIF in `gif.py`, WebP in
`webp.py`, TIFF in `tiff.py`, PCX and DCX in `pcx.py`, the PPM family in
`ppm.py`, SGI in `sgi.py`, QOI in `qoi.py`, PSD in `psd.py`, BLP in
`blp.py`, FTEX in `ftex.py`, ICNS in `icns.py`, GBR in `gbr.py`, IPTC in
`iptc.py`, XBM in `xbm.py`, XPM in `xpm.py`, SUN in `sun.py`, MSP in
`msp.py`, XV thumbnails in `xvthumb.py`, IMT in `imt.py`, PIXAR in
`pixar.py`; LAB images through `lab.py`), and a Lanczos resize that gives
PIL's `Image.resize(..., LANCZOS)` bytes, so the atlases are equal byte for
byte.

Decoding dispatches on the content, not on the file name, in PIL's plugin
order (`identify.py`): a plugin whose `_open` refuses the bytes passes
them to the next that accepts them, as `Image.open` does (a TGA file that
CUR's rule also accepts is read as a TGA). Where that walk reaches a
format the port does not decode yet (JPEG 2000, AVIF and the rest of
`identify.FORMATS`), it raises NotImplementedError naming it: a
missing decoder never passes as a white texture. Bytes that no PIL plugin
opens, a missing file, and a source that PIL also refuses (corrupt or
truncated data, a layout PIL has no decoder for) become a 4x4 white image,
as in the JAX package.

`sample_pages` is the per-hit fetch: wrap addressing, bilinear or nearest,
a static or per-ray mip (ray-cone LOD: lod_base + log2(size)), sRGB decode
per slot. It is plain PyTorch gathers, as JAX computes it outside any
kernel.
"""
from __future__ import annotations

import base64

import numpy as np
import torch

from ..device import resolve_device
from .blp import decode_blp
from .bmp import decode_bmp, decode_dib
from .dds import decode_dds
from .ftex import decode_ftex
from .gbr import decode_gbr
from .gif import decode_gif
from .icns import decode_icns
from .ico import decode_cur, decode_ico
from .identify import Refused, candidates
from .imt import decode_imt
from .iptc import decode_iptc
from .jpeg import decode_jpeg
from .msp import decode_msp
from .pcx import decode_dcx, decode_pcx
from .pixar import decode_pixar
from .png import decode_png
from .ppm import decode_ppm
from .psd import decode_psd
from .qoi import decode_qoi
from .sgi import decode_sgi
from .sun import decode_sun
from .tga import decode_tga
from .tiff import decode_tiff
from .webp import decode_webp
from .xbm import decode_xbm
from .xpm import decode_xpm
from .xvthumb import decode_xvthumb

PAGE_SIZE = 512     # minimum page size; grows to the largest used bucket
N_MIPS = 6          # 512 -> 16; scales with the page (mip floor stays 16)
BUCKETS = (2048, 1024, 512, 256, 128)

# the formats the port decodes, by identify's name; a decoder raises
# `identify.Refused` where PIL's plugin `_open` refuses the bytes
_DECODERS = {"PNG": decode_png, "JPEG": decode_jpeg, "DDS": decode_dds,
             "BMP": decode_bmp, "DIB": decode_dib, "CUR": decode_cur,
             "ICO": decode_ico, "TGA": decode_tga, "GIF": decode_gif,
             "WEBP": decode_webp, "TIFF": decode_tiff, "PCX": decode_pcx,
             "DCX": decode_dcx, "PPM": decode_ppm, "SGI": decode_sgi,
             "QOI": decode_qoi, "PSD": decode_psd, "BLP": decode_blp,
             "FTEX": decode_ftex, "ICNS": decode_icns, "GBR": decode_gbr,
             "IPTC": decode_iptc, "XBM": decode_xbm, "XPM": decode_xpm,
             "SUN": decode_sun, "MSP": decode_msp, "XVTHUMB": decode_xvthumb,
             "IMT": decode_imt, "PIXAR": decode_pixar}
# the decoders whose outcome depends on whether PIL reads a file or bytes
# in memory (PCX seeks back from the end: a real file cannot seek before
# its start, an in-memory one stops there)
_FROM_FILE = ("PCX", "DCX")


def _read_source(path_or_data: str) -> bytes:
    if path_or_data.startswith("data:"):
        _header, b64 = path_or_data.split(",", 1)
        return base64.b64decode(b64)
    with open(path_or_data, "rb") as f:
        return f.read()


def _decode_image(path_or_data: str) -> np.ndarray:
    """A file path or data URI -> (H, W, 4) uint8, raw values (no colour
    space conversion). The plugins that accept the bytes are tried in PIL's
    order, each refusal passing to the next, as `Image.open` does. Raises
    NotImplementedError when that walk reaches a format the port cannot
    decode yet, OSError / ValueError for a missing source, bytes no plugin
    opens, or a source PIL also refuses."""
    data = _read_source(path_or_data)
    found = candidates(data)
    for i, fmt in enumerate(found):
        if fmt not in _DECODERS:
            raise NotImplementedError(
                f"{' or '.join(found[i:])} texture decoding is not ported "
                f"(ROADMAP.md section 1): {path_or_data[:80]}")
        try:
            if fmt in _FROM_FILE:
                return _DECODERS[fmt](
                    data, from_file=not path_or_data.startswith("data:"))
            return _DECODERS[fmt](data)
        except Refused:
            continue
    raise ValueError(f"cannot identify image file: {path_or_data[:80]}")


# ----------------------------------------------------------------------------
# Lanczos resize, as PIL's Image.resize(size, Image.LANCZOS)
# ----------------------------------------------------------------------------

_PRECISION_BITS = 22


def _lanczos(x):
    """sinc(x) sinc(x / 3) on [-3, 3), 0 elsewhere (float64)."""
    def sinc(t):
        pt = np.pi * t
        return np.where(t == 0.0, 1.0, np.sin(pt) / np.where(t == 0.0, 1.0,
                                                             pt))

    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _coeffs(in_size: int, out_size: int):
    """(xmin (out,), taps (out, k) int64 fixed-point weights) of one axis:
    PIL's precompute_coeffs + normalize_coeffs_8bpc."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 3.0 * fs
    ksize = int(np.ceil(support)) * 2 + 1
    out = np.arange(out_size, dtype=np.float64)
    center = (out + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    n = xmax - xmin
    k = np.arange(ksize)
    live = k[None, :] < n[:, None]
    w = np.where(live, _lanczos((k[None, :] + xmin[:, None] - center[:, None]
                                 + 0.5) * (1.0 / fs)), 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):          # PIL sums the taps in order
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0,
                                                     total)[:, None], w)
    one = float(1 << _PRECISION_BITS)
    q = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, q.astype(np.int64) * live


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (0 rows, 1 columns) of a uint8 (H, W, C)
    image: fixed-point taps summed in int32 from 2^21, clipped to 0..255."""
    xmin, taps = _coeffs(img.shape[axis], out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    last = img.shape[axis] - 1
    acc = np.int32(1 << (_PRECISION_BITS - 1))
    for j in range(taps.shape[1]):
        src = np.take(img, np.minimum(xmin + j, last), axis=axis)
        acc = acc + src.astype(np.int32) * taps[:, j].astype(
            np.int32).reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> PIL's RGBa: c a / 255 rounded as MULDIV255."""
    a = img[..., 3:4].astype(np.int32)
    t = img[..., :3].astype(np.int32) * a + 128
    rgb = ((t >> 8) + t) >> 8
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA: 255 c / a, clipped; alpha 0 and 255 copy c."""
    a = img[..., 3:4].astype(np.int32)
    c = img[..., :3].astype(np.int32)
    div = np.clip(255 * c // np.maximum(a, 1), 0, 255)
    rgb = np.where((a == 0) | (a == 255), c, div)
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C), as PIL's
    `Image.fromarray(img).resize((size, size), Image.LANCZOS)`: a copy at
    the same size; RGBA resized premultiplied (PIL's RGBa round trip);
    horizontal pass first through a uint8 image, each pass only where the
    size changes."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.copy()
    rgba = img.shape[2] == 4
    x = _premultiply(img) if rgba else img
    if w != size:
        x = _resample_axis(x, size, 1)
    if h != size:
        x = _resample_axis(x, size, 0)
    return _unpremultiply(x) if rgba else x


def _bucket_for(h: int, w: int) -> int:
    m = max(h, w)
    for b in BUCKETS[::-1]:
        if m <= b:
            return b
    return BUCKETS[0]


def bake_texture_pages(image_sources, page_size: int | None = None,
                       n_mips: int | None = None):
    """Decode + bucket-resize + shelf-pack + mip a list of image paths /
    data URIs on the host: (atlas (N, s, s + s/2, 4) uint8, page_sub (P, 4)
    int32) numpy arrays, slot 0 a full white page (material slot -1 leads
    there). page_size defaults to the largest bucket used (>= PAGE_SIZE),
    n_mips to log2(page / 16) + 1, so the mip floor stays 16^2."""
    decoded = []
    for src in image_sources:
        try:
            img = _decode_image(src)
        except (OSError, ValueError):
            # a missing or corrupt source turns white, as in the JAX package
            img = np.full((4, 4, 4), 255, np.uint8)
        decoded.append(img)
    if page_size is None:
        page_size = max([PAGE_SIZE] + [_bucket_for(*d.shape[:2])
                                       for d in decoded])
    if n_mips is None:
        n_mips = int(np.log2(page_size // 16)) + 1
    imgs = [np.full((page_size, page_size, 4), 255, np.uint8)]
    for img in decoded:
        imgs.append(_resize(img, _bucket_for(*img.shape[:2])))

    # shelf packing, largest first (stable order preserved via slot index)
    order = sorted(range(len(imgs)), key=lambda i: -imgs[i].shape[0])
    pages_data = []          # list of (page_size, page_size, 4) uint8
    free = []                # list of (page, ox, oy, size) free squares
    sub = [None] * len(imgs)

    def alloc(size):
        # the smallest free square that fits; quad-split the remainder
        cand = [f for f in free if f[3] >= size]
        if not cand:
            pages_data.append(np.zeros((page_size, page_size, 4), np.uint8))
            free.append((len(pages_data) - 1, 0, 0, page_size))
            return alloc(size)
        f = min(cand, key=lambda f: f[3])
        free.remove(f)
        page, ox, oy, fs = f
        while fs > size:
            half = fs // 2
            free.append((page, ox + half, oy, half))
            free.append((page, ox, oy + half, half))
            free.append((page, ox + half, oy + half, half))
            fs = half
        return page, ox, oy, size

    for i in order:
        b = imgs[i].shape[0]
        page, ox, oy, _ = alloc(b)
        pages_data[page][oy:oy + b, ox:ox + b] = imgs[i]
        sub[i] = (page, b, ox, oy)

    base = np.stack(pages_data)
    mips = [base]
    cur = base.astype(np.float32)
    for _ in range(n_mips - 1):
        n, s, _, c = cur.shape
        cur = cur.reshape(n, s // 2, 2, s // 2, 2, c).mean(axis=(2, 4))
        mips.append(np.round(cur).astype(np.uint8))
    s = page_size
    atlas = np.zeros((base.shape[0], s, s + s // 2, 4), np.uint8)
    atlas[:, :, :s] = base
    for m_i in range(1, n_mips):
        sm = s >> m_i
        y0 = s - 2 * sm
        atlas[:, y0:y0 + sm, s:s + sm] = mips[m_i]
    return atlas, np.asarray(sub, np.int32)


def build_texture_pages(image_sources, page_size: int | None = None,
                        n_mips: int | None = None, device=None):
    """`bake_texture_pages` uploaded to `device` (default CUDA; raises
    without it): (pages uint8 tensor, page_sub int32 tensor)."""
    dev = resolve_device(device)
    atlas, sub = bake_texture_pages(image_sources, page_size, n_mips)
    return (torch.from_numpy(atlas).to(dev),
            torch.from_numpy(sub).to(dev))


# ----------------------------------------------------------------------------
# fetch
# ----------------------------------------------------------------------------

def _srgb_rgb(x):
    from ..core.color import srgb_decode

    return torch.cat([srgb_decode(x[..., :3]), x[..., 3:4]], -1)


def sample_pages(pages, page_sub, page_idx, uv, mip=0, nearest: bool = False,
                 srgb: bool = False, lod_base=None):
    """Texture fetch from the packed mip atlas. page_idx: (...,) int32 slot
    (0 = white), uv: (..., 2). Returns (..., 4) float32.

    mip: a static int or a (...,) int32 tensor. lod_base: the per-ray
    ray-cone LOD term without its texture-size term; the level is then
    round(lod_base + log2(size)) per slot (overrides `mip`). `nearest`
    takes one texel instead of four; `srgb` decodes rgb to linear after the
    fetch."""
    n, s, width = pages.shape[0], pages.shape[1], pages.shape[2]
    n_mips = int(np.log2(s // 16)) + 1
    p = torch.clamp(page_idx, 0, page_sub.shape[0] - 1).long()
    meta = page_sub[p]                    # (..., 4): page, size, ox, oy
    page = torch.clamp(meta[..., 0], 0, n - 1).long()
    size0 = meta[..., 1]
    if lod_base is not None:
        mip = torch.clamp(torch.round(
            lod_base + torch.log2(size0.to(torch.float32))
        ).to(torch.int32), 0, n_mips - 1)
    elif isinstance(mip, torch.Tensor):
        mip = torch.clamp(mip.to(torch.int32), max=n_mips - 1)
    # atlas placement of mip m: m = 0 at (0, 0); m >= 1 in the right column
    # at x = s, y = s - 2 (s >> m). A static mip stays a Python int.
    if isinstance(mip, torch.Tensor):
        in_tail = mip > 0
        sm = s >> torch.clamp(mip, min=1)
        ox = (meta[..., 2] >> mip) + torch.where(in_tail, s, 0)
        oy = (meta[..., 3] >> mip) + torch.where(in_tail, s - 2 * sm, 0)
    else:
        mip = min(int(mip), n_mips - 1)
        ox = (meta[..., 2] >> mip) + (s if mip > 0 else 0)
        oy = (meta[..., 3] >> mip) + (s - 2 * (s >> mip) if mip > 0 else 0)
    size = size0 >> mip                   # subregion size at this mip
    sizef = size.to(torch.float32)
    texels = pages.reshape(-1, 4)
    row0 = page * s                       # first atlas row of the page

    def fetch(yi, xi):
        return texels[(row0 + yi.long()) * width + xi.long()]

    u = uv[..., 0] - torch.floor(uv[..., 0])      # wrap addressing
    v = uv[..., 1] - torch.floor(uv[..., 1])
    if nearest:
        xi = torch.minimum(torch.clamp((u * sizef).to(torch.int32), min=0),
                           size - 1) + ox
        yi = torch.minimum(torch.clamp((v * sizef).to(torch.int32), min=0),
                           size - 1) + oy
        out = fetch(yi, xi).to(torch.float32) * (1.0 / 255.0)
        return _srgb_rgb(out) if srgb else out
    x = u * sizef - 0.5
    y = v * sizef - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), size)
    x1i = torch.remainder(x0i + 1, size)
    y0i = torch.remainder(y0.to(torch.int32), size)
    y1i = torch.remainder(y0i + 1, size)
    c00 = fetch(y0i + oy, x0i + ox).to(torch.float32)
    c10 = fetch(y0i + oy, x1i + ox).to(torch.float32)
    c01 = fetch(y1i + oy, x0i + ox).to(torch.float32)
    c11 = fetch(y1i + oy, x1i + ox).to(torch.float32)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = (top * (1 - fy) + bot * fy) * (1.0 / 255.0)
    return _srgb_rgb(out) if srgb else out
