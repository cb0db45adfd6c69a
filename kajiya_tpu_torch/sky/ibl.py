"""Image-based lighting: HDR environment maps replacing the procedural sky
(port of `kajiya_tpu/sky/ibl.py`).

Loads a Radiance .hdr (or .exr where an EXR reader is installed) lat-long
panorama and resamples it into the octahedral layout of `sky/env.py`, so it
takes the procedural sky's place in the frame. The RGBE decoder (new-style
RLE and flat scanlines) is pure numpy, a copy of the JAX module's, since no
HDR library is installed; `write_hdr` is its flat-scanline inverse.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from .env import SKY_RES, oct_decode


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE) -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    # --- header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    buf = data[dim_end + 1:]

    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        # new-style RLE scanline?
        if w >= 8 and w < 32768 and buf[off] == 2 and buf[off + 1] == 2:
            if (buf[off + 2] << 8 | buf[off + 3]) != w:
                raise ValueError("HDR scanline width mismatch")
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = buf[off]
                    off += 1
                    if n > 128:
                        rgbe[y, x:x + n - 128, c] = buf[off]
                        off += 1
                        x += n - 128
                    else:
                        rgbe[y, x:x + n, c] = np.frombuffer(
                            buf, np.uint8, n, off)
                        off += n
                        x += n
        else:  # flat RGBE
            row = np.frombuffer(buf, np.uint8, w * 4, off).reshape(w, 4)
            rgbe[y] = row
            off += w * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def write_hdr(path: str, img: np.ndarray):
    """(H, W, 3) float radiance -> Radiance .hdr with flat RGBE scanlines
    (the encoding `load_hdr` reads back to within 1 part in 128)."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    h, w = img.shape[:2]
    peak = img.max(axis=-1)
    mant, exp = np.frexp(peak)
    rgbe = np.zeros((h, w, 4), np.uint8)
    live = peak >= 1e-32
    scale = np.where(live, mant * 256.0 / np.where(live, peak, 1.0), 0.0)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(live, exp + 128, 0).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"-Y {h} +X {w}\n".encode() + rgbe.tobytes())


def load_exr(path: str) -> np.ndarray:
    """EXR through imageio where it is installed; raises otherwise."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise RuntimeError(
            "no EXR reader available in this environment") from e
    return np.asarray(iio.imread(path), np.float32)[..., :3]


def panorama_to_env(pano: np.ndarray, res: int = SKY_RES,
                    rotation_deg: float = 0.0, device=None):
    """Lat-long (H, W, 3) -> octahedral (res, res, 3) env map on `device`.
    +Y is up; the rotation spins the panorama around +Y."""
    ar = torch.arange(res)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    uv = (torch.stack([gx, gy], -1) + 0.5) / res
    dirs = oct_decode(uv.to(torch.float32)).numpy()
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    theta = np.arccos(np.clip(y, -1, 1))            # 0 at +Y
    phi = np.arctan2(z, x) + np.deg2rad(rotation_deg)
    u = (phi / (2 * np.pi)) % 1.0
    v = theta / np.pi
    h, w = pano.shape[:2]
    xi = np.clip((u * w).astype(np.int32), 0, w - 1)
    yi = np.clip((v * h).astype(np.int32), 0, h - 1)
    return torch.as_tensor(np.ascontiguousarray(pano[yi, xi], np.float32),
                           device=resolve_device(device))


def load_ibl_env(path: str, res: int = SKY_RES, rotation_deg: float = 0.0,
                 device=None):
    """Load .hdr / .exr -> octahedral env map for the frame's sky slot."""
    ext = os.path.splitext(path)[1].lower()
    pano = load_hdr(path) if ext == ".hdr" else load_exr(path)
    return panorama_to_env(pano, res, rotation_deg, device=device)
