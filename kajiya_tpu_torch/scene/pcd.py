"""Kodak PhotoCD texture decoding, as PIL 12.1.0's `PcdImagePlugin`
reads it (`Image.open(f).convert("RGBA")`, byte for byte).

PIL reads only the 768 x 512 base image at byte 96 * 2048, whatever the
file holds (`PCD_` at byte 2048 names it; fewer than 1539 bytes from there
is a refusal): PIL's C `pcd` decoder takes blocks of two 768-byte luma
rows and then 384 bytes each of Cb and Cr, shared by the two rows, through
the `YCC;P` unpacker's PhotoYCC conversion (`raster.photoycc_to_rgb`). A
file that ends before the last block is truncated (white). The low two
bits of byte 2048 + 1538 turn the image: 1 a quarter turn counter-clockwise,
3 clockwise (PIL's `rotate(..., expand=True)`, a transpose).
"""
from __future__ import annotations

import numpy as np

from . import raster
from .identify import opening
from .raster import DecodeError, Stream

W, H = 768, 512
OFFSET = 96 * 2048


def decode_pcd(data: bytes) -> np.ndarray:
    """PCD bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("PCD"):
        fp = Stream(data, 2048)
        s = fp.read(1539)
        if not s.startswith(b"PCD_"):
            raise SyntaxError("not a PCD file")
        orientation = s[1538] & 3
    if len(data) < OFFSET + W * H * 3 // 2:
        raise DecodeError("PCD: image file is truncated")
    blocks = np.frombuffer(data, np.uint8, W * H * 3 // 2, OFFSET).reshape(
        H // 2, 3 * W)
    y = blocks[:, :2 * W].reshape(H, W)
    half = np.arange(W) // 2
    cb = np.repeat(blocks[:, 2 * W + half], 2, axis=0)
    cr = np.repeat(blocks[:, 2 * W + W // 2 + half], 2, axis=0)
    rgb = raster.photoycc_to_rgb(y, cb, cr)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, -1)
    return raster.to_rgba("RGB", np.ascontiguousarray(rgb))


def encode_pcd(img: np.ndarray, orientation: int = 0) -> bytes:
    """(512, 768, 3) uint8 RGB, or (768, 512, 3) for `orientation` 1 or 3
    (stored turned, so that PIL turns it back) -> a PCD file (the base
    image only) that PIL reads near these texels (PhotoYCC keeps chroma at
    half width, and its 8-bit values round)."""
    if orientation == 1:
        img = np.rot90(img, -1)
    elif orientation == 3:
        img = np.rot90(img, 1)
    if img.shape[:2] != (H, W):
        raise ValueError(f"PCD base image of {img.shape[:2]}: wants "
                         f"{(H, W)} as stored")
    rgb = img.astype(np.float64)
    lum = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    y = np.clip(np.rint(lum / 1.3584), 0, 255).astype(np.uint8)
    c1 = (rgb[..., 2] - lum) / 2.2179 + 156
    c2 = (rgb[..., 0] - lum) / 1.8215 + 137
    cb = np.clip(np.rint((c1[0::2] + c1[1::2]).reshape(H // 2, W // 2, 2)
                         .mean(-1) / 2), 0, 255).astype(np.uint8)
    cr = np.clip(np.rint((c2[0::2] + c2[1::2]).reshape(H // 2, W // 2, 2)
                         .mean(-1) / 2), 0, 255).astype(np.uint8)
    blocks = np.concatenate([y.reshape(H // 2, 2 * W), cb, cr], -1)
    head = bytearray(OFFSET)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + blocks.tobytes()
