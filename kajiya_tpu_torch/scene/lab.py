"""LAB -> RGBA, as PIL 12.1.0's `convert("RGBA")` of a LAB image gives it
(byte for byte): TIFF's CIELab photometric and PSD's Lab mode reach it.

PIL converts LAB through LittleCMS (`Image.convert`, `ImageCms.
buildTransform(createProfile("LAB"), createProfile("sRGB"), "LAB",
"RGBA")`): lcms 2.17 samples the float Lab -> sRGB pipeline into a 33^3
16-bit table and interpolates it tetrahedrally. `csrc/lab_transform.cpp`
computes that table as lcms does (no table is copied from lcms) and runs
the per-pixel loop; it is compiled with g++ at first use into the
gitignored `_build/` (`hostlib.load`), and a failed build raises.

A LAB image is held as PIL stores it, (H, W, 4) uint8: L, then a and b
offset by 128 (PIL's "LAB" raw mode reads signed a and b and adds 128; a
band's raw mode, as PSD's planes and a separate-plane TIFF use, copies the
byte), then a pad byte that `convert("RGBA")` copies into alpha (255 from
the "LAB" raw mode, 0 where nothing wrote it).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import hostlib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "lab_transform.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
GRID = 33

_lock = threading.Lock()
_lib = None
_nodes = None


def library() -> ctypes.CDLL:
    """The transform's native code, compiled at first use into BUILD_DIR."""
    global _lib
    with _lock:
        if _lib is None:
            lib = hostlib.load(SOURCE, "lab_transform", CXX, CXX_FLAGS,
                               BUILD_DIR, "the LAB transform")
            ptr = ctypes.c_void_p
            lib.kt_lab_nodes.argtypes = [ptr]
            lib.kt_lab_nodes.restype = None
            lib.kt_lab_to_rgba.argtypes = [ptr, ctypes.c_longlong, ptr, ptr]
            lib.kt_lab_to_rgba.restype = None
            _lib = lib
        return _lib


def nodes() -> np.ndarray:
    """lcms's CLUT: (GRID, GRID, GRID, 3) uint16 over L, a, b."""
    global _nodes
    lib = library()
    with _lock:
        if _nodes is None:
            t = np.empty((GRID, GRID, GRID, 3), np.uint16)
            lib.kt_lab_nodes(t.ctypes.data)
            _nodes = t
        return _nodes


def unpack_lab(rows: np.ndarray, w: int) -> np.ndarray:
    """PIL's "LAB" raw mode: (H, >= 3 w) bytes of L and signed a, b ->
    (H, w, 4) storage, pad 255."""
    h = rows.shape[0]
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = rows[:, :3 * w].reshape(h, w, 3)
    out[..., 1:3] ^= 128
    out[..., 3] = 255
    return out


def to_rgba(px: np.ndarray) -> np.ndarray:
    """(H, W, 4) LAB storage -> (H, W, 4) uint8 RGBA."""
    src = np.ascontiguousarray(px, np.uint8)
    out = np.empty(src.shape, np.uint8)
    library().kt_lab_to_rgba(src.ctypes.data, src.size // 4,
                             nodes().ctypes.data, out.ctypes.data)
    return out
