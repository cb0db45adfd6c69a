"""Build, load and count the port's CUDA kernels.

The sources under `kajiya_tpu_torch/csrc/` have a plain C interface. At first
use they are compiled with nvcc for sm_90a, each source in its own process
and all at once, linked into one shared library under
`kajiya_tpu_torch/_build/` (gitignored, keyed by a hash of the sources and
flags) and loaded with ctypes. Nothing is built when the module is imported.

`launches` counts kernel launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernels.

Hot reload (`core/reload.py`): `reload_library` builds the edited sources
(a new digest, a new file) and loads that library in place of the loaded
one; a failed build raises and leaves the loaded kernels running. The
counts and the loaded library live on across an `importlib.reload` of this
module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("woop.cu", "warp.cu", "tileshift.cu", "bvh.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

launches = globals().get("launches", {})
for _name in ("woop_brute", "woop_culled", "warp", "tile_shift", "bvh_walk"):
    launches.setdefault(_name, 0)

_lib = globals().get("_lib")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "kt_woop_brute": [_P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P,
                      _P],
    "kt_woop_culled": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _I, _I,
                       _P, _P, _P, _P, _P, _P],
    "kt_warp": [_P, _I, _I, _I, _P, ctypes.c_longlong, _I, _P, _P],
    "kt_tile_shift": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P],
    "kt_bvh_walk": [_P, _P, _P, _F, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                    _P, _P, _P, _P, _P, _P, _P],
}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("kajiya_tpu_torch: nvcc not found; the CUDA "
                           "kernels are built from csrc/ at first use")
    return path


def build_library() -> str:
    """Compile csrc/*.cu into one shared library (cached by content hash)
    and return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    digest = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libkajiya_kernels_{digest}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    work = os.path.join(BUILD_DIR, f"{digest}.{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(work, name.replace(".cu", ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = os.path.join(work, "lib.so")
    subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)
    return so


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library; builds it on first use. Raises without a
    CUDA device or nvcc."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("kajiya_tpu_torch: a CUDA kernel was requested "
                           "but no CUDA device is available")
    _lib = _load(build_library())
    return _lib


def reload_library() -> str:
    """Build the library from the sources as they are now and load it in
    place of the loaded one; returns its path. A failed build raises and
    keeps the loaded library."""
    global _lib
    _lib = _load(build_library())
    return _lib._name


def library_path() -> str | None:
    """The path of the loaded library (None before the first kernel)."""
    return None if _lib is None else _lib._name


def check_cuda(*tensors: torch.Tensor):
    """Raise unless every tensor lies on a CUDA device (the kernel path)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"kernel inputs must all be CUDA tensors; got "
                               f"one on {t.device}")
    if not torch.cuda.is_available():
        raise RuntimeError("kajiya_tpu_torch: a CUDA kernel was requested "
                           "but no CUDA device is available")


def check_status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
