"""Host C++ libraries of the port, compiled with g++ at first use.

`rt/bvh.py` (`csrc/bvh_builder.cpp`, the BVH builder) and `scene/jpeg.py`
(`csrc/jpeg_encoder.cpp`, the viewer's JPEG encoder) each load one shared
library through `load`: compiled into the gitignored `_build/`, keyed by a
hash of the source and the flags (through a file of this process, renamed
into place, so concurrent builders never load half a file), and loaded with
ctypes. A build that fails raises with the compiler's output: the port has
no fallback for either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess


def load(source: str, name: str, cxx: str, flags, build_dir: str,
         what: str) -> ctypes.CDLL:
    """`source` compiled with `cxx flags` into `build_dir/lib{name}_{hash}.so`
    (once per source and flags), loaded. `what` names the library in the
    error raised when it cannot be built."""
    h = hashlib.sha256(" ".join(flags).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    out = os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx, *flags, source, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{what} could not be built: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{what} could not be built: {' '.join(cmd)} exited "
                f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)
