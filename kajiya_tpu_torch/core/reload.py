"""Hot reload: edits to pass modules and to CUDA kernels take effect without
a restart (port of `kajiya_tpu/core/reload.py`).

The role of the reference's shader hot-reload chain (`file.rs:120-146`
watcher -> invalidation -> `pipeline_cache.rs:229-392` stale-pipeline
recompile). In the port the "shaders" are the Python pass modules and the
CUDA sources under `csrc/`: the watcher polls the mtimes of the loaded
modules of the package and of its kernel sources (`ops/_native.SOURCES`),
`importlib.reload`s the edited modules, and rebuilds and reloads the kernel
library when a kernel source changed (`_native.reload_library`); the next
`Renderer.draw` runs the fresh code (`Renderer.rebuild()`, JAX's re-trace,
is a no-op here). Temporal state (the FrameState) survives
untouched. A module whose reload raises, or a kernel build that fails, is
logged and not reported: the old code and the old kernels keep running (and
`Renderer.draw`'s last-good fallback, `renderer.rs:466-497`, covers a frame
that fails on new code)."""
from __future__ import annotations

import importlib
import logging
import os
import sys

_log = logging.getLogger("kajiya_tpu_torch")


class ModuleWatcher:
    """Polls the mtimes of every loaded module under `package` and of the
    package's kernel sources; `poll()` reloads the changed ones (leaf
    modules first, so package re-exports see fresh code) and reports their
    names: a module's name, or `<package>.csrc.<kernel file stem>` for a
    kernel source. Kernel sources are reloaded only once their library is
    loaded: before that, the first kernel call builds the edited sources."""

    def __init__(self, package: str = "kajiya_tpu_torch"):
        self.package = package
        self._mtimes: dict[str, float] = {}
        self._scan(record_only=True)

    def _native(self):
        return sys.modules.get(self.package + ".ops._native")

    def _files(self):
        for name, mod in list(sys.modules.items()):
            if not (name == self.package
                    or name.startswith(self.package + ".")):
                continue
            f = getattr(mod, "__file__", None)
            if f and os.path.exists(f):
                yield name, f
        native = self._native()
        if native is not None:
            for src in native.SOURCES:
                yield (f"{self.package}.csrc.{os.path.splitext(src)[0]}",
                       os.path.join(native.CSRC, src))

    def _scan(self, record_only: bool = False):
        changed = []
        for name, f in self._files():
            try:
                m = os.stat(f).st_mtime
            except OSError:
                continue
            old = self._mtimes.get(name)
            self._mtimes[name] = m
            if not record_only and old is not None and m > old:
                changed.append(name)
        return changed

    def poll(self) -> list[str]:
        """Reload edited modules and kernels; returns their names (empty =
        no edits). Deepest modules reload first so parent packages
        re-import the fresh children. A module whose reload raises, or a
        kernel library that fails to build, is logged and left out: the
        caller keeps running on the old code."""
        changed = sorted(self._scan(), key=lambda n: -n.count("."))
        kernels = [n for n in changed
                   if n.startswith(self.package + ".csrc.")]
        ok = []
        for name in changed:
            if name in kernels:
                continue
            try:
                importlib.reload(sys.modules[name])
                ok.append(name)
            except Exception as e:  # noqa: BLE001 - syntax errors etc.
                _log.error("hot reload of %s failed: %s: %s", name,
                           type(e).__name__, e)
        native = self._native()
        if kernels and native is not None and native.library_path():
            try:
                path = native.reload_library()
                _log.info("kernels rebuilt from %s: %s", kernels, path)
                ok.extend(kernels)
            except Exception as e:  # noqa: BLE001 - nvcc errors etc.
                _log.error("kernel rebuild after %s failed, the loaded "
                           "kernels keep running: %s: %s", kernels,
                           type(e).__name__, e)
        return ok
