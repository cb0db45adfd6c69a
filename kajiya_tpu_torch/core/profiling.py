"""Per-pass profiler ranges (port of `kajiya_tpu/core/profiling.py::pass_scope`).

`pass_scope(name)` is `torch.profiler.record_function`: each pass shows up as
a named range in a `torch.profiler` trace, with the device time of the
kernels it launched. Outside a profiler it adds only a small host cost
per pass (nine ranges per frame).
"""
from __future__ import annotations

import torch


def pass_scope(name: str):
    """Annotate a pass for the profiler."""
    return torch.profiler.record_function(name)
