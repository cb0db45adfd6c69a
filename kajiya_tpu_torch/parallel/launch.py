"""Start the ranks of a process group on one machine.

    launch.spawn(fn, nprocs, args, timeout_s=600)

runs fn(mesh_args, *args) in `nprocs` processes started by
`torch.multiprocessing` (spawn), each of which first joins a process group
through `init_distributed` with a file:// rendezvous in a fresh temporary
directory, so that concurrent launches never meet. `mesh_args` is
(rank, nprocs, backend). The caller waits for every rank with a timeout; a
rank that raises or dies fails the launch with the rank's traceback, and the
other ranks are stopped. `fn` must be importable by name (a module-level
function of a module that the ranks can import).
"""
from __future__ import annotations

import os
import tempfile
import time

import torch.multiprocessing as mp


def _rank_main(rank, fn, nprocs, init_method, backend, args):
    import torch.distributed as dist

    from .mesh import init_distributed

    used = init_distributed(num_processes=nprocs, process_id=rank,
                            backend=backend, init_method=init_method)
    try:
        fn((rank, nprocs, used), *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), backend=None, timeout_s: float = 600.0):
    """Run fn((rank, nprocs, backend), *args) on `nprocs` ranks and wait for
    them. Raises the failing rank's error (torch's ProcessRaisedException /
    ProcessExitedException), or TimeoutError after `timeout_s`."""
    with tempfile.TemporaryDirectory(prefix="kajiya_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, init_method, backend, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish in "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
