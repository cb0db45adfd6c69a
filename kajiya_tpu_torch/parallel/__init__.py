"""Multi-device rendering over `torch.distributed` (port of
`kajiya_tpu/parallel/`): row-band (tile) sharding of the frame with explicit
halo, gather and reduce collectives, the sample-sharded path tracer, and the
host-major multi-host layout, with scene distribution from rank 0."""
from .mesh import (check_sharding_quality, collective_summary,
                   compile_frame_sharded, distribute_scene,
                   frame_state_sharding, init_distributed, make_mesh,
                   make_multihost_mesh, render_frame_multihost,
                   render_frame_sharded, shard_rays_pt)

__all__ = ["make_mesh", "frame_state_sharding", "render_frame_sharded",
           "shard_rays_pt", "make_multihost_mesh", "render_frame_multihost",
           "distribute_scene", "init_distributed", "compile_frame_sharded",
           "collective_summary", "check_sharding_quality"]
