"""Port parity, the reference path tracer on the clustered
`city(n=4, subdiv=8)` (12,290 triangles: culled kernel path, key-sorted
bounce wavefronts, no emissive triangles): `path_trace` per path over 5
bounces at 64x48, and the dead-lane skip against tracing every lane through
the culled tracer. The 16-bounce statistics run in
test_torch_reference_pt_city16.py (each JAX run takes 30-60 s on the CPU, so
the two land on different workers). Tolerances and helpers:
test_torch_reference_pt.py."""
import numpy as np
import pytest
import torch

from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu_torch.renderers import reference as ref_t
from test_torch_reference_pt import (W, H, assert_paths_agree, primary_rays,
                                     scenes_for, seeds, trace_both)

CITY = (lambda: proc_j.city(n=4, subdiv=8), (0.0, 8.0, 14.0),
        (0.0, -0.45, -1.0))


@pytest.fixture(scope="module")
def city():
    ts_j, ts_t = scenes_for(CITY[0])
    assert ts_t.woop.get("cmin64") is not None      # the culled path
    return ts_j, ts_t


def test_path_trace_per_path(city):
    org, d = primary_rays(*CITY[1:])
    rj, rt = trace_both(*city, org, d, seeds(W * H, 3), num_bounces=5)
    assert_paths_agree(rj, rt, "city/5")


def test_dead_lanes_skip_changes_nothing(city, monkeypatch):
    """As on cornell, through the sorted culled tracer (8 bounces, so paths
    end by russian roulette too): the dead lanes' t_max = 0 leaves every
    output bit as tracing all lanes gives it."""
    _, ts_t = city
    org, d = (torch.as_tensor(x)
              for x in primary_rays(*CITY[1:], w=W // 2, h=H // 2))
    seed = torch.as_tensor(seeds(org.shape[0], 11).astype(np.int64))
    skip = ref_t.path_trace(ts_t, org, d, seed, num_bounces=8)
    monkeypatch.setattr(ref_t, "_live_tmax", lambda live, t_max: t_max)
    every = ref_t.path_trace(ts_t, org, d, seed, num_bounces=8)
    assert torch.equal(skip, every)
