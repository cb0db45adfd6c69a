"""Port parity, the default frame on the 3,074-triangle city(n=2, subdiv=8)
on the BVH route (forced with brute_max_tris=0) at 64x48, JAX's eager frame
against the port's, each refitting its BVH through `levels` every frame
(`run_default_bvh` of test_torch_frame_bvh_default.py). No emissive
triangle. Two frames (frame 0 validates, frame 1 reuses its reservoirs and
history), at test_torch_frame_default_city.py's bounds: the planes
downstream of the RTR lobe resolve's coplanar knife edge (the ground plane;
shown there by `test_coplanar_reflection_knife_edge`) to its `KNIFE`
fractions, every other plane to the strict bound. A file of its own, so
that it runs beside the cornell frames on another worker."""
import pytest

from kajiya_tpu.scene import procedural as proc_j
from test_torch_frame_bvh_default import run_default_bvh
from test_torch_frame_default import check_frame
from test_torch_frame_default_city import KNIFE

CITY2 = (lambda: proc_j.city(n=2, subdiv=8), (0.0, 3.0, 6.0),
         (0.0, -0.45, -1.0), (0.04, 0.013, 0.0), False)
N_CITY_FRAMES = 2


@pytest.fixture(scope="module")
def city_runs():
    return run_default_bvh(*CITY2, n=N_CITY_FRAMES)


def test_city_bvh_route(city_runs):
    ts_t, cfg_t, _ = city_runs
    assert ts_t.woop is None and ts_t.gpu.num_triangles == 3074
    assert not cfg_t.use_mesh_light_specular


@pytest.mark.parametrize("frame", range(N_CITY_FRAMES))
def test_city_bvh_default_frame(city_runs, frame):
    check_frame(city_runs, frame, KNIFE)
