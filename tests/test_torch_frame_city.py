"""Port parity, the whole slice on a 12,290-triangle city (cluster tables,
Morton order and the culled kernel's plain version on the path): three
raster + sun-shadow frames at 64x48 with a camera move, and the state
carry-over check. Tolerances and checks as in test_torch_frame.py."""
import pytest

from kajiya_tpu.scene import procedural as proc_j
from test_torch_frame import check_carry_over, check_frame, run_slice


@pytest.fixture(scope="module")
def runs():
    return run_slice(lambda: proc_j.city(n=4, subdiv=8), (0.0, 8.0, 14.0),
                     (0.0, -0.45, -1.0), (0.15, -0.05, -0.1))


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_slice_frames_match_city(runs, frame):
    check_frame(runs, frame)


def test_state_carry_over_city(runs):
    check_carry_over(runs)
