"""Port parity, the diffuse-GI slice as a whole on a 12,290-triangle city
(cluster tables: the GI candidate, sun-NEE and validation rays run as sorted
wavefronts in 128-ray chunks through the culled kernel's plain version): four
frames at 64x48 with a camera move and the carry-over check into the second
validation frame. Tolerances and checks as in test_torch_frame_gi.py."""
import pytest

from kajiya_tpu.scene import procedural as proc_j
from test_torch_frame_gi import (N_FRAMES, check_gi_carry_over,
                                 check_gi_frame, run_gi)


@pytest.fixture(scope="module")
def runs():
    return run_gi(lambda: proc_j.city(n=4, subdiv=8), (0.0, 8.0, 14.0),
                  (0.0, -0.45, -1.0), (0.15, -0.05, -0.1))


def test_city_takes_the_sorted_wavefront(runs):
    from kajiya_tpu_torch.rt.trace import _can_sort

    ts_t, _, _ = runs
    assert _can_sort(ts_t, True)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_gi_frames_match_city(runs, frame):
    check_gi_frame(runs, frame)


def test_gi_state_carry_over_city(runs):
    check_gi_carry_over(runs)
