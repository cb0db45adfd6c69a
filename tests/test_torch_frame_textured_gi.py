"""Port parity, one frame of the GI path on the textured cornell at 64x48
(`secondary_full_shading` on: the checker is fetched at primary and at
secondary hits), through `kajiya_tpu.frame.render_frame` and
`kajiya_tpu_torch.frame.render_frame` from the same trace scene (carried
across by `convert`, the texture tables included), view and initial state.
Tolerance: the outputs, every state plane and the g-buffer's albedo within
1e-3 on >= 99% of pixels with mean <= 1e-4, as the untextured GI frame
(test_torch_frame_gi.py)."""
import pytest

from kajiya_tpu.scene import procedural as proc_j
from test_torch_frame import H, W, _n, assert_close, assert_state
from test_torch_frame_gi import GI, OUTPUTS, run_gi

TEXTURED_CORNELL = (lambda: proc_j.textured_cornell_box(), (0.0, 0.0, 2.4),
                    (0.0, 0.0, -1.0), (0.04, 0.013, 0.0))


@pytest.fixture(scope="module")
def gi_run():
    return run_gi(*TEXTURED_CORNELL, n=1)


def test_textured_gi_frame_matches(gi_run):
    ts_t, _, out = gi_run
    assert ts_t.gpu.tex_pages is not None     # carried across by convert
    r = out[0]
    for k in OUTPUTS:
        assert_close(r["oj"][k], r["ot"][k], k)
    assert_state(r["sj"], r["st"])
    alb_j, alb_t = r["oj"]["gbuffer"]["albedo"], r["ot"]["gbuffer"]["albedo"]
    assert_close(alb_j, alb_t, "albedo")
    # the checker shows on the floor: red-minus-blue varies there
    alb = _n(alb_t)
    cols = slice(W // 4, 3 * W // 4)
    floor_rb = alb[-10:, cols, 0] - alb[-10:, cols, 2]
    wall_rb = alb[H // 2 - 8: H // 2, cols, 0] - alb[H // 2 - 8: H // 2,
                                                     cols, 2]
    assert floor_rb.std() > 2.0 * wall_rb.std()
    assert GI["secondary_full_shading"]
