"""Port parity, the reference path tracer on the clustered
`city(n=4, subdiv=8)` over 16 bounces: one sample a pixel through the
gaussian pixel filter at 32x24 (the JAX tracer takes ~70 s for 16 bounces
at 64x48 on the CPU), per path and statistically against the tracer's own
noise. The 5-bounce per-path check is test_torch_reference_pt_city.py;
tolerances and helpers: test_torch_reference_pt.py."""
import numpy as np

from kajiya_tpu.core import camera as cam_j
from kajiya_tpu.renderers import reference as ref_j
from kajiya_tpu_torch import convert
from kajiya_tpu_torch.renderers import reference as ref_t
from test_torch_reference_pt import (W, H, _n, assert_paths_agree,
                                     assert_statistics_agree, scenes_for)
from test_torch_reference_pt_city import CITY


def test_path_trace_16_bounces_statistics():
    ts_j, ts_t = scenes_for(CITY[0])
    w, h = W // 2, H // 2
    vj = cam_j.make_view_constants(*CITY[1:], fov_y_deg=55.0, width=w,
                                   height=h)
    vt = convert.view_from_numpy(convert.to_numpy_dict(vj), device="cpu")
    rj = np.asarray(ref_j.render_sample(ts_j, vj, w, h, 5))
    rt = _n(ref_t.render_sample(ts_t, vt, w, h, 5))
    rt_other = _n(ref_t.render_sample(ts_t, vt, w, h, 99))
    assert_paths_agree(rj.reshape(-1, 3), rt.reshape(-1, 3), "city/16")
    assert_statistics_agree(rj, rt, rt_other, "city/16")
