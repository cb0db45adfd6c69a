"""The banded passes of the options and super-resolution frames, one band at
a time in one process, against the same pass on the whole frame: bit for
bit at the 1080p frame's row geometry (1280x720 rendered, 1920x1080 out;
narrow widths, since only the rows decide which band reads what) and on
the test frames' 72 / 108 rows.

A `SliceBand` stands in for a rank's band: it reads the rows its window or
halo asks for from the whole plane instead of from the other ranks, so each
band's result is that of the same code on a rank (test_torch_parallel.py
runs the frames themselves on four gloo ranks). The traced g-buffer and
the world radiance cache's probe split run on a scene with cluster tables
(city(n=4), 12,290 triangles): the culled route, whose ray chunks and their
culling beams change when the rays are split."""
from dataclasses import dataclass

import pytest
import torch

from kajiya_tpu_torch.core.camera import make_view_constants
from kajiya_tpu_torch.parallel.comm import Band, Comm
from kajiya_tpu_torch.parallel.mesh import band_rows
from kajiya_tpu_torch.renderers import dof, gbuffer, taa, wrc

N = 4
# (render rows, output rows) of the super-resolution frames: the chip's
# 1080p output and the CPU test's 108 rows
SUPERRES = ((720, 1080), (72, 108))


@dataclass(frozen=True)
class SliceBand(Band):
    """Member `comm.index`'s band of `whole`: its window and halo rows are
    cut from the whole plane, as the ranks holding them would send them."""

    whole: torch.Tensor | None = None

    def halo(self, x, top, bottom=None, label=""):
        bottom = top if bottom is None else bottom
        lo, hi = max(0, self.y0 - top), min(self.height, self.y1 + bottom)
        return self.whole[lo:hi], self.y0 - lo

    def window(self, x, needs, label=""):
        lo, hi = needs[self.comm.index]
        return self.whole[lo:hi], lo


def bands(height, width, whole=None):
    rows = band_rows(height, N)
    return [SliceBand(Comm(ranks=tuple(range(N)), index=i, backend="none",
                           device=torch.device("cpu")),
                      rows, height, width, whole) for i in range(N)]


def test_super_resolution_bands():
    """The output bands are not the render bands scaled (1080 rows: 272 /
    272 / 272 / 264 against 720's 176 / 192 / 176 / 176; 108 against 72),
    and every output band starts on a multiple of 16 rows, so motion blur's
    16-row tiles and its quarter-res plane split on band edges (the 27
    quarter-res rows of 108: 8 / 4 / 8 / 7)."""
    assert band_rows(1080, N) == ((0, 272), (272, 544), (544, 816),
                                  (816, 1080))
    assert band_rows(720, N) == ((0, 176), (176, 368), (368, 544),
                                 (544, 720))
    assert band_rows(108, N) == ((0, 32), (32, 48), (48, 80), (80, 108))
    assert band_rows(72, N) == ((0, 16), (16, 32), (32, 48), (48, 72))
    for h, out_h in SUPERRES:
        scaled = [(a * out_h // h, b * out_h // h) for a, b in
                  band_rows(h, N)]
        assert scaled != list(band_rows(out_h, N))
    out = bands(108, 96)[0]
    assert out.scaled(4).rows == ((0, 8), (8, 12), (12, 20), (20, 27))
    assert out.scaled(16).rows == ((0, 2), (2, 3), (3, 5), (5, 6))
    assert all(a % 16 == 0 for a, _b in band_rows(1080, N))


@pytest.mark.parametrize("h,out_h", SUPERRES)
@pytest.mark.parametrize("way", ["to_out", "to_render"])
def test_resize_windows(h, out_h, way):
    """TAA's nearest resizes between the render and output bands, each read
    from a window of the other resolution's rows: the whole frame's resize,
    cut to the band, bit for bit."""
    w, out_w = 16, 24
    g = torch.Generator().manual_seed(1)
    src_h, src_w = (h, w) if way == "to_out" else (out_h, out_w)
    x = torch.rand((src_h, src_w, 5), generator=g)
    if way == "to_out":
        whole = taa._to_out(x, h, out_h, out_w)
        for rb, ob in zip(bands(h, w, x), bands(out_h, out_w)):
            got = taa._to_out(rb.rows_of(x), h, out_h, out_w, rb, ob)
            assert torch.equal(got, ob.rows_of(whole))
    else:
        whole = taa._to_render(x, h, w, out_h)
        for rb, ob in zip(bands(h, w), bands(out_h, out_w, x)):
            got = taa._to_render(ob.rows_of(x), h, w, out_h, ob, rb)
            assert torch.equal(got, rb.rows_of(whole))


@pytest.mark.parametrize("h,out_h", SUPERRES)
def test_superres_taps(h, out_h):
    """The unjitter's 27-channel fetch of the pre-shifted taps (one row
    beyond the base pixels each way) and its jitter lattice, from the
    window of render rows the output band reaches: bit for bit."""
    w, out_w = 16, 24
    g = torch.Generator().manual_seed(2)
    iycc = torch.rand((h, w, 3), generator=g)
    jitter = torch.tensor([0.31, -0.27])
    whole = taa._superres_taps(iycc, jitter, h, w, out_h, out_w)
    for rb, ob in zip(bands(h, w, iycc), bands(out_h, out_w)):
        got = taa._superres_taps(rb.rows_of(iycc), jitter, h, w, out_h,
                                 out_w, rb, ob)
        assert torch.equal(got[0], whole[0][:, ob.y0:ob.y1])
        for a, b in zip(got[1:3], whole[1:3]):
            assert torch.equal(a, ob.rows_of(b))


@pytest.mark.parametrize("height", [1080, 108])
def test_dof_halo(height):
    """Depth of field on a band, its colour and CoC fetched with HALO rows
    each way (derived from the largest CoC): the whole frame's gather, cut
    to the band, bit for bit, with every pixel's CoC at the largest (the
    surface a tenth of the focus distance away) or varied."""
    w = 24
    g = torch.Generator().manual_seed(3)
    color = torch.rand((height, w, 3), generator=g)
    for depth in (torch.full((height, w), 0.05),
                  torch.rand((height, w), generator=g) * 0.03):
        coc = dof.circle_of_confusion(depth, 2.0, 4.0)
        if float(depth[0, 0]) == 0.05:
            assert bool((coc.abs() == dof.MAX_COC_PX).all())
        whole = dof.dof_gather(color, depth, 2.0, 4.0)
        src = torch.cat([color, coc.abs()[..., None]], dim=-1)
        for b in bands(height, w, src):
            got = dof.dof_gather(b.rows_of(color), b.rows_of(depth), 2.0,
                                 4.0, band=b)
            assert torch.equal(got, b.rows_of(whole))
    assert dof.HALO == 13
    assert float(coc.abs().max()) <= dof.MAX_COC_PX


@pytest.fixture(scope="module")
def city():
    from kajiya_tpu_torch.scene import procedural
    from kajiya_tpu_torch.scene.scene import build_gpu_scene
    from kajiya_tpu_torch.world import build_trace_scene

    torch.set_num_threads(2)
    gpu = build_gpu_scene(procedural.city(n=4, subdiv=8), device="cpu")
    ts = build_trace_scene(gpu, device="cpu")[0]
    assert ts.woop.get("cmin") is not None      # the culled route
    return ts


def test_traced_gbuffer_bands(city):
    """The traced g-buffer of each band (camera rays of its rows, 64x128
    tiles counted from its first row, the last tile edge-padded with copies
    of real rays: no band here is a multiple of 64 rows) equals the whole
    frame's rows bit for bit; the padding changes no hit."""
    h, w = 96, 128
    v = make_view_constants((0.0, 8.0, 14.0), (0.0, -0.45, -1.0), width=w,
                            height=h, device="cpu")
    whole = gbuffer.raytrace_gbuffer(city, v, w, h)
    assert 0.2 < float(whole["hit"].float().mean()) < 0.9
    for b in bands(h, w):
        assert b.n % 64
        got = gbuffer.raytrace_gbuffer(city, v, w, h, band=b)
        for k, x in whole.items():
            assert torch.equal(got[k], b.rows_of(x)), (b.rows, k)


def test_wrc_probe_split(city):
    """Each rank traces its probes' texels (a contiguous slice of the probe
    wavefront, other ray chunks than the whole wavefront's) and blends its
    slice of the atlas: the slices, put together, are the whole atlas bit
    for bit, from a live atlas and from the whole one cut to the slice."""
    from kajiya_tpu_torch.sky import env as sky_env_mod

    cfg = wrc.WrcConfig(grid=(4, 2, 4), probe_res=8, grid_spacing=2.0,
                        grid_origin=(-3.0, 0.5, -3.0))
    sun = city.gpu.sun_direction
    sh = sky_env_mod.project_sh9(sky_env_mod.build_sky_env(sun, res=32))
    sky = sky_env_mod.sh9_radiance_fn(sh)
    diffuse = sky_env_mod.sh9_irradiance_fn(sh)
    g = torch.Generator().manual_seed(4)
    st = {"wrc_atlas": torch.rand((32, 8, 8, 3), generator=g)}
    whole = wrc.trace_wrc(st, city, sky, diffuse, 0, cfg)["wrc_atlas"]
    comm = [Comm(ranks=tuple(range(N)), index=i, backend="none",
                 device=torch.device("cpu")) for i in range(N)]
    parts = []
    for c in comm:
        probes = wrc.probe_band(cfg, c)
        part = wrc.trace_wrc({"wrc_atlas": probes.rows_of(st["wrc_atlas"])},
                             city, sky, diffuse, 0, cfg,
                             probes=probes)["wrc_atlas"]
        cut = wrc.trace_wrc(st, city, sky, diffuse, 0, cfg,
                            probes=probes)["wrc_atlas"]
        assert part.shape == (8, 8, 8, 3) and torch.equal(part, cut)
        parts.append(part)
    assert torch.equal(torch.cat(parts), whole)
    assert float((whole - st["wrc_atlas"] * 0.9).abs().max()) > 0.0
