"""The live viewer (`kajiya_tpu_torch/apps/stream.py`): the mailbox and every
HTTP endpoint against a stub renderer on port 0 (the port of
`tests/test_view_layer.py::TestStreamViewer`), and the viewer's images
against the JAX viewer's.

Parity: a JAX `ViewerState` over a JAX `Renderer` (its frame compiled, as
the JAX viewer runs it) and the port's over the port's `Renderer` on the
CPU, both on cornell at 32x24 with the small irradiance cache, take the same
`/set` sequence through `apply` (`use_rtr=false`, which rebuilds,
`sun=30,40`, `emissive=2`), one frame after each, with the render loop's
body stepped by hand. For every `SHOWABLE` output the uint8 images must be
equal within 1 level on >= 99% of the pixels. The emissive change must move
the emissive g-buffer plane in both packages: the port's trace scene bakes
the emissive table, so this is the check that `set_emissive` marks it
stale.

The camera is the GI tests' knife-edge-free one (test_torch_frame_gi.py):
at (0, 0, 2.4) a sun shadow ray from the top-left ceiling corner grazes an
edge, and JAX's compiled frame differs there from its own eager frame
(11 of the 768 pixels above 1e-3 in `shadow` and `final`), while the
port's equals the eager one (0 pixels)."""
import json
import time
import urllib.error
import urllib.request
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kajiya_tpu_torch.apps import stream as stream_t
from kajiya_tpu_torch.frame import RenderConfig
from kajiya_tpu_torch.scene.jpeg import read_jpeg_header

W, H = 32, 24
LEVEL_SHARE = 0.99
STEPS = (("start", {}), ("use_rtr", {"use_rtr": ["false"]}),
         ("sun", {"sun": ["30,40"]}), ("emissive", {"emissive": ["2"]}))
SMALL_IRCACHE = dict(max_entries=4096, active_budget=1024)


def test_mailbox_latest_wins():
    mb = stream_t.FrameMailbox()
    mb.put(np.zeros((2, 2, 3), np.uint8))
    mb.put(np.ones((2, 2, 3), np.uint8))
    frame, seq = mb.get(0, timeout=0.1)
    assert frame is not None and frame.max() == 1 and seq == 2


class StubRenderer:
    """What the viewer reads of a Renderer, drawing a flat grey frame."""

    def __init__(self):
        self.cfg = RenderConfig(width=8, height=6)
        self.device = torch.device("cpu")
        self.ts = SimpleNamespace(gpu=SimpleNamespace(
            mat_emissive=torch.ones((1, 3)),
            sun_direction=torch.tensor([0.0, 1.0, 0.0])))
        self._last_error = None
        self.rebuilds = 0
        self.emissive_sets = []

    def draw(self, view):
        assert view.device.type == "cpu"
        return {"final": torch.full((6, 8, 3), 0.5),
                "ssao": torch.full((6, 8), 0.25)}

    def rebuild(self):
        self.rebuilds += 1

    def set_emissive(self, values):
        self.emissive_sets.append(values)
        self.ts.gpu.mat_emissive = values


def _read_part(resp):
    """One multipart part of /stream: its headers, then its body."""
    assert resp.readline() == b"--frame\r\n"
    headers = {}
    while True:
        line = resp.readline().strip()
        if not line:
            break
        k, v = line.decode().split(":", 1)
        headers[k.strip().lower()] = v.strip()
    body = resp.read(int(headers["content-length"]))
    assert resp.readline() == b"\r\n"
    return headers, body


def test_http_endpoints():
    r = StubRenderer()
    srv, stop = stream_t.serve(r, (0, 0, 2), (0, 0, -1), port=0, block=False)
    port = srv.server_address[1]

    def get(path, timeout=10):
        return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=timeout).read()

    def wait_for(cond, what, seconds=30.0):
        """The render thread runs beside the server: poll until `cond`
        holds (both viewers answer /snap with 503 before the first frame,
        and apply /set between frames)."""
        deadline = time.monotonic() + seconds
        while not cond():
            assert time.monotonic() < deadline, f"no {what} in {seconds} s"
            time.sleep(0.01)

    try:
        wait_for(lambda: json.loads(get("/status"))["frames"] >= 1,
                 "first frame")
        snap = get("/snap")
        assert snap[:4] == b"\x89PNG"
        from kajiya_tpu_torch.scene.png import decode_png

        px = decode_png(snap)
        assert px.shape == (6, 8, 4) and (px[..., :3] == 127).all()
        st = json.loads(get("/status"))
        assert st["config"]["debug_mode"] == "none"
        assert st["show"] == "final" and st["last_error"] is None
        assert st["frames"] >= 1
        assert set(st["launches"]) == {"woop_brute", "woop_culled", "warp",
                                       "tile_shift", "bvh_walk"}
        assert st["encode"]["png"]["bytes"] == len(snap)
        r_ = json.loads(get("/set?ev=1.5&orbit=0.2"))
        assert r_["ev"] == 1.5 and r_["orbit"] == 0.2
        # pass-output picker (GraphDebugHook analog) + generic config set
        r_ = json.loads(get("/set?show=ssao&use_rtr=false"
                            "&roughness_scale=0.5"))
        assert (r_["show"], r_["use_rtr"], r_["roughness_scale"]) == \
            ("ssao", False, 0.5)
        # unknown output advertises the menu (the /ui page builds on it)
        r_ = json.loads(get("/set?show=zzz"))
        assert "gbuffer.albedo" in r_["known_outputs"]
        r_ = json.loads(get("/set?debug_mode=zzz"))
        assert "none" in r_["known_debug_modes"]
        r_ = json.loads(get("/set?bogus=1"))
        assert "known_params" in r_
        # the sun writes the scene table on the renderer's device
        r_ = json.loads(get("/set?sun=0,90"))
        assert abs(r_["sun"][1] - 1.0) < 1e-6
        assert isinstance(r.ts.gpu.sun_direction, torch.Tensor)
        assert abs(float(r.ts.gpu.sun_direction[1]) - 1.0) < 1e-6
        # the emissive multiplier goes through set_emissive, from the
        # unscaled table
        json.loads(get("/set?emissive=2"))
        json.loads(get("/set?emissive=3"))
        assert [float(v[0, 0]) for v in r.emissive_sets] == [2.0, 3.0]
        # the imgui-analog panel serves
        assert b"Debug mode" in get("/ui")
        # JPEG parts of the stream's size
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                      timeout=10)
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        for _ in range(2):
            headers, body = _read_part(resp)
            assert headers["content-type"] == "image/jpeg"
            assert read_jpeg_header(body) == (8, 6, 3)
        resp.close()
        st = json.loads(get("/status"))
        assert st["encode"]["jpeg"]["bytes"] > 0
        # the config change was applied between frames, with a rebuild
        wait_for(lambda: (r.cfg.use_rtr, r.cfg.roughness_scale,
                          r.cfg.ev_shift) == (False, 0.5, 1.5),
                 "config applied after /set")
        assert r.rebuilds >= 1 and r.cfg.use_rtr is False
        assert r.cfg.roughness_scale == 0.5 and r.cfg.ev_shift == 1.5
    finally:
        stop.set()
        srv.shutdown()
        srv.server_close()


def test_unknown_path_is_404():
    r = StubRenderer()
    srv, stop = stream_t.serve(r, (0, 0, 2), (0, 0, -1), port=0, block=False)
    port = srv.server_address[1]
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=5)
        assert e.value.code == 404
    finally:
        stop.set()
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def viewer_runs():
    """Both viewers through STEPS: per step, the outputs of the frame drawn
    after it, in each package."""
    from kajiya_tpu.apps import stream as stream_j
    from kajiya_tpu.core.camera import make_view_constants as view_j
    from kajiya_tpu.frame import RenderConfig as CfgJ
    from kajiya_tpu.frame import Renderer as RendererJ
    from kajiya_tpu.renderers.ircache import IrcacheConfig as IrcJ
    from kajiya_tpu.scene import procedural as proc_j
    from kajiya_tpu_torch.core.camera import make_view_constants as view_t
    from kajiya_tpu_torch.frame import Renderer as RendererT
    from kajiya_tpu_torch.renderers.ircache import IrcacheConfig as IrcT
    from kajiya_tpu_torch.scene import procedural as proc_t

    rj = RendererJ(proc_j.cornell_box(),
                   CfgJ(width=W, height=H, ircache=IrcJ(**SMALL_IRCACHE)))
    rt = RendererT(proc_t.cornell_box(),
                   RenderConfig(width=W, height=H,
                                ircache=IrcT(**SMALL_IRCACHE)),
                   device="cpu")
    vsj = stream_j.ViewerState(rj)
    vst = stream_t.ViewerState(rt)
    cam = ((0.04, 0.013, 2.4), (0.0, 0.0, -1.0))
    vj = view_j(*cam, fov_y_deg=55.0, width=W, height=H)
    vt = view_t(*cam, fov_y_deg=55.0, width=W, height=H, device="cpu")

    def step_j():
        """The JAX render loop's body (apps/stream.py::render_loop)."""
        with vsj.lock:
            if vsj.dirty:
                rj.cfg = replace(rj.cfg, **vsj.cfg_overrides)
                vsj.cfg_overrides.clear()
                rj.rebuild()
                vsj.dirty = False
        return rj.draw(vj)

    runs = {}
    for name, params in STEPS:
        assert "error" not in vsj.apply(params)
        assert "error" not in vst.apply(params)
        oj = step_j()
        ot, _ = vst.step(vt)
        assert rj._last_error is None and rt._last_error is None
        runs[name] = (oj, ot)
    assert rt.cfg.use_rtr is False and rj.cfg.use_rtr is False
    return stream_j, runs


@pytest.mark.parametrize("show", stream_t.SHOWABLE)
@pytest.mark.parametrize("step", [s for s, _ in STEPS])
def test_viewer_parity(viewer_runs, step, show):
    stream_j, runs = viewer_runs
    oj, ot = runs[step]
    a = stream_j._displayable(oj, show)
    b = stream_t._displayable(ot, show)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (H, W, 3)
    near = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1) <= 1
    assert near.mean() >= LEVEL_SHARE, (step, show, near.mean())


def test_emissive_moves_the_frame(viewer_runs):
    """`/set?emissive=2` doubles the emitter in the next frame's g-buffer
    in both packages (the port marks its trace scene stale)."""
    stream_j, runs = viewer_runs
    for pkg, disp, k in (("jax", stream_j._displayable, 0),
                         ("port", stream_t._displayable, 1)):
        before = disp(runs["sun"][k], "gbuffer.emissive")
        after = disp(runs["emissive"][k], "gbuffer.emissive")
        assert (after.astype(int) > before.astype(int)).any(), pkg
        g_before = np.asarray(runs["sun"][k]["gbuffer"]["emissive"])
        g_after = np.asarray(runs["emissive"][k]["gbuffer"]["emissive"])
        lit = g_before > 0
        assert lit.any(), pkg
        np.testing.assert_allclose(g_after[lit], 2.0 * g_before[lit],
                                   rtol=1e-6, err_msg=pkg)
