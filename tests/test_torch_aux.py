"""The port's core utilities and small apps, each against its JAX model
(`tests/test_aux.py:63-212`) or the JAX function on the same inputs:
hot reload (`core/reload.py`: modules, and the kernel library through
`ops/_native.py`), `Renderer.rebuild` and the stale trace scene,
`core/debugging.py` (NaN guards, `debug_view` within 1e-6 of JAX's,
including a plane above 2^24 elements), `core/profiling.py`,
`core/logging.py`, `apps/keymap.py`, `apps/persisted.py` and
`apps/hello.py`."""
import importlib
import json
import logging
import os
import sys
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu_torch.core import debugging, profiling
from kajiya_tpu_torch.core.reload import ModuleWatcher


def _bump(path):
    """An edit the watcher sees: mtime two seconds on."""
    os.utime(path, (time.time() + 2, time.time() + 2))


@pytest.fixture
def hot_package(tmp_path):
    """A throwaway package `name` with one leaf module VALUE = 1."""
    made = []

    def make(name):
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text("")
        (pkg / "leaf.py").write_text("VALUE = 1\n")
        made.append(name)
        return pkg

    sys.path.insert(0, str(tmp_path))
    try:
        yield make
    finally:
        sys.path.remove(str(tmp_path))
        for m in [m for m in sys.modules
                  if any(m.split(".")[0] == n for n in made)]:
            del sys.modules[m]


class TestHotReload:
    def test_watcher_reloads_edited_module(self, hot_package):
        pkg = hot_package("hotpkg_t")
        leaf = importlib.import_module("hotpkg_t.leaf")
        w = ModuleWatcher(package="hotpkg_t")
        assert w.poll() == []                      # nothing edited
        (pkg / "leaf.py").write_text("VALUE = 2\n")
        _bump(pkg / "leaf.py")
        assert "hotpkg_t.leaf" in w.poll()
        assert leaf.VALUE == 2                     # reloaded in place

    def test_watcher_survives_broken_edit(self, hot_package, caplog):
        pkg = hot_package("hotpkg_t2")
        leaf = importlib.import_module("hotpkg_t2.leaf")
        w = ModuleWatcher(package="hotpkg_t2")
        (pkg / "leaf.py").write_text("VALUE = (\n")     # syntax error
        _bump(pkg / "leaf.py")
        with caplog.at_level(logging.ERROR, logger="kajiya_tpu_torch"):
            assert w.poll() == []                  # logged, not reported
        assert "hot reload of hotpkg_t2.leaf failed" in caplog.text
        assert leaf.VALUE == 1                     # old code still live

    @pytest.fixture
    def kernel_tree(self, tmp_path, monkeypatch):
        """`_native` pointed at a copy of csrc/ with a stand-in loaded
        library; building and loading are recorded, not run."""
        from kajiya_tpu_torch.ops import _native

        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for name in _native.SOURCES:
            (csrc / name).write_text(open(os.path.join(_native.CSRC,
                                                       name)).read())
        builds = []

        def build():
            builds.append(sorted(os.listdir(csrc)))
            return str(tmp_path / f"lib{len(builds)}.so")

        monkeypatch.setattr(_native, "CSRC", str(csrc))
        monkeypatch.setattr(_native, "build_library", build)
        monkeypatch.setattr(_native, "_load",
                            lambda path: SimpleNamespace(_name=path))
        monkeypatch.setattr(_native, "_lib",
                            SimpleNamespace(_name=str(tmp_path / "lib0.so")))
        return _native, csrc, builds

    def test_kernel_edit_rebuilds_the_library(self, kernel_tree):
        _native, csrc, builds = kernel_tree
        w = ModuleWatcher()
        assert w.poll() == []
        with open(csrc / "warp.cu", "a") as f:
            f.write("// edited\n")
        _bump(csrc / "warp.cu")
        assert w.poll() == ["kajiya_tpu_torch.csrc.warp"]
        assert len(builds) == 1
        assert _native.library_path().endswith("lib1.so")
        assert w.poll() == []                      # nothing new

    def test_failed_kernel_build_keeps_the_loaded_kernels(self, kernel_tree,
                                                          monkeypatch,
                                                          caplog):
        _native, csrc, _ = kernel_tree
        w = ModuleWatcher()

        def fail():
            raise RuntimeError("nvcc failed:\nwarp.cu: error")

        monkeypatch.setattr(_native, "build_library", fail)
        _bump(csrc / "tileshift.cu")
        with caplog.at_level(logging.ERROR, logger="kajiya_tpu_torch"):
            assert w.poll() == []
        assert "loaded kernels keep running" in caplog.text
        assert _native.library_path().endswith("lib0.so")

    def test_kernel_edit_before_first_load_builds_nothing(self, kernel_tree,
                                                          monkeypatch):
        """No library loaded yet: the first kernel call builds the edited
        sources, so the watcher reports and builds nothing."""
        _native, csrc, builds = kernel_tree
        monkeypatch.setattr(_native, "_lib", None)
        w = ModuleWatcher()
        _bump(csrc / "woop.cu")
        assert w.poll() == [] and builds == []

    def test_reload_keeps_counts_library_and_constants(self, monkeypatch):
        """Reloading the stateful modules does not reset what a run reads:
        the launch counts, the loaded library, the constant cache."""
        from kajiya_tpu_torch import device
        from kajiya_tpu_torch.ops import _native

        sentinel = SimpleNamespace(_name="loaded.so")
        monkeypatch.setattr(_native, "_lib", sentinel)
        counts = _native.launches
        before = dict(counts)
        counts["warp"] += 5
        try:
            importlib.reload(_native)
            assert _native.launches is counts
            assert _native.launches["warp"] == before["warp"] + 5
            assert _native._lib is sentinel
            c = device.const_tensor((1.0, 2.0), "cpu")
            importlib.reload(device)
            assert device.const_tensor((1.0, 2.0), "cpu") is c
        finally:
            counts["warp"] = before["warp"]


def _small_cfg():
    from kajiya_tpu_torch.frame import RenderConfig

    return RenderConfig(width=32, height=24, max_trace_steps=64,
                        use_taa=False, use_motion_blur=False,
                        use_ircache=False, use_rtr=False)


def _view():
    from kajiya_tpu_torch.core.camera import make_view_constants

    return make_view_constants((0, 0, 2.4), (0, 0, -1), width=32, height=24,
                               device="cpu")


class TestRenderer:
    def test_rebuild_preserves_state_and_output(self):
        """FrameState carries over rebuild(): a run with a rebuild between
        frames equals an uninterrupted one, bit for bit."""
        from kajiya_tpu_torch.frame import Renderer
        from kajiya_tpu_torch.scene.procedural import cornell_box

        view = _view()
        r1 = Renderer(cornell_box(), _small_cfg(), device="cpu")
        r1.draw(view)
        r1.rebuild()
        a2 = r1.draw(view)
        r2 = Renderer(cornell_box(), _small_cfg(), device="cpu")
        r2.draw(view)
        b2 = r2.draw(view)
        assert torch.equal(a2["final"], b2["final"])

    def test_rebuild_picks_up_a_reloaded_frame_function(self, monkeypatch):
        """A reload refills the frame module's globals; a Renderer made
        before it draws with the fresh `render_frame`, before and after
        rebuild()."""
        from kajiya_tpu_torch import frame
        from kajiya_tpu_torch.scene.procedural import cornell_box

        r = frame.Renderer(cornell_box(), _small_cfg(), device="cpu")
        calls = []
        real = frame.render_frame

        def fresh(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(frame, "render_frame", fresh)
        r.draw(_view())
        assert calls == [1]
        r.rebuild()
        r.draw(_view())
        assert calls == [1, 1]

    def test_set_emissive_refreshes_the_trace_scene_once(self):
        from kajiya_tpu_torch.frame import Renderer
        from kajiya_tpu_torch.scene.procedural import cornell_box

        r = Renderer(cornell_box(), _small_cfg(), device="cpu")
        r.draw(_view())
        ts0 = r.ts
        e0 = ts0.light_emission.clone()
        assert (e0 > 0).any()
        r.set_emissive(r.ts.gpu.mat_emissive * 2.0)
        assert r.ts is ts0                 # refreshed at the next draw
        r.draw(_view())
        assert r.ts is not ts0
        assert torch.equal(r.ts.light_emission, e0 * 2.0)
        assert torch.equal(r.ts.tri_attrs[:, 14:17],
                           ts0.tri_attrs[:, 14:17] * 2.0)
        ts1 = r.ts
        r.draw(_view())
        assert r.ts is ts1                 # once


    def test_emissive_set_during_draws_is_not_lost(self, monkeypatch):
        """The live viewer's HTTP thread calls set_emissive while the render
        thread draws: after the last set and one more draw, the trace scene
        holds the last value (a lost update would leave an older one).
        The frame function is stubbed: only the refresh logic is raced."""
        import threading

        from kajiya_tpu_torch import frame
        from kajiya_tpu_torch.scene.procedural import cornell_box

        r = frame.Renderer(cornell_box(), _small_cfg(), device="cpu")
        monkeypatch.setattr(frame, "render_frame",
                            lambda ts, state, view, cfg, ibl_env: (state, {}))
        e0 = r.ts.gpu.mat_emissive.clone()
        light0 = r.ts.light_emission.clone()
        view = _view()
        stop = threading.Event()

        def drawing():
            while not stop.is_set():
                r.draw(view)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        t = threading.Thread(target=drawing)
        t.start()
        try:
            for k in range(1, 201):
                r.set_emissive(e0 * float(k))
        finally:
            stop.set()
            t.join(timeout=60)
            sys.setswitchinterval(old)
        assert not t.is_alive()
        r.draw(view)
        assert torch.equal(r.ts.light_emission, light0 * 200.0)


class TestDebugging:
    def test_check_finite_names_nan_planes(self):
        from kajiya_tpu.core.debugging import check_finite as check_j

        planes = {"good": np.ones((2, 3), np.float32),
                  "nan": np.array([1.0, np.nan], np.float32),
                  "inf": np.array([np.inf, 0.0], np.float32),
                  "ints": np.array([1, 2], np.int32)}
        st_t = {k: torch.as_tensor(v) for k, v in planes.items()}
        st_t["nested"] = {"x": torch.tensor([np.nan])}
        want = check_j({k: jnp.asarray(v) for k, v in planes.items()})
        assert debugging.check_finite(st_t) == want == ["nan", "inf"]
        with pytest.raises(FloatingPointError, match=r"after gi.*'nan'"):
            debugging.assert_finite(st_t, "gi")
        debugging.assert_finite({"good": st_t["good"]})

    @pytest.mark.parametrize("hook", [None, "missing", "ssao", "shadow",
                                      "four", "gbuffer", "mask", "big"])
    def test_debug_view_matches_jax(self, hook):
        from kajiya_tpu.core.debugging import debug_view as view_j

        rng = np.random.default_rng(3)
        outs = {"final": rng.uniform(0, 1, (8, 12, 3)).astype(np.float32),
                "ssao": rng.uniform(0, 2, (8, 12)).astype(np.float32),
                "shadow": np.zeros((8, 12), np.float32),
                "four": rng.uniform(-1, 30, (8, 12, 4)).astype(np.float32),
                "mask": rng.uniform(0, 1, (8, 12)) > 0.5}
        gb = {"albedo": rng.uniform(0, 1, (8, 12, 3)).astype(np.float32),
              "depth": rng.uniform(0, 1, (8, 12)).astype(np.float32)}
        if hook == "big":
            # above 2^24 elements once cut to 3 channels: torch.quantile's
            # limit; the rank is not a whole number
            outs["big"] = rng.exponential(1.0, (2400, 2401, 5)).astype(
                np.float32)
            assert 2400 * 2401 * 3 > 2 ** 24
        j = {k: jnp.asarray(v) for k, v in outs.items()}
        t = {k: torch.as_tensor(v) for k, v in outs.items()}
        j["gbuffer"] = {k: jnp.asarray(v) for k, v in gb.items()}
        t["gbuffer"] = {k: torch.as_tensor(v) for k, v in gb.items()}
        want = np.asarray(view_j(j, hook))
        got = debugging.debug_view(t, hook).numpy()
        assert want.shape == got.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    def test_percentile_matches_jax(self):
        """q = 99 (`debug_view`'s) within 1e-6 of `jnp.percentile`; other q
        within that plus the float32 rounding of the rank: JAX computes the
        rank and the weights inside a compiled function (a reciprocal for
        q / 100, products fused with the floor's difference), which the
        port follows for q / 100 only."""
        rng = np.random.default_rng(4)
        for n in (1, 2, 7, 1000, 12345, 70001):
            x = rng.normal(size=n).astype(np.float32)
            srt = np.sort(x)
            for q in (0.0, 1.0, 37.5, 50.0, 90.0, 99.0, 99.9, 100.0):
                want = float(jnp.percentile(jnp.asarray(x), q))
                got = float(debugging.percentile(torch.as_tensor(x), q))
                tol = 1e-6 * max(1.0, abs(want))
                if q != 99.0 and n > 1:
                    pos = q / 100.0 * (n - 1)
                    lo = min(int(pos), n - 2)
                    tol += (srt[lo + 1] - srt[lo]) * 4.0 * float(
                        np.spacing(np.float32(max(pos, 1.0))))
                assert abs(got - want) <= tol, (n, q, got, want)
        x = torch.tensor([1.0, float("nan"), 2.0])
        assert torch.isnan(debugging.percentile(x, 50.0))


class TestProfiling:
    def test_frame_timer(self):
        t = profiling.FrameTimer(window=4)
        assert t.dt == pytest.approx(1 / 60)
        for _ in range(6):
            t.tick()
        assert len(t.samples) == 4
        assert t.dt > 0 and t.fps > 0

    def test_pass_scope_and_timing(self):
        with profiling.pass_scope("test pass"):
            x = torch.ones((8, 8)) * 2
        calls = []

        def f(a):
            calls.append(1)
            return {"y": (a * 3,)}

        ms = profiling.time_wall_ms(f, x, iters=3, warmup=1)
        assert ms >= 0.0 and len(calls) == 4

    def test_trace_writes_chrome_trace(self, tmp_path):
        profiling.start_trace(str(tmp_path / "tr"))
        with pytest.raises(RuntimeError, match="already"):
            profiling.start_trace(str(tmp_path / "tr"))
        with profiling.pass_scope("traced_pass"):
            torch.ones((16, 16)).sum()
        path = profiling.stop_trace()
        assert os.path.dirname(path) == str(tmp_path / "tr")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "traced_pass" for e in events)
        with pytest.raises(RuntimeError, match="no trace"):
            profiling.stop_trace()


def test_set_up_logging(tmp_path):
    from kajiya_tpu_torch.core.logging import set_up_logging

    logger = logging.getLogger("kajiya_tpu_torch")
    saved = logger.handlers[:], logger.level
    logger.handlers = []
    try:
        log_file = tmp_path / "output.log"
        lg = set_up_logging(str(log_file))
        assert lg is logger and len(lg.handlers) == 2
        assert set_up_logging(str(log_file)) is lg and len(lg.handlers) == 2
        lg.debug("to the file only")
        for h in lg.handlers:
            h.flush()
        assert "to the file only" in log_file.read_text()
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers, _ = saved
        logger.setLevel(saved[1])


def test_keymap(tmp_path):
    from kajiya_tpu.apps.keymap import load_keymap as load_j
    from kajiya_tpu_torch.apps.keymap import DEFAULT_KEYMAP, load_keymap

    assert load_keymap() == load_j() == DEFAULT_KEYMAP
    p = tmp_path / "keymap.toml"
    p.write_text('[bindings]\nmove_forward = "up"\nboost = "alt"\n'
                 'weird = 3\n')
    km = load_keymap(str(p))
    assert km == load_j(str(p))
    assert km["move_forward"] == "up" and km["boost"] == "alt"
    assert km["move_left"] == "a" and "weird" not in km
    p.write_text('look = "mouse_middle"\n')            # no [bindings] table
    assert load_keymap(str(p))["look"] == "mouse_middle"


def test_persisted_state_round_trip(tmp_path):
    from kajiya_tpu.apps.persisted import PersistedState as StateJ
    from kajiya_tpu_torch.apps.persisted import PersistedState

    path = str(tmp_path / "view_state.json")
    assert PersistedState.load(path) == PersistedState()      # no file yet
    st = PersistedState(camera_position=[1.0, 2.0, 3.0], ev_shift=-1.5,
                        sequence={"keys": [1, 2]})
    st.save(path)
    assert PersistedState.load(path) == st
    assert StateJ.load(path).__dict__ == st.__dict__          # same file
    with open(path) as f:
        d = json.load(f)
    d["unknown_key"] = 1
    with open(path, "w") as f:
        json.dump(d, f)
    assert PersistedState.load(path) == st


def test_hello_writes_png(tmp_path, monkeypatch):
    """hello.main at a small size on the CPU writes out/hello.png."""
    from kajiya_tpu_torch.apps import hello
    from kajiya_tpu_torch.apps.view import read_png_header

    monkeypatch.setattr(hello, "WIDTH", 32)
    monkeypatch.setattr(hello, "HEIGHT", 24)
    monkeypatch.setattr(hello, "FRAMES", 2)
    monkeypatch.chdir(tmp_path)
    hello.main(["--device", "cpu"])
    assert read_png_header(str(tmp_path / "out" / "hello.png")) == \
        (32, 24, 8, 2)
