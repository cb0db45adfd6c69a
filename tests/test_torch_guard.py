"""Guards for the PyTorch port: it imports neither JAX nor the JAX package,
its entry points refuse to slip onto the CPU without being asked, and its
kernel wrappers never answer a CUDA request with the plain version."""
import ast
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from kajiya_tpu_torch import convert
from kajiya_tpu_torch.core import camera
from kajiya_tpu_torch.frame import RenderConfig, Renderer
from kajiya_tpu_torch.ops import (_native, tileshift_cuda, warp_cuda,
                                  woop_cuda)
from kajiya_tpu_torch.rt import bvh, trace
from kajiya_tpu_torch.scene import procedural, scene
from kajiya_tpu_torch import world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = dict(width=64, height=48, use_rtdgi=False, use_rtr=False,
             use_ssao=False, use_taa=False, use_ircache=False,
             use_motion_blur=False)


def _port_files():
    pkg = os.path.join(ROOT, "kajiya_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 20
    names = {os.path.relpath(f, ROOT) for f in files}
    for new in ("ops/raysort.py", "ops/reservoir.py", "ops/tileshift_cuda.py",
                "renderers/lights.py", "renderers/hit_lighting.py",
                "renderers/ssgi.py", "renderers/rtdgi.py",
                "renderers/restir_gi.py", "ops/scan.py",
                "renderers/ircache.py", "renderers/lighting.py",
                "renderers/rtr.py", "renderers/taa.py",
                "renderers/motion_blur.py", "renderers/reference.py",
                "renderers/wrc.py", "renderers/dof.py", "sky/ibl.py",
                "core/checkpoint.py", "apps/view.py", "apps/camera_rig.py",
                "apps/sequence.py", "scene/png.py", "scene/textures.py",
                "scene/ron.py", "scene/gltf.py", "scene/cache.py",
                "scene/assets.py", "apps/bake.py", "rt/bvh.py",
                "rt/trace.py", "ops/bvh_cuda.py", "apps/stream.py",
                "apps/hello.py", "apps/keymap.py", "apps/persisted.py",
                "core/reload.py", "core/debugging.py", "core/logging.py",
                "scene/jpeg.py", "hostlib.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/comm.py", "parallel/launch.py",
                "scene/raster.py", "scene/bmp.py", "scene/ico.py",
                "scene/tga.py", "scene/gif.py", "scene/webp.py",
                "scene/tiff.py", "scene/pcx.py", "scene/ppm.py",
                "scene/sgi.py", "scene/qoi.py", "scene/psd.py",
                "scene/blp.py", "scene/ftex.py", "scene/lab.py",
                "scene/icns.py", "scene/gbr.py", "scene/iptc.py",
                "scene/xbm.py", "scene/xpm.py", "scene/sun.py",
                "scene/msp.py", "scene/xvthumb.py", "scene/imt.py",
                "scene/pixar.py"):
        assert os.path.join("kajiya_tpu_torch", new) in names, new
    assert "chip_smoke.py" in names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            # no PIL either: the card's machine has none
            assert top not in ("jax", "jaxlib", "kajiya_tpu", "PIL"), (
                path, mod)


def _cuda_present():
    return torch.cuda.is_available()


@pytest.mark.parametrize("entry", ["make_view_constants", "build_gpu_scene",
                                   "build_trace_scene", "Renderer",
                                   "init_frame_state", "convert"])
def test_entry_points_raise_without_cuda(entry):
    if _cuda_present():
        pytest.skip("a CUDA device is present: the default device is valid")
    sc = procedural.cornell_box()
    calls = {
        "make_view_constants": lambda: camera.make_view_constants(
            (0, 0, 2.4), (0, 0, -1)),
        "build_gpu_scene": lambda: scene.build_gpu_scene(sc),
        "build_trace_scene": lambda: world.build_trace_scene(
            scene.build_gpu_scene(sc, device="cpu")),
        "Renderer": lambda: Renderer(sc, RenderConfig(**SLICE)),
        "init_frame_state": lambda: __import__(
            "kajiya_tpu_torch.frame", fromlist=["x"]).init_frame_state(
                RenderConfig(**SLICE)),
        "convert": lambda: convert.frame_state_from_numpy({}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    # and the same call runs when the CPU is asked for explicitly
    if entry == "make_view_constants":
        camera.make_view_constants((0, 0, 2.4), (0, 0, -1), device="cpu")
    if entry == "Renderer":
        Renderer(sc, RenderConfig(**SLICE), device="cpu")


def _fail_plain(*_a, **_k):
    raise AssertionError("plain version called for a CUDA request")


def test_native_sources_name_every_kernel_file():
    """Every .cu under csrc/ is built, every built kernel has a launch
    counter and a C signature."""
    on_disk = sorted(n for n in os.listdir(_native.CSRC) if n.endswith(".cu"))
    assert sorted(_native.SOURCES) == on_disk
    assert set(_native.launches) == {"woop_brute", "woop_culled", "warp",
                                     "tile_shift", "bvh_walk"}
    assert set(_native._SIGNATURES) == {"kt_woop_brute", "kt_woop_culled",
                                        "kt_warp", "kt_tile_shift",
                                        "kt_bvh_walk"}
    for name in _native._SIGNATURES:
        assert any(name in open(os.path.join(_native.CSRC, f)).read()
                   for f in on_disk), name


def test_host_sources_built_only_by_their_builder():
    """The host C++ sources under csrc/ (compiled with g++, not nvcc) are
    each named as a path by one module only, the one that builds it: the
    BVH builder by rt/bvh.py, the JPEG encoder and decoder by
    scene/jpeg.py, the BCn block decoder by scene/dds.py, the RLE / LZW /
    PackBits / QOI / DXT loops by scene/raster.py, the WebP decoder by
    scene/webp.py, the TIFF codecs and the zstd decoder by
    scene/tiff.py, the LAB transform by scene/lab.py."""
    builders = {"bvh_builder.cpp": "rt/bvh.py",
                "jpeg_encoder.cpp": "scene/jpeg.py",
                "jpeg_decoder.cpp": "scene/jpeg.py",
                "bcn_decoder.cpp": "scene/dds.py",
                "raster_decoder.cpp": "scene/raster.py",
                "webp_decoder.cpp": "scene/webp.py",
                "tiff_decoder.cpp": "scene/tiff.py",
                "zstd_decoder.cpp": "scene/tiff.py",
                "lab_transform.cpp": "scene/lab.py"}
    on_disk = sorted(n for n in os.listdir(_native.CSRC)
                     if not n.endswith(".cu"))
    assert on_disk == sorted(builders)
    for path in _port_files():
        tree = ast.parse(open(path).read(), filename=path)
        named = {n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and n.value in builders}
        rel = os.path.relpath(path, os.path.join(ROOT, "kajiya_tpu_torch"))
        for src in named:
            assert builders[src] == rel, (src, rel)
    from kajiya_tpu_torch.scene import dds, jpeg, raster, tiff, webp

    assert jpeg.ENCODER_SOURCE == os.path.join(_native.CSRC,
                                               "jpeg_encoder.cpp")
    assert raster.SOURCE == os.path.join(_native.CSRC, "raster_decoder.cpp")
    assert webp.SOURCE == os.path.join(_native.CSRC, "webp_decoder.cpp")
    assert tiff.SOURCE == os.path.join(_native.CSRC, "tiff_decoder.cpp")
    assert tiff.ZSTD_SOURCE == os.path.join(_native.CSRC, "zstd_decoder.cpp")
    assert jpeg.DECODER_SOURCE == os.path.join(_native.CSRC,
                                               "jpeg_decoder.cpp")
    assert dds.BCN_SOURCE == os.path.join(_native.CSRC, "bcn_decoder.cpp")
    assert (jpeg.BUILD_DIR == _native.BUILD_DIR == bvh.BUILD_DIR
            == dds.BUILD_DIR == raster.BUILD_DIR == webp.BUILD_DIR)


@pytest.mark.parametrize("kernel", ["brute", "culled", "warp", "tile_shift",
                                    "bvh_closest", "bvh_shadow",
                                    "bvh_ordered"])
def test_kernel_wrappers_raise_on_cuda_request(kernel, monkeypatch):
    """CUDA-typed tensors (fake tensors: no card here) must go to the
    kernel path and raise, never to the plain version."""
    if _cuda_present():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(woop_cuda, "brute_plain", _fail_plain)
    monkeypatch.setattr(woop_cuda, "culled_plain", _fail_plain)
    monkeypatch.setattr(warp_cuda, "warp_plain", _fail_plain)
    monkeypatch.setattr(tileshift_cuda, "tile_shift_plain", _fail_plain)
    monkeypatch.setattr(trace, "walk_plain", _fail_plain)
    monkeypatch.setattr(trace, "walk_ordered_plain", _fail_plain)
    with FakeTensorMode():
        dev = torch.device("cuda")
        org = torch.zeros((512, 3), device=dev)
        d = torch.ones((512, 3), device=dev)
        woop = {"a_o": torch.zeros((3 * 256, 4), device=dev),
                "a_d": torch.zeros((3 * 256, 3), device=dev)}
        if kernel == "culled":
            woop.update(cmin=torch.zeros((1, 3), device=dev),
                        cmax=torch.zeros((1, 3), device=dev),
                        cmin64=torch.zeros((2, 3), device=dev),
                        cmax64=torch.zeros((2, 3), device=dev))
        with pytest.raises(RuntimeError, match="CUDA"):
            if kernel == "warp":
                warp_cuda.warp2d(torch.zeros((48, 64, 3), device=dev),
                                 torch.zeros((48, 64, 2), device=dev))
            elif kernel == "tile_shift":
                off = torch.zeros((6,), dtype=torch.int32, device=dev)
                tileshift_cuda.tile_shift(
                    torch.zeros((48, 64, 20), device=dev), off, off)
            elif kernel.startswith("bvh"):
                i32 = dict(dtype=torch.int32, device=dev)
                b = bvh.Bvh(torch.zeros((3, 3), device=dev),
                            torch.ones((3, 3), device=dev),
                            torch.zeros((3,), **i32), torch.ones((3,), **i32),
                            torch.full((3,), 3, **i32),
                            torch.zeros((4,), **i32))
                tris = tuple(torch.zeros((1, 3), device=dev)
                             for _ in range(3))
                if kernel == "bvh_ordered":     # the front-to-back walk
                    trace.trace_closest(b, tris, org, d)
                else:
                    fn = (trace.trace_closest if kernel == "bvh_closest"
                          else trace.trace_shadow)
                    fn(b, tris, org, d, max_steps=8)
            else:
                woop_cuda.intersect_scene(woop, org, d)


@pytest.mark.parametrize("entry", ["band_warp", "band_tile_shift"])
def test_band_entry_points_raise_on_cuda_request(entry, monkeypatch):
    """The sharded frame's band helpers (a temporal fetch from a gathered
    source; kernel S on a band's halo window) hand CUDA tensors to the
    kernels, never to the plain versions (fake tensors: no card here)."""
    if _cuda_present():
        pytest.skip("a CUDA device is present")
    from kajiya_tpu_torch.parallel.comm import Band, Comm
    from kajiya_tpu_torch.renderers import reprojection, restir_gi

    monkeypatch.setattr(warp_cuda, "warp_plain", _fail_plain)
    monkeypatch.setattr(tileshift_cuda, "tile_shift_plain", _fail_plain)
    with FakeTensorMode():
        dev = torch.device("cuda")
        band = Band(Comm((0,), 0, "none", dev), ((0, 48),), 48, 64)
        with pytest.raises(RuntimeError, match="CUDA"):
            if entry == "band_warp":
                reprojection.reproject_planes(
                    {"h": torch.zeros((48, 64, 3), device=dev)},
                    {"prev_uv": torch.zeros((48, 64, 2), device=dev),
                     "validity": torch.zeros((48, 64), device=dev)}, band)
            else:
                # (indexing a fake CUDA tensor needs a CUDA build: one
                # tap's offsets are made apart)
                off = torch.zeros((2, 3), dtype=torch.int32, device=dev)
                win, _above, _dy, _dx = restir_gi._tile_window(
                    torch.zeros((24, 32, 20), device=dev), off, off,
                    band.half(), 12)
                tap = torch.zeros((3,), dtype=torch.int32, device=dev)
                tileshift_cuda.tile_shift(win, tap, tap)


def test_only_the_route_aware_modules_read_woop():
    """On the BVH route `ts.woop` is None: only the modules that branch on
    it (the dispatch, the raster primaries, the traced g-buffer, the sun
    shadows) and those that build or carry it read it; every other pass
    traces through `scene_trace_closest` / `scene_trace_shadow`."""
    readers = set()
    for path in _port_files():
        if path.endswith("chip_smoke.py"):
            continue
        tree = ast.parse(open(path).read(), filename=path)
        if any(isinstance(n, ast.Attribute) and n.attr == "woop"
               for n in ast.walk(tree)):
            readers.add(os.path.relpath(path, os.path.join(ROOT,
                                                           "kajiya_tpu_torch")))
    assert readers == {"rt/trace.py", "renderers/raster.py",
                       "renderers/gbuffer.py", "renderers/shadows.py"}
