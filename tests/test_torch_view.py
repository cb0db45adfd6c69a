"""The port's view-app layer: the numpy-only sequencer, sun controller and
camera rig (copies of `kajiya_tpu/apps/`, held to
`tests/test_view_layer.py`'s expectations and to the JAX package's own
classes), the PNG writer, and `python -m kajiya_tpu_torch.apps.view` on the
CPU at 32x24 in both modes."""
import struct
import zlib

import numpy as np
import pytest

from kajiya_tpu.apps.camera_rig import CameraRig as CameraRigJ
from kajiya_tpu.apps.sequence import Sequence as SequenceJ
from kajiya_tpu_torch.apps import view as view_app
from kajiya_tpu_torch.apps.camera_rig import CameraRig
from kajiya_tpu_torch.apps.sequence import Sequence, SunController


def test_sequence_interpolates_through_keys():
    s = (Sequence()
         .add(0.0, (0, 0, 0), (0, 0, -1))
         .add(1.0, (1, 0, 0), (0, 0, -1))
         .add(2.0, (1, 1, 0), (1, 0, 0)))
    assert np.allclose(s.sample(0.0).cam_pos, (0, 0, 0))
    assert np.allclose(s.sample(2.0).cam_pos, (1, 1, 0))
    mid = s.sample(0.5)
    assert 0.0 < mid.cam_pos[0] < 1.0
    assert abs(np.linalg.norm(mid.cam_dir) - 1.0) < 1e-5
    ref = (SequenceJ().add(0.0, (0, 0, 0), (0, 0, -1))
           .add(1.0, (1, 0, 0), (0, 0, -1)).add(2.0, (1, 1, 0), (1, 0, 0)))
    for t in (0.3, 1.2, 1.9):
        np.testing.assert_array_equal(s.sample(t).cam_pos,
                                      ref.sample(t).cam_pos)


def test_sequence_roundtrip_dict():
    s = Sequence().add(0, (0, 0, 0), (0, 0, -1), (0, 1, 0)).add(
        1, (1, 0, 0), (0, 0, -1), (1, 1, 0))
    s2 = Sequence.from_dict(s.to_dict())
    assert np.allclose(s2.sample(0.7).cam_pos, s.sample(0.7).cam_pos)
    assert np.allclose(s2.sample(0.7).sun_dir, s.sample(0.7).sun_dir)


def test_sun_controller():
    c = SunController()
    d0 = c.direction.copy()
    d1 = c.rotate(0.3, 0.1)
    assert abs(np.linalg.norm(d1) - 1.0) < 1e-5
    assert not np.allclose(d0, d1)
    for _ in range(100):
        c.rotate(0.0, 0.3)
    assert c.direction[1] < 1.0


def test_camera_rig_smooth_approach_and_pitch_clamp():
    rig, ref = CameraRig(position=(0, 0, 0)), CameraRigJ(position=(0, 0, 0))
    rig.translate(0, 0, -5.0)
    ref.translate(0, 0, -5.0)
    for _ in range(100):
        pos, fwd = rig.update(1 / 60)
        pos_j, fwd_j = ref.update(1 / 60)
    assert np.allclose(pos, rig.target_pos, atol=1e-2)
    assert abs(np.linalg.norm(fwd) - 1.0) < 1e-5
    np.testing.assert_array_equal(pos, pos_j)
    rig.look(0.0, 10.0)
    assert rig.target_pitch < np.pi / 2


def _decode_rgb_png(path):
    """(H, W, 3) uint8 from an 8-bit RGB PNG of unfiltered rows (what
    save_png writes)."""
    data = open(path, "rb").read()
    w, h, depth, color = view_app.read_png_header(path)
    assert (depth, color) == (8, 2)
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + chunk) & 0xFFFFFFFF == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0]
        if kind == b"IDAT":
            idat += chunk
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_save_png(tmp_path):
    """save_png writes clip(img, 0, 1) * 255, truncated, as 8-bit RGB; the
    header reader gives its size and refuses a file that is not a PNG."""
    img = np.random.default_rng(1).uniform(-0.2, 1.2, (5, 7, 3))
    p = str(tmp_path / "sub" / "x.png")
    view_app.save_png(p, img)
    assert view_app.read_png_header(p) == (7, 5, 8, 2)
    np.testing.assert_array_equal(
        _decode_rgb_png(p), (np.clip(img.astype(np.float32), 0, 1) * 255
                             ).astype(np.uint8))
    q = tmp_path / "y.png"
    q.write_bytes(b"GIF89a" + b"\0" * 40)
    with pytest.raises(ValueError):
        view_app.read_png_header(str(q))


@pytest.mark.parametrize("mode", ["standard", "reference"])
def test_view_main_on_cpu(tmp_path, mode):
    out = tmp_path / f"{mode}.png"
    view_app.main(["--device", "cpu", "--width", "32", "--height", "24",
                   "--mode", mode, "--frames", "2", "--spp", "2",
                   "--dump-every", "1", "-o", str(out)])
    assert view_app.read_png_header(str(out))[:2] == (32, 24)
    img = _decode_rgb_png(str(out))
    assert img.max() > 8                       # not a black frame
    assert (tmp_path / f"{mode}_0001.png").exists()


def test_view_animated_on_cpu(tmp_path):
    out = tmp_path / "anim.png"
    view_app.main(["--device", "cpu", "--width", "32", "--height", "24",
                   "--animate", "3", "-o", str(out)])
    assert _decode_rgb_png(str(out)).max() > 8


def _scene_with_texture(tmp_path, name, head):
    """`name` (a .ron scene or a .gltf mesh) of one textured quad whose
    base colour image starts with the bytes `head`."""
    from kajiya_tpu_torch.scene.assets import write_gltf

    mdir = tmp_path / "assets" / "meshes"
    mdir.mkdir(parents=True)
    (mdir / "tex.img").write_bytes(head + b"\0" * 64)
    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32)
    write_gltf(str(mdir / "quad.gltf"), quad,
               np.tile(np.float32([0, 1, 0]), (4, 1)), quad[:, [0, 2]],
               np.array([[0, 2, 1], [0, 3, 2]], np.uint32),
               dict(base_color=(1, 1, 1, 1), metallic=0.0, roughness=0.5,
                    base_color_texture=0), ["tex.img"])
    if name.endswith(".gltf"):
        return str(mdir / "quad.gltf")
    sdir = tmp_path / "assets" / "scenes"
    sdir.mkdir()
    (sdir / name).write_text(
        '(instances: [(mesh: "/meshes/quad.gltf", position: (0, -1, 0))])')
    return str(sdir / name)


@pytest.mark.parametrize("argv", [["--scene", "scene.ron"],
                                  ["--scene", "mesh.gltf"],
                                  ["--scene", "anim.gltf"]])
def test_view_refuses_unported_inputs(tmp_path, argv):
    """What the viewer refuses, and what it bakes white as JAX does: a .ron
    scene whose texture is a JPEG head followed by zeros and a .gltf whose
    texture is such a DDS head are corrupt files PIL refuses too, so they
    render with a white texture; a .gltf whose texture is an AVIF file PIL
    writes (a format PIL opens and the port cannot decode yet; a PGM, then
    a Sun raster, then a FITS file, then a JPEG 2000 codestream, until the
    port decoded them) raises rather than turn white.
    (`--watch`, refused here until hot reload was ported, is
    test_view_watch_reloads.)"""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)).save(
        buf, "AVIF")
    avif = buf.getvalue()
    head = {"scene.ron": b"\xff\xd8\xff\xe0", "mesh.gltf": b"DDS ",
            "anim.gltf": avif}[argv[1]]
    out = tmp_path / "x.png"
    argv = ["--scene", _scene_with_texture(tmp_path, argv[1], head)]
    run = argv + ["--device", "cpu", "--width", "8", "--height", "8", "-o",
                  str(out)]
    if head == avif:
        Image.open(io.BytesIO(head + b"\0" * 64)).convert("RGBA")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            view_app.main(run)
        return
    with pytest.raises(Exception):
        Image.open(io.BytesIO(head + b"\0" * 64)).convert("RGBA")
    view_app.main(run)
    assert view_app.read_png_header(str(out))[:2] == (8, 8)


@pytest.mark.parametrize("name", ["scene.ron", "mesh.gltf"])
def test_view_renders_textured_assets(tmp_path, monkeypatch, name):
    """A textured .ron scene and a .gltf mesh (through the bake cache)
    render through the viewer on the CPU."""
    from kajiya_tpu_torch.scene import cache
    from kajiya_tpu_torch.scene.png import encode_png

    monkeypatch.setattr(cache, "CACHE_DIR", str(tmp_path / "cache"))
    img = np.zeros((16, 16, 3), np.uint8)
    img[::2] = (255, 120, 20)
    path = _scene_with_texture(tmp_path, name, b"")
    (tmp_path / "assets" / "meshes" / "tex.img").write_bytes(
        encode_png(img, filters=(1, 4)))
    out = tmp_path / "t.png"
    view_app.main(["--scene", path, "--device", "cpu", "--width", "32",
                   "--height", "24", "--frames", "1", "--camera", "0", "1.5",
                   "2.5", "0", "-0.6", "-1", "-o", str(out)])
    px = _decode_rgb_png(str(out))
    assert px.max() > 8
    if name == "mesh.gltf":
        assert len(list((tmp_path / "cache").glob("*.mesh.npz"))) == 1


def test_view_watch_reloads(tmp_path, monkeypatch):
    """--watch polls a ModuleWatcher before every frame and rebuilds the
    renderer's frame when it reports a reload."""
    from kajiya_tpu_torch.core import reload
    from kajiya_tpu_torch.frame import Renderer

    polls, rebuilds = [], []

    class Watcher:
        def __init__(self, package="kajiya_tpu_torch"):
            assert package == "kajiya_tpu_torch"

        def poll(self):
            polls.append(1)
            return ["kajiya_tpu_torch.renderers.ssgi"] if len(polls) == 2 \
                else []

    real_rebuild = Renderer.rebuild

    def rebuild(self):
        rebuilds.append(1)
        real_rebuild(self)

    monkeypatch.setattr(reload, "ModuleWatcher", Watcher)
    monkeypatch.setattr(Renderer, "rebuild", rebuild)
    out = tmp_path / "w.png"
    view_app.main(["--watch", "--device", "cpu", "--width", "32",
                   "--height", "24", "--frames", "3", "--rtx-off", "-o",
                   str(out)])
    assert len(polls) == 3
    assert len(rebuilds) == 1          # after the reload the poll reported
    assert view_app.read_png_header(str(out)) == (32, 24, 8, 2)
