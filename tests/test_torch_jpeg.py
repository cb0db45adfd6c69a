"""The port's baseline JPEG encoder (`scene/jpeg.py`, `csrc/jpeg_encoder.cpp`,
the live viewer's MJPEG parts) against PIL's quality-85 encoder, which the
JAX package's viewer uses. PIL is the oracle here only; the port does not
import it.

Bounds: PIL decodes the port's stream as RGB of the right size; its PSNR
against the source is within 0.3 dB of PIL's own quality-85 encode of the
same image, and its size within +-10% of PIL's. The quantisation and
Huffman tables must be PIL's byte for byte. Images: seeded numpy images at
1920x1080 and 37x23 (odd sizes pad the MCU) and a 64x48 cornell frame
rendered by the port."""
import io

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import jpeg

PSNR_SLACK_DB = 0.3
SIZE_RATIO = (0.9, 1.1)


def _pil_jpeg(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85)
    return buf.getvalue()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _segments(data):
    """(marker, payload) of every marker segment before the scan."""
    out, i = [], 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out.append((data[i + 1], data[i + 4:i + 2 + n]))
        i += 2 + n
    return out


def _seeded(h, w, seed):
    """A smooth gradient field with seeded noise on top: the detail of a
    rendered frame, not white noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(xx / 17.0 + yy / 31.0),
                     128 + 90 * np.cos(xx / 7.0 - yy / 13.0),
                     128 + 60 * np.sin((xx + yy) / 23.0)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


def _cornell_frame():
    from kajiya_tpu_torch.core.camera import make_view_constants
    from kajiya_tpu_torch.frame import RenderConfig, Renderer
    from kajiya_tpu_torch.renderers.ircache import IrcacheConfig
    from kajiya_tpu_torch.scene.procedural import cornell_box

    cfg = RenderConfig(width=64, height=48, ircache=IrcacheConfig(
        max_entries=4096, active_budget=1024))
    r = Renderer(cornell_box(), cfg, device="cpu")
    out = r.draw(make_view_constants((0.0, 0.0, 2.4), (0.0, 0.0, -1.0),
                                     fov_y_deg=55.0, width=64, height=48,
                                     device="cpu"))
    f = out["final"].numpy()
    return (np.clip(f, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("case", ["seeded_1080p", "seeded_37x23",
                                  "cornell_64x48"])
def test_against_pil(case):
    img = {"seeded_1080p": lambda: _seeded(1080, 1920, 0),
           "seeded_37x23": lambda: _seeded(23, 37, 1),
           "cornell_64x48": _cornell_frame}[case]()
    h, w = img.shape[:2]
    ours = jpeg.encode_jpeg(img)
    ref = _pil_jpeg(img)
    dec = Image.open(io.BytesIO(ours))
    assert dec.format == "JPEG" and dec.mode == "RGB"
    assert dec.size == (w, h)
    assert jpeg.read_jpeg_header(ours) == (w, h, 3)
    ours_px = np.asarray(dec)
    ref_px = np.asarray(Image.open(io.BytesIO(ref)))
    p_ours, p_ref = _psnr(img, ours_px), _psnr(img, ref_px)
    assert abs(p_ours - p_ref) <= PSNR_SLACK_DB, (p_ours, p_ref)
    ratio = len(ours) / len(ref)
    assert SIZE_RATIO[0] <= ratio <= SIZE_RATIO[1], (len(ours), len(ref))
    # PIL's quantisation (DQT) and Huffman (DHT) tables, its frame (SOF0)
    mine = [s for s in _segments(ours) if s[0] in (0xDB, 0xC4, 0xC0)]
    theirs = [s for s in _segments(ref) if s[0] in (0xDB, 0xC4, 0xC0)]
    assert mine == theirs


def test_header_and_refusals():
    img = _seeded(16, 16, 2)
    data = jpeg.encode_jpeg(img)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    with pytest.raises(ValueError, match="SOI"):
        jpeg.read_jpeg_header(b"\x89PNG")
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(img.astype(np.float32))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(img[..., :2].copy())
    # a strided view encodes as its copy does
    view = _seeded(20, 40, 3)[2:18, 4:36]
    assert jpeg.encode_jpeg(view) == jpeg.encode_jpeg(view.copy())


def test_failed_build_raises(monkeypatch, tmp_path):
    """No encoder in Python to fall back to: a compiler that fails makes
    `encode_jpeg` raise with its output."""
    monkeypatch.setattr(jpeg, "_encoder", None)
    monkeypatch.setattr(jpeg, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(jpeg, "CXX", "false")
    with pytest.raises(RuntimeError, match="could not be built"):
        jpeg.encode_jpeg(_seeded(8, 8, 4))
