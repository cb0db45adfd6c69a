"""Write the WebP fixtures under tests/data/webp/ and their manifest.

Four small files, made from a numpy seed and encoded by PIL (libwebp):
lossy (VP8), lossy with alpha (VP8X + ALPH), lossless (VP8L: a few-colour
half and a smooth half) and an animation of three lossy frames.
`manifest.json` holds each file's shape and the SHA-256 of the RGBA that
PIL's `Image.open(f).convert("RGBA")` gives. `chip_smoke.py` decodes the
files with the port on a machine that has no PIL and holds them to these
digests; `tests/test_torch_webp.py` checks that the manifest still matches
PIL and the port.

    python tools/make_webp_fixtures.py        # needs PIL with WebP
"""
import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "webp")


def picture(rng, h, w, alpha=False):
    """Gradients, discs and noise: smooth areas and edges for the lossy
    coder, transparent holes for the alpha plane."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 255, y / h * 255, (x + y) / (w + h) * 255], -1)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 60)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 18, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if not alpha:
        return img
    a = np.clip(255 * np.sin(x / 17.0) * np.cos(y / 23.0) + 128, 0, 255)
    a[(y // 32 + x // 32) % 5 == 0] = 0
    return np.concatenate([img, a.astype(np.uint8)[..., None]], -1)


def main():
    rng = np.random.default_rng(2024)
    os.makedirs(OUT, exist_ok=True)
    files = {}
    buf = io.BytesIO()
    Image.fromarray(picture(rng, 256, 384)).save(buf, "WEBP", quality=75,
                                                 method=4)
    files["lossy.webp"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(picture(rng, 192, 256, alpha=True), "RGBA").save(
        buf, "WEBP", quality=60, alpha_quality=80, method=4)
    files["lossy_alpha.webp"] = buf.getvalue()
    pal = rng.integers(0, 256, (11, 4), np.uint8)
    pal[:, 3] = np.where(np.arange(11) % 3 == 0, 0, 255)
    idx = (np.add.outer(np.arange(200) // 20, np.arange(256) // 24)) % 11
    lossless = pal[idx]
    # the right half a smooth picture: predictors and colour transforms
    lossless[:, 128:] = picture(rng, 200, 128, alpha=True)
    buf = io.BytesIO()
    Image.fromarray(lossless, "RGBA").save(buf, "WEBP", lossless=True,
                                           method=6)
    files["lossless.webp"] = buf.getvalue()
    frames = [Image.fromarray(picture(rng, 120, 160)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=50)
    files["animated.webp"] = buf.getvalue()
    manifest = {}
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        manifest[name] = {"shape": list(rgba.shape), "bytes": len(data),
                          "rgba_sha256": hashlib.sha256(
                              rgba.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
