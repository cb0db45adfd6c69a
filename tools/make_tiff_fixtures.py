"""Write the TIFF fixtures under tests/data/tiff/ and their manifest.

Seventeen small files, made from a numpy seed with the writer of
`tests/test_torch_tiff.py` (PIL's own writer blocks tiles and planar
files) and, for LAB, with PIL: JPEG-in-TIFF YCbCr 2x2 in strips with a
JPEGTables tag, LZMA RGB with horizontal differencing, 32-bit floats with
the floating-point predictor, LZW CMYK, LAB, a little-endian BigTIFF
(deflate RGBA) and big-endian 16-bit RGB in 16 x 16 LZW tiles; then the
later codecs: PIL's CCITT Group 3 (1D, and 2D with fill bits), Group 4 and
RLE bilevel files and its zstd RGB with differencing, and the port's
writer's RLEW, ThunderScan, old-style JPEG (4:2:0 in the interchange form
in strips, 4:4:4 in the tables form) and SGILog files.
`manifest.json` holds each file's shape and the SHA-256 of the RGBA that
PIL's `Image.open(f).convert("RGBA")` gives; one PIL fails to load
(SGILog under an RGB photometric) is marked "white".
`chip_smoke.py` decodes the files with the port on a machine that has no
PIL and holds them to these digests; `tests/test_torch_tiff.py` checks
that the manifest still matches PIL and the port.

    python tools/make_tiff_fixtures.py        # needs PIL with libtiff
"""
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "tiff")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from kajiya_tpu_torch.scene import tiff  # noqa: E402
from test_torch_tiff import _jpeg_tiff, _tiff  # noqa: E402
from test_torch_tiff_codecs import ojpeg_tiff  # noqa: E402


def picture(rng, h, w, c=3):
    """Gradients and discs with noise, in c channels."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 255, y / h * 255, (x + y) / (w + h) * 255,
                    255 - x / w * 255][:c], -1)
    for _ in range(8):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(4, 20)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, c)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def bilevel(rng, h, w):
    """Discs on a noisy ground, 0 / 1."""
    return (picture(rng, h, w, 1)[..., 0] > 128).astype(np.uint8)


def codec_files(rng) -> dict:
    """The later codecs: PIL's CCITT and zstd files (libtiff's encoders),
    and the port's writer where PIL cannot write the file (RLEW,
    ThunderScan, old-style JPEG, SGILog)."""
    out = {}
    mask = Image.fromarray(bilevel(rng, 120, 160).astype(bool))
    for name, comp, info in (("g3_1d.tif", "group3", {}),
                             ("g3_2d.tif", "group3", {292: 5}),
                             ("g4.tif", "group4", {}),
                             ("rle.tif", "tiff_ccitt", {})):
        buf = io.BytesIO()
        mask.save(buf, "TIFF", compression=comp, tiffinfo=info)
        out[name] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(picture(rng, 64, 80)).save(buf, "TIFF",
                                               compression="zstd",
                                               tiffinfo={317: 2})
    out["zstd.tif"] = buf.getvalue()
    out["rlew.tif"] = tiff.write_tiff(bilevel(rng, 96, 128), photometric=0,
                                      compression=32771, bits=1,
                                      rows_per_strip=32)
    out["thunderscan.tif"] = tiff.write_tiff(
        picture(rng, 64, 80, 1)[..., 0] >> 4, photometric=1,
        compression=32809, bits=4, rows_per_strip=16)
    out["ojpeg_420.tif"] = ojpeg_tiff(picture(rng, 64, 80), 2, "jif",
                                      rows=32)
    out["ojpeg_444.tif"] = ojpeg_tiff(picture(rng, 48, 64), 0, "tables")
    out["sgilog.tif"] = _tiff(picture(rng, 8, 8, 3), photometric=2,
                              compression=34676)
    return out


def main():
    rng = np.random.default_rng(2026)
    os.makedirs(OUT, exist_ok=True)
    lab = io.BytesIO()
    Image.fromarray(picture(rng, 48, 64)).convert("LAB").save(
        lab, "TIFF", compression="tiff_lzw")
    files = {
        "jpeg_ycbcr22.tif": _jpeg_tiff(picture(rng, 72, 96), rows=16,
                                       subsampling=2, tables=True),
        "lzma.tif": _tiff(picture(rng, 64, 80), photometric=2,
                          compression=34925, predictor=2,
                          rows_per_strip=24),
        "float_predictor.tif": _tiff(
            (picture(rng, 48, 64, 1).astype(np.float32) * 1.25 - 20.0),
            32, photometric=1, compression=8, predictor=3, sample_format=3,
            rows_per_strip=16),
        "cmyk.tif": _tiff(picture(rng, 48, 64, 4), photometric=5,
                          compression=5),
        "lab.tif": lab.getvalue(),
        "bigtiff.tif": _tiff(picture(rng, 40, 56, 4), photometric=2,
                             extra=[2], compression=8, bigtiff=True),
        "tiled.tif": _tiff(picture(rng, 50, 70).astype(np.uint16) * 257, 16,
                           photometric=2, compression=5, predictor=2,
                           tile=(16, 16), order=">"),
    }
    files.update(codec_files(rng))
    manifest = {}
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        try:
            rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        except OSError:
            # PIL fails to load it: the texture bakes white
            manifest[name] = {"bytes": len(data), "shape": None,
                              "rgba_sha256": None, "white": True}
            continue
        manifest[name] = {"bytes": len(data), "shape": list(rgba.shape),
                          "rgba_sha256": hashlib.sha256(
                              rgba.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v["bytes"] for k, v in manifest.items()}))


if __name__ == "__main__":
    main()
