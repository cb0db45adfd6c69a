"""Write the rare-format fixtures under tests/data/rare/ and their manifest.

Small files of the formats this slice of the port decodes, made from a
numpy seed with the writers of the tests (`tests/test_torch_rare.py`,
`test_torch_rare_anim.py`), the port's writers and PIL where it writes the
format: IM of every `Image type` PIL opens (one file for each mode and raw
mode: 1, P of 2 and 4 bits, L, I;16 / I;16L / I;16B, I from I;32 and
I;32S, F raw of 8, 16 and 32 bits signed and unsigned and of float, F
through the `bit` decoder at five depths, RGB line-interleaved, packed and
in three planes, RGBX, RGBA, LA, CMYK and YCbCr), with a colour `Lut`
(P and PA) and as PIL writes it; McIdas areas of 1, 2 and 4 bytes (with
row prefixes and bands); SPIDER in both byte orders and a stack; FITS of
every BITPIX and a `GZIP_1` table; FLI and FLC whose first frame holds
each chunk type (BRUN, LC, SS2, COPY, BLACK, COLOR_64, COLOR_256, PSTAMP)
and a prefix chunk; PCD in each orientation. `manifest.json` holds each
file's shape and the SHA-256 of the RGBA that PIL's
`Image.open(f).convert("RGBA")` gives, and, marked "city_map", the same for
the PhotoCD base colour of the rare-format city that
`assets.write_city_assets(root, formats="rare")` writes (2048^2 maps, seed
7): `chip_smoke.py` holds the files (`rare_phase`) and that map
(`format_phase`) to these digests on a machine that has no PIL;
`tests/test_torch_rare_city.py` checks that the manifest still matches PIL
and the port.

    python tools/make_rare_fixtures.py
"""
import hashlib
import io
import json
import os
import sys
import tempfile

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "rare")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from kajiya_tpu_torch.scene import assets, fits  # noqa: E402
from test_torch_rare import (fits_gzip_file, im_of_kind,  # noqa: E402
                             mcidas_file, mcidas_rows, pil_saved,
                             spider_file)
from test_torch_rare_anim import _cases as anim_cases  # noqa: E402

# one `Image type` of each mode and raw mode PIL opens
IM_KINDS = ("0 1 image", "B2 image", "B4 image", "Greyscale image",
            "L 16 image", "L 16L image", "L 16B image", "L 32 S image",
            "L 32S image", "L 8 image", "L 8S image", "L 16S image",
            "L 32 F image", "L 32F image", "L*2 image", "L*5 image",
            "L*12 image", "L*24 image", "L*31 image", "RGB image",
            "X 24 image", "RGB3 image", "RYB3 image", "RGBX image",
            "RGBA image", "LA image", "CMYK image", "YCC image")


def _digest(data: bytes):
    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return dict(shape=list(rgba.shape),
                rgba_sha256=hashlib.sha256(rgba.tobytes()).hexdigest())


def main():
    rng = np.random.default_rng(2030)
    files = {}
    for kind in IM_KINDS:
        name = kind.replace(" image", "").replace("*", "x").replace(" ", "_")
        files[f"im_{name}.im"] = im_of_kind(rng, kind, 23, 15)
    colour = rng.integers(0, 256, 768, np.uint8).tobytes()
    files["im_lut_P.im"] = im_of_kind(rng, "Greyscale image", 23, 15,
                                      lut=colour)
    files["im_lut_PA.im"] = im_of_kind(rng, "LA image", 23, 15, lut=colour)
    files["im_pil_P.im"] = pil_saved(Image.fromarray(rng.integers(
        0, 256, (15, 23, 3), np.uint8)).quantize(40), "IM")
    w, h = 29, 17
    for bpp in (1, 2, 4):
        files[f"mcidas_{bpp}byte.area"] = mcidas_file(
            mcidas_rows(rng, w, h, bpp), w, h, bpp)
    files["mcidas_prefix_bands.area"] = mcidas_file(
        mcidas_rows(rng, w, h, 2, prefix=6, bands=2), w, h, 2, prefix=6,
        bands=2)
    img = (rng.random((h, w)) * 300 - 20).astype(np.float32)
    files["spider_big.spi"] = spider_file(img)
    files["spider_little.spi"] = spider_file(img, big=False)
    files["spider_stack.spi"] = spider_file(img, stack=True)
    grey = rng.integers(0, 256, (h, w))
    wide = rng.integers(-40000, 70000, (h, w))
    for bitpix in (8, 16, 32, -32, -64):
        src = grey if bitpix == 8 else wide if bitpix > 0 else \
            rng.random((h, w)) * 300 - 10
        files[f"fits_{bitpix}.fits"] = fits.encode_fits(src, bitpix)
    files["fits_gzip_8.fits"] = fits_gzip_file(grey, 8)
    files["fits_gzip_16.fits"] = fits_gzip_file(wide, 16)
    fli = anim_cases("FLI")
    for case in ("writer", "brun-fli", "color64", "colour-packets", "lc",
                 "lc-skips", "ss2-skips", "copy", "black", "pstamp"):
        suffix = ".fli" if case == "brun-fli" else ".flc"
        files[f"fli_{case}{suffix}"] = fli[case]
    for case in "0123":
        files[f"pcd_orientation_{case}.pcd"] = anim_cases("PCD")[case]
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        manifest[name] = dict(bytes=len(data), **_digest(data))
    with tempfile.TemporaryDirectory() as root:
        written = assets.write_city_assets(root, ground_size=(64, 128),
                                           formats="rare")
        for name in sorted(written):
            if written[name][1] is None:
                with open(os.path.join(root, "meshes", name), "rb") as f:
                    data = f.read()
                manifest["city/" + name] = dict(bytes=len(data), city_map=True,
                                                **_digest(data))
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v["bytes"] for k, v in manifest.items()}))


if __name__ == "__main__":
    main()
