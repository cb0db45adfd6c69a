"""Write the studio fixtures under tests/data/studio/ and their manifest.

Small files of the formats the studio city does not carry, made from a
numpy seed with the writers of the tests (`tests/test_torch_blp.py`,
`test_torch_ftex.py`, `test_torch_psd.py`, `test_torch_pcx.py`) and with
PIL where it writes the format: BLP1 JPEG and palette, BLP2 palette, DXT1,
DXT3, DXT5 and raw BGRA (which PIL has no decoder for: white); FTEX raw
and DXT1; PSD CMYK, indexed and bitmap; PCX 1-bit of 2 planes with the
EGA palette, of 4 planes, and 8-bit with a palette; DCX; PFM and a 16-bit
PGM; and a LAB PSD. `manifest.json` holds each file's shape and the
SHA-256 of the RGBA that PIL's `Image.open(f).convert("RGBA")` gives; a
file PIL cannot decode is marked "white" (the port must raise what the
bake turns white). `chip_smoke.py` decodes the files
with the port on a machine that has no PIL and holds them to these
digests; `tests/test_torch_studio_fixtures.py` checks that the manifest
still matches PIL and the port.

    python tools/make_studio_fixtures.py
"""
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "studio")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from make_tiff_fixtures import picture  # noqa: E402  (tools/, the script's)
from test_torch_blp import (blp1_jpeg, blp2_file,  # noqa: E402
                            dxt_blocks)
from test_torch_ftex import dxt1, ftex_file  # noqa: E402
from test_torch_pcx import pcx_file, planes_rows  # noqa: E402
from test_torch_psd import psd_file  # noqa: E402



def pil_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def main():
    rng = np.random.default_rng(2027)
    rgb = picture(rng, 48, 64)
    jpeg = pil_bytes(Image.fromarray(rgb), "JPEG", quality=90)
    pal_img = Image.fromarray(picture(rng, 40, 56)).convert("P")
    grey = picture(rng, 36, 52, 1)[..., 0]
    pcx_idx = (picture(rng, 30, 44, 1)[..., 0] // 16).astype(np.uint8)
    ega = rng.integers(0, 256, 48, np.uint8).tobytes()
    pcx8 = pil_bytes(Image.fromarray(picture(rng, 40, 56)).convert("P"),
                     "PCX")
    cmyk = np.moveaxis(picture(rng, 40, 48, 4), -1, 0)
    lab = np.moveaxis(np.asarray(Image.fromarray(picture(
        rng, 32, 40)).convert("LAB")), -1, 0)
    bits = np.packbits(picture(rng, 24, 64, 1)[..., 0] > 128, axis=1)
    files = {
        "blp1_jpeg.blp": blp1_jpeg(64, 48, jpeg, 180, alpha=8),
        "blp1_palette.blp": pil_bytes(pal_img, "BLP", blp_version="BLP1"),
        "blp2_palette.blp": pil_bytes(pal_img, "BLP", blp_version="BLP2"),
        "blp2_dxt1.blp": blp2_file(52, 36, dxt_blocks(rng, 52, 36, 0),
                                   alpha=8, alpha_encoding=0),
        "blp2_dxt3.blp": blp2_file(48, 32, dxt_blocks(rng, 48, 32, 1),
                                   alpha=8, alpha_encoding=1),
        "blp2_dxt5.blp": blp2_file(44, 40, dxt_blocks(rng, 44, 40, 7),
                                   alpha=8, alpha_encoding=7),
        "blp2_raw_bgra.blp": blp2_file(
            16, 16, rng.integers(0, 256, 1024, np.uint8).tobytes(),
            encoding=3),
        "ftex_raw.ftu": ftex_file(60, 36, picture(rng, 36, 60).tobytes()),
        "ftex_dxt1.ftc": ftex_file(64, 32, dxt1(rng, 64, 32), 0),
        "psd_cmyk.psd": psd_file(cmyk, 4),
        "psd_indexed.psd": psd_file(
            grey[None] // 2, 2,
            colour=rng.integers(0, 256, 768, np.uint8).tobytes()),
        "psd_bitmap.psd": psd_file(bits[None], 0, bits=1, comp=0),
        "pcx_ega_2plane.pcx": pcx_file(
            44, 30, planes_rows(pcx_idx % 4, 2, 6), version=2, bits=1,
            planes=2, ega=ega),
        "pcx_4plane.pcx": pcx_file(44, 30, planes_rows(pcx_idx, 4, 6),
                                   version=2, bits=1, planes=4, ega=ega),
        "pcx_8bit_palette.pcx": pcx8,
        "dcx_two_pages.dcx": b"",
        "pfm.pfm": pil_bytes(Image.fromarray(
            picture(rng, 30, 40, 1)[..., 0].astype(np.float32) * 1.3 - 20),
            "PPM"),
        "pgm16.pgm": pil_bytes(Image.fromarray(
            picture(rng, 30, 40, 1)[..., 0].astype(np.int32) * 2), "PPM"),
        "psd_lab.psd": psd_file(lab, 9),
    }
    pages = [pcx8, files["pcx_ega_2plane.pcx"]]
    offsets = [4 + 4 * 3, 4 + 4 * 3 + len(pages[0])]
    files["dcx_two_pages.dcx"] = struct.pack("<4I", 0x3ADE68B1, *offsets,
                                             0) + b"".join(pages)
    manifest = {}
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        rec = {"bytes": len(data)}
        try:
            rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        except Exception:
            rec["white"] = True
        else:
            rec.update(shape=list(rgba.shape), rgba_sha256=hashlib.sha256(
                rgba.tobytes()).hexdigest())
        manifest[name] = rec
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v["bytes"] for k, v in manifest.items()}))


if __name__ == "__main__":
    main()
