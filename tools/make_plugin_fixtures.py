"""Write the plugin fixtures under tests/data/plugins/ and their manifest.

Small files of the formats this slice of the port decodes, made from a
numpy seed with the writers of the tests (`tests/test_torch_plugins.py`,
`test_torch_tiff.py`, `test_torch_psd.py`), the port's writers and PIL
where it writes the format: LAB TIFFs (raw strips, LZW with differencing,
tiled, big-endian) and LAB PSDs (raw and PackBits); ICNS of RLE members
only and of a PNG member beside the RLE pair and mask of its size; GBR
versions 1 and 2; IPTC raw L, one band of RGB, and JPEG; XBM (PIL's writer,
with a hot spot); XPM `P` (with a `None` key) and `RGB`; Sun rasters of 1, 4
(with a colour map), 8 (with and without), 24 and 32 bits and RLE at 8 and
24 bits; MSP versions 1 and 2; an XV thumbnail, an IMT and a PIXAR file.
`manifest.json` holds each file's shape and the SHA-256 of the RGBA that
PIL's `Image.open(f).convert("RGBA")` gives, and, marked "city_map", the
same for the LAB base colours of the plugin city that
`assets.write_city_assets(root, formats="plugins")` writes (2048^2, seed
7): `chip_smoke.py` holds the files (`plugin_phase`) and those maps
(`format_phase`) to these digests on a machine that has no PIL;
`tests/test_torch_plugins.py` checks that the manifest still matches PIL
and the port.

    python tools/make_plugin_fixtures.py
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
OUT = os.path.join(ROOT, "tests", "data", "plugins")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from kajiya_tpu_torch.scene import assets, icns, sun, xpm  # noqa: E402
from kajiya_tpu_torch.scene.png import encode_png  # noqa: E402
from make_tiff_fixtures import picture  # noqa: E402  (tools/, the script's)
from test_torch_plugins import (_sun_rle, gbr_file,  # noqa: E402
                                imt_file, iptc_file, msp_rle_file,
                                pil_saved, pixar_file, sun_file,
                                xpm_with_none, xvthumb_file)
from test_torch_psd import psd_file  # noqa: E402
from test_torch_tiff import _tiff  # noqa: E402


def _digest(data: bytes):
    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return dict(shape=list(rgba.shape),
                rgba_sha256=hashlib.sha256(rgba.tobytes()).hexdigest())


def main():
    rng = np.random.default_rng(2029)
    lab = assets.lab_samples(picture(rng, 40, 56))
    lab_planes = np.moveaxis(np.asarray(Image.fromarray(picture(
        rng, 32, 40)).convert("LAB")), -1, 0)
    rgba = picture(rng, 128, 128, 4) // 32 * 32
    icon = picture(rng, 16, 16, 4)
    grey = picture(rng, 24, 40, 1)[..., 0]
    w, h = 37, 21
    sun_img = picture(rng, h, w)
    pal48 = rng.integers(0, 256, 48, np.uint8).tobytes()
    pal768 = rng.integers(0, 256, 768, np.uint8).tobytes()
    cols = rng.integers(0, 256, (300, 3), np.uint8)
    xpm_p = xpm_with_none(xpm.encode_xpm(rng.integers(0, 30, (20, 33)),
                                         cols[:30]))

    def sun_raw(depth, ftype=1, pal=b""):
        stride = (w * depth + 15) // 16 * 2
        if depth >= 24:
            px = np.zeros((h, stride), np.uint8)
            c = depth // 8
            px[:, :w * c].reshape(h, w, c)[..., :3] = sun_img[..., ::-1] \
                if ftype != 3 else sun_img
            return sun_file(px.tobytes(), w, h, depth, ftype, pal)
        v = picture(rng, h, stride, 1)[..., 0]
        return sun_file(v.tobytes(), w, h, depth, ftype, pal)

    files = {
        "lab_raw.tif": _tiff(lab, photometric=8, rows_per_strip=8),
        "lab_lzw_predictor.tif": _tiff(lab, photometric=8, compression=5,
                                       predictor=2),
        "lab_tiled.tif": _tiff(lab, photometric=8, compression=8,
                               tile=(16, 16)),
        "lab_be.tif": _tiff(lab, photometric=8, order=">"),
        "lab_raw.psd": psd_file(lab_planes, 9, comp=0),
        "lab_rle.psd": psd_file(lab_planes, 9, comp=1),
        "icns_rle.icns": icns.encode_icns([
            (b"is32", icns.rgb_member(icon[..., :3])),
            (b"s8mk", icns.mask_member(icon[..., 3])),
            (b"it32", icns.rgb_member(rgba[..., :3], it32=True)),
            (b"t8mk", icns.mask_member(rgba[..., 3]))]),
        "icns_png_mask.icns": icns.encode_icns([
            (b"it32", icns.rgb_member(rgba[..., :3], it32=True)),
            (b"t8mk", icns.mask_member(rgba[..., 3])),
            (b"icp4", encode_png(icon)),
            (b"ic07", encode_png(picture(rng, 128, 128, 4) // 16 * 16))]),
        "gbr_v1_l.gbr": gbr_file(grey, version=1),
        "gbr_v2_rgba.gbr": gbr_file(picture(rng, 20, 30, 4),
                                    comment=b"a brush"),
        "iptc_raw_l.iptc": iptc_file(grey.tobytes(), 40, 24),
        "iptc_rgb_band.iptc": iptc_file(grey.tobytes(), 40, 24, 3, 1,
                                        band=2),
        "iptc_jpeg.iptc": iptc_file(pil_saved(Image.fromarray(
            picture(rng, 24, 32)), "JPEG", quality=90), 32, 24,
            compression=5),
        "xbm_hotspot.xbm": pil_saved(Image.fromarray(
            picture(rng, 19, 45, 1)[..., 0] > 128), "XBM", hotspot=(4, 7)),
        "xpm_p_none.xpm": xpm_p,
        "xpm_rgb.xpm": xpm.encode_xpm(rng.integers(0, 300, (20, 33)), cols,
                                      bpp=2),
        "sun_1bit.ras": sun_raw(1),
        "sun_4bit_palette.ras": sun_raw(4, 1, pal48),
        "sun_8bit.ras": sun_raw(8, 0),
        "sun_8bit_palette.ras": sun_raw(8, 1, pal768),
        "sun_24bit_bgr.ras": sun_raw(24),
        "sun_24bit_rgb.ras": sun_raw(24, 3),
        "sun_32bit.ras": sun_raw(32, 5),
        "sun_rle_24bit.ras": sun.encode_sun_rle(
            (sun_img // 64 * 64).astype(np.uint8)),
        "sun_rle_8bit.ras": sun_file(_sun_rle(
            (picture(rng, h, w, 1)[..., 0] // 64 * 64).tobytes()), w, h, 8,
            2),
        "msp_v1.msp": pil_saved(Image.fromarray(
            picture(rng, 30, 50, 1)[..., 0] > 100), "MSP"),
        "msp_v2.msp": msp_rle_file(picture(rng, 30, 50, 1)[..., 0] > 100),
        "xvthumb.xv": xvthumb_file(picture(rng, 24, 36, 1)[..., 0]),
        "imt.imt": imt_file(picture(rng, 20, 28, 1)[..., 0]),
        "pixar.pxr": pixar_file(picture(rng, 16, 24)),
    }
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        manifest[name] = dict(bytes=len(data), **_digest(data))
    with tempfile.TemporaryDirectory() as root:
        written = assets.write_city_assets(root, ground_size=(64, 128),
                                           formats="plugins")
        for name in sorted(written):
            if name.endswith("_base.tif"):
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
