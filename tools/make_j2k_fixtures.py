"""Write the JPEG 2000 fixtures under tests/data/j2k/ and their manifest.

Small files, made from a numpy seed with PIL's writer where it writes
them and built from PIL's files where it does not (with the helpers of
`tests/test_torch_j2k.py`): J2K codestreams and JP2 files in every mode
PIL writes (L, LA, RGB, RGBA, I;16, CMYK, sYCC), reversible and
irreversible; num_resolutions 1 to 7; tiles with a tile offset and an
image offset; three quality layers; the five progressions with and
without precincts (and the CPRL file with 16 x 16 precincts that PIL
cannot read back: "white"); code-blocks from 4 x 4 to 64 x 64, non-square
too; mct=0, signed, PLT, a comment; odd sizes; one irreversible RGB at
1024^2 (the 9/7 path's time on the card's host); by hand, each Part 1
code-block style set in COD over PIL's data, the HTJ2K style bit
("unported"), SOP / EPH markers, PPT and PPM packet headers, a `pclr`
palette; ICNS files whose best member is a JPEG 2000 codestream or JP2
file. `manifest.json` holds each file's shape and the SHA-256 of the RGBA
that PIL's `Image.open(f).convert("RGBA")` gives (or "white" where PIL
fails, "unported" where the port raises NotImplementedError):
`chip_smoke.py` holds the files to these digests on a machine that has no
PIL (`j2k_phase`); `tests/test_torch_j2k_city.py` checks that the manifest
still matches PIL and the port.

    python tools/make_j2k_fixtures.py
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
OUT = os.path.join(ROOT, "tests", "data", "j2k")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from kajiya_tpu_torch.scene import icns, j2k  # noqa: E402
from test_torch_j2k import (jp2_file, main_segments, picture,  # noqa: E402
                            pil_j2k, restructured)

# the Part 1 code-block styles: BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM
STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16,
          "segsym": 32, "all": 63, "htj2k": 64}


def _digest(data: bytes):
    try:
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except OSError:
        return dict(white=True)
    return dict(shape=list(rgba.shape),
                rgba_sha256=hashlib.sha256(rgba.tobytes()).hexdigest())


def _with_style(data: bytes, style: int) -> bytes:
    soc = data.find(b"\xff\x4f\xff\x51")
    cod = [s for s in main_segments(data, soc) if s[0] == 0xFF52][0]
    out = bytearray(data)
    out[cod[1] + 12] = style
    return bytes(out)


def files() -> dict:
    img = picture(2100, 37, 29)
    wide = picture(2101, 70, 90)
    out = {}
    for mode in ("L", "LA", "RGB", "RGBA", "CMYK", "YCbCr"):
        for irr in (False, True):
            for no_jp2 in (True, False):
                name = f"mode_{mode.lower()}_{'97' if irr else '53'}." + \
                    ("j2k" if no_jp2 else "jp2")
                out[name] = pil_j2k(img, mode, irreversible=irr,
                                    no_jp2=no_jp2)
    grey16 = np.random.default_rng(2102).integers(0, 65536, (21, 33))
    for irr in (False, True):
        for no_jp2 in (True, False):
            buf = io.BytesIO()
            Image.frombuffer("I;16", (33, 21), grey16.astype("<u2")
                             .tobytes()).save(buf, "JPEG2000", no_jp2=no_jp2,
                                              irreversible=irr)
            out[f"mode_i16_{'97' if irr else '53'}." +
                ("j2k" if no_jp2 else "jp2")] = buf.getvalue()
    for levels in range(1, 8):
        out[f"res_{levels}.j2k"] = pil_j2k(wide, "RGB", no_jp2=True,
                                           num_resolutions=levels)
    out["res_4_97.j2k"] = pil_j2k(wide, "RGB", no_jp2=True,
                                  num_resolutions=4, irreversible=True)
    for i, (tile, toff, off) in enumerate((
            ((32, 32), (0, 0), (0, 0)), ((24, 40), (3, 5), (7, 9)),
            ((16, 16), (0, 0), (5, 3)), ((40, 24), (10, 2), (15, 11)))):
        out[f"tiles_{i}.jp2"] = pil_j2k(wide, "RGBA", tile_size=tile,
                                        tile_offset=toff, offset=off)
    out["tiles_97.jp2"] = pil_j2k(wide, "RGBA", tile_size=(24, 40),
                                  tile_offset=(3, 5), offset=(7, 9),
                                  irreversible=True)
    out["layers_rates.j2k"] = pil_j2k(wide, "RGB", no_jp2=True,
                                      quality_mode="rates",
                                      quality_layers=[40, 20, 10])
    out["layers_db_97.j2k"] = pil_j2k(wide, "RGB", no_jp2=True,
                                      quality_mode="dB",
                                      quality_layers=[20, 30, 40],
                                      irreversible=True)
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        for prec in (None, (32, 64)):
            kw = {} if prec is None else dict(precinct_size=prec)
            name = f"prog_{prog.lower()}" + ("_prec.j2k" if prec else ".j2k")
            out[name] = pil_j2k(wide, "RGB", no_jp2=True, progression=prog,
                                **kw)
    out["prog_cprl_prec16.j2k"] = pil_j2k(
        picture(2103, 32, 40), "RGB", no_jp2=True, progression="CPRL",
        precinct_size=(16, 16))
    for cb in ((4, 4), (16, 64), (64, 16), (64, 64), (128, 32)):
        out[f"cblk_{cb[0]}x{cb[1]}.j2k"] = pil_j2k(
            wide, "RGBA", no_jp2=True, codeblock_size=cb)
    out["cblk_8x8_97.j2k"] = pil_j2k(wide, "RGBA", no_jp2=True,
                                     codeblock_size=(8, 8), irreversible=True)
    for name, (mode, kw) in {
            "mct0": ("RGB", dict(mct=0)), "signed": ("RGB", dict(signed=True)),
            "signed_l": ("L", dict(signed=True)),
            "plt": ("RGB", dict(plt=True)),
            "comment": ("RGB", dict(comment="kajiya"))}.items():
        out[f"opt_{name}.jp2"] = pil_j2k(wide, mode, **kw)
    for shape in ((1, 1), (1, 13), (13, 1), (17, 33)):
        out[f"odd_{shape[0]}x{shape[1]}.jp2"] = pil_j2k(
            picture(2104, *shape), "RGB")
    out["big_rgb_97_1024.jp2"] = pil_j2k(
        picture(2105, 1024, 1024), "RGB", irreversible=True,
        quality_mode="rates", quality_layers=[20])
    for base_name, irr in (("53", False), ("97", True)):
        base = pil_j2k(img, "RGB", no_jp2=True, irreversible=irr)
        for style, bits in STYLES.items():
            if style == "htj2k" and irr:
                continue
            out[f"style_{style}_{base_name}.j2k"] = _with_style(base, bits)
    for how in ("sop_eph", "ppt", "ppm"):
        out[f"packets_{how}.j2k"] = restructured(
            pil_j2k(wide, "RGBA", no_jp2=True, tile_size=(32, 32),
                    quality_mode="rates", quality_layers=[20, 8]), how)
    rng = np.random.default_rng(2106)
    entries = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(200)]
    pclr = j2k._box(b"pclr", struct.pack(">HB", len(entries), 3) +
                    bytes((7, 7, 7)) + b"".join(bytes(e) for e in entries))
    cmap = j2k._box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                      for i in range(3)))
    index = np.repeat((picture(2107, 12, 10)[..., :1] % 200).astype(
        np.uint8), 3, -1)
    out["jp2_pclr.jp2"] = jp2_file(pil_j2k(index, "L", no_jp2=True), 10,
                                   12, 1, 16, pclr + cmap)
    member = pil_j2k(picture(2108, 64, 64), "RGBA", no_jp2=True)
    out["icns_ic09_j2k.icns"] = icns.encode_icns([(b"ic09", member)])
    out["icns_ic10_jp2.icns"] = icns.encode_icns(
        [(b"ic10", pil_j2k(picture(2109, 128, 128), "RGB"))])
    return out


def main():
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, data in sorted(files().items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        rec = dict(bytes=len(data), unported=True) \
            if name.startswith("style_htj2k") else \
            dict(bytes=len(data), **_digest(data))
        manifest[name] = rec
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v["bytes"] for k, v in manifest.items()}))
    print(sum(v["bytes"] for v in manifest.values()))


if __name__ == "__main__":
    main()
