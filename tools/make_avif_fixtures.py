"""Write the AVIF fixtures under tests/data/avif/ and their manifest.

Small files made from a numpy seed: PIL's own (RGB, RGBA, L, 4:2:2, 4:4:4,
4:0:0, limited range, lossless, tiles, premultiplied alpha, screen
content, film grain, a quantizer matrix, an odd size, a sequence with
alpha) and files built from PIL's payloads with the helpers of
`tests/test_torch_avif.py` (a grid, `idat`, iloc version 2 with ipma
version 1, transforms, Exif, and the faults: an alpha item without ispe,
a clap not marked essential, an Exif payload without its TIFF header, a
grid short of a cell, an unknown essential property, five pixi planes, no
pitm). `manifest.json` holds each file's size, the wheel's libavif parse
result (`avifDecoderParse` with PIL's strict flags), PIL's outcome
("pixels", "white" or "refused") and the port's: "unported" where PIL
decodes (the port raises NotImplementedError: AV1 decoding is not ported)
and "white" where the bake turns the file white. `chip_smoke.py` holds the
files to it on a machine without PIL (`avif_phase`);
`tests/test_torch_avif.py` checks that it still matches PIL, libavif and
the port.

    python tools/make_avif_fixtures.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "avif")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import test_torch_avif as t  # noqa: E402

PIL_FILES = ("rgb", "rgba", "l", "s422", "s444", "s400", "limited",
             "lossless", "tiles", "premultiplied", "screen", "grain", "qm",
             "17x33", "sequence_alpha")
BUILT_FILES = ("grid", "idat", "iloc_v2_ipma_v1", "transforms", "exif",
               "alpha_no_ispe", "clap_not_essential", "exif_no_tiff_header",
               "grid_3_cells", "unknown_essential", "pixi_5_planes",
               "no_pitm")


def main():
    os.makedirs(OUT, exist_ok=True)
    files = {f"pil_{n}.avif": t.PIL_WRITES[n]() for n in PIL_FILES}
    files.update({f"built_{n}.avif": t.BUILT[n] for n in BUILT_FILES})
    manifest = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        pil = t.pil_open_outcome(data)
        port = t.port_open_outcome(data)
        entry = dict(bytes=len(data), parse=t.libavif_parse(data), pil=pil)
        if port == "pixels":
            entry["unported"] = True
        else:
            entry["white"] = True
        manifest[name] = entry
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{len(manifest)} files, "
          f"{sum(e['bytes'] for e in manifest.values())} bytes")


if __name__ == "__main__":
    main()
