"""Write the JPEG recovery fixtures under tests/data/jpeg/ and their
manifest.

Small files, made from a numpy seed, of what libjpeg-turbo 3.1.3 decodes
past (or refuses) through PIL: lossless (SOF3) files with predictors 1-7, a
point transform, restarts, one and three components, chroma subsampling
and the RGB colour space; arithmetic-coded files (sequential and
progressive, with and without DAC conditioning, with restarts); PIL's
progressive files cut after their DC and first AC scans, or inside a scan,
which libjpeg block-smooths; baseline and progressive files whose RSTn are
renumbered, dropped, duplicated or replaced; files cut inside a scan and
closed with EOI, some larger than PIL's 65536-byte feed, and cut without
one; bad Huffman codes and flipped entropy bytes; scans out of the
progression and a sequential scan with spectral parameters. PIL writes the
baseline and progressive files; the lossless and arithmetic ones come from
`tools/jpeg_fixture_writer.c`, compiled here with gcc against the system's
`jpeglib.h` and linked to the libjpeg in PIL's wheel (the library PIL
decodes with). The files are committed: the tests read them, and only a
change of fixtures needs this tool and a C compiler.

`manifest.json` holds each file's size, shape and the SHA-256 of the RGBA
that PIL's `Image.open(f).convert("RGBA")` gives, or "white" where PIL
fails. Marked "city_map", the same for the maps of the JPEG-recovery city
that `assets.write_city_assets(root, formats="jpegrec")` writes (2048^2,
seed 7), which `chip_smoke.py::format_phase` holds the card's host to;
`chip_smoke.py::jpeg_phase` holds the fixtures.
`tests/test_torch_jpeg_recovery.py` checks that the manifest still matches
PIL and the port.

    python tools/make_jpeg_fixtures.py
"""
import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np
import PIL
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg")
sys.path[:0] = [ROOT]

from kajiya_tpu_torch.scene import assets  # noqa: E402

WRITER = os.path.join(ROOT, "tools", "jpeg_fixture_writer.c")


def pil_libjpeg() -> str:
    """The libjpeg of PIL's wheel."""
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    return sorted(glob.glob(os.path.join(libs, "libjpeg-*.so*")))[0]


def build_writer(tmp: str) -> str:
    lib = pil_libjpeg()
    exe = os.path.join(tmp, "jpeg_fixture_writer")
    subprocess.run(["gcc", "-O2", "-o", exe, WRITER, lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)
    return exe


def libjpeg_file(exe: str, tmp: str, img: np.ndarray, *opts) -> bytes:
    """`img` (H, W) or (H, W, 3) written by the libjpeg writer."""
    raw, out = os.path.join(tmp, "px.raw"), os.path.join(tmp, "out.jpg")
    with open(raw, "wb") as f:
        f.write(np.ascontiguousarray(img).tobytes())
    nc = 1 if img.ndim == 2 else img.shape[2]
    subprocess.run([exe, out, raw, str(img.shape[1]), str(img.shape[0]),
                    str(nc), *map(str, opts)], check=True)
    with open(out, "rb") as f:
        return f.read()


def picture(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """Gradients with noise, as textures hold."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(7 * x + 3 * y) % 256, (5 * y) % 256,
                    (3 * (x + y) + 40) % 256], -1)[..., :c]
    img = img + rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_file(img: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    im = Image.fromarray(img if img.shape[-1] != 1 else img[..., 0])
    if mode != im.mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def markers(data: bytes, codes) -> list:
    """Offsets of the markers (FF code) with a code in `codes`."""
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] in codes]


def scans(data: bytes) -> list:
    """(start, end) of each scan of a PIL-written file: from the end of the
    previous scan (its tables included) to the marker after its data."""
    out, start = [], data.index(b"\xff\xda")
    first = start
    for i in markers(data, (0xDA,)):
        j = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        while data[j] != 0xFF or data[j + 1] in range(0xD0, 0xD8) or \
                data[j + 1] == 0:
            j += 1
        out.append((start, j))
        start = j
    return first, out


def fixtures(exe: str, tmp: str) -> dict:
    files = {}
    rgb = picture(1, 37, 53)
    # lossless (SOF3)
    for psv in range(1, 8):
        files[f"lossless_p{psv}_rgb.jpg"] = libjpeg_file(
            exe, tmp, rgb, "lossless", psv, 0)
    for psv in (1, 6):
        files[f"lossless_p{psv}_grey.jpg"] = libjpeg_file(
            exe, tmp, rgb[..., 1], "lossless", psv, 0)
    files["lossless_pt2_rgb.jpg"] = libjpeg_file(exe, tmp, rgb, "lossless",
                                                 7, 2)
    files["lossless_pt5_grey.jpg"] = libjpeg_file(exe, tmp, rgb[..., 0],
                                                  "lossless", 4, 5)
    files["lossless_restart_rgb.jpg"] = libjpeg_file(
        exe, tmp, rgb, "lossless", 5, 0, "restart", 2 * 53)
    files["lossless_h2v2_rgb.jpg"] = libjpeg_file(
        exe, tmp, rgb, "lossless", 1, 0, "sampling", 22)
    files["lossless_rgbspace.jpg"] = libjpeg_file(exe, tmp, rgb, "lossless",
                                                  2, 0, "rgb", 1)
    data = files["lossless_restart_rgb.jpg"]
    sos = data.index(b"\xff\xda")
    files["lossless_cut_eoi.jpg"] = data[:sos + (len(data) - sos) // 2] + \
        b"\xff\xd9"
    flipped = bytearray(files["lossless_p4_rgb.jpg"])
    flipped[len(flipped) // 2] ^= 0x21
    files["lossless_flipped.jpg"] = bytes(flipped)
    rst = markers(data, range(0xD0, 0xD8))
    renum = bytearray(data)
    renum[rst[3] + 1] = 0xD0 + ((renum[rst[3] + 1] + 2) & 7)
    files["lossless_rst_renumbered.jpg"] = bytes(renum)
    # arithmetic coding
    files["arith_seq.jpg"] = libjpeg_file(exe, tmp, rgb, "arith", 1)
    files["arith_prog.jpg"] = libjpeg_file(exe, tmp, rgb, "arith", 1,
                                           "progressive", 1)
    files["arith_dac.jpg"] = libjpeg_file(exe, tmp, rgb, "arith", 1, "dac", 2)
    files["arith_restart.jpg"] = libjpeg_file(exe, tmp, rgb, "arith", 1,
                                              "restart", 3)
    files["arith_grey.jpg"] = libjpeg_file(exe, tmp, rgb[..., 2], "arith", 1)
    files["arith_prog_restart.jpg"] = libjpeg_file(
        exe, tmp, rgb, "arith", 1, "progressive", 1, "restart", 2)
    data = files["arith_restart.jpg"]
    sos = data.index(b"\xff\xda")
    files["arith_cut_eoi.jpg"] = data[:sos + (len(data) - sos) // 2] + \
        b"\xff\xd9"
    flipped = bytearray(files["arith_prog.jpg"])
    flipped[len(flipped) * 2 // 3] ^= 0x10
    files["arith_flipped.jpg"] = bytes(flipped)
    # an arithmetic scan past PIL's first 65536-byte block: libjpeg's
    # arithmetic decoder cannot suspend, so PIL fails (white)
    files["arith_big_white.jpg"] = libjpeg_file(
        exe, tmp, picture(15, 256, 256), "arith", 1, "quality", 100)
    # block smoothing: PIL's progressive files cut between and inside scans
    for name, img, mode, kw in (
            ("rgb420", picture(2, 48, 64), "RGB", {}),
            ("grey", picture(3, 40, 40)[..., :1], "L", {}),
            ("narrow", picture(4, 40, 16), "RGB", {"subsampling": 0}),
            ("cmyk", picture(5, 24, 40), "CMYK", {})):
        data = pil_file(img, mode, progressive=True, quality=80, **kw)
        sos_list = markers(data, (0xDA,))
        files[f"smooth_dc_{name}.jpg"] = data[:sos_list[1]] + b"\xff\xd9"
        files[f"smooth_ac1_{name}.jpg"] = data[:sos_list[2]] + b"\xff\xd9"
    data = pil_file(picture(6, 64, 64), "RGB", progressive=True, quality=80)
    sos_list = markers(data, (0xDA,))
    mid = (sos_list[4] + sos_list[5]) // 2
    files["smooth_cut_in_scan.jpg"] = data[:mid] + b"\xff\xd9"
    # restart markers out of sequence
    data = pil_file(picture(7, 64, 96), "RGB", quality=85,
                    restart_marker_blocks=2)
    rst = markers(data, range(0xD0, 0xD8))
    for name, edit in (("renumbered_next", 1), ("renumbered_prev", -1),
                       ("renumbered_far", 4)):
        d = bytearray(data)
        d[rst[5] + 1] = 0xD0 + ((d[rst[5] + 1] + edit) & 7)
        files[f"rst_{name}.jpg"] = bytes(d)
    files["rst_dropped.jpg"] = data[:rst[5]] + data[rst[5] + 2:]
    files["rst_duplicated.jpg"] = data[:rst[5]] + data[rst[5]:rst[5] + 2] + \
        data[rst[5]:]
    files["rst_eoi.jpg"] = data[:rst[5] + 1] + b"\xd9" + data[rst[5] + 2:]
    data = pil_file(picture(8, 40, 56), "RGB", quality=85, progressive=True,
                    restart_marker_blocks=1)
    rst = markers(data, range(0xD0, 0xD8))
    d = bytearray(data)
    d[rst[len(rst) // 2] + 1] = 0xD0 + ((d[rst[len(rst) // 2] + 1] + 1) & 7)
    files["rst_progressive_renumbered.jpg"] = bytes(d)
    # a segment that ends early, at sizes past PIL's 65536-byte blocks
    big = picture(9, 512, 512)
    for name, kw in (("baseline", {}), ("progressive", {"progressive": True})):
        data = pil_file(big, "RGB", quality=95, **kw)
        sos = data.index(b"\xff\xda")
        files[f"cut_eoi_{name}_big.jpg"] = \
            data[:sos + (len(data) - sos) * 7 // 10] + b"\xff\xd9"
    data = pil_file(picture(10, 40, 40), "RGB", quality=75,
                    restart_marker_blocks=4)
    sos = data.index(b"\xff\xda")
    files["cut_eoi_restart.jpg"] = data[:sos + (len(data) - sos) // 3] + \
        b"\xff\xd9"
    files["cut_no_eoi.jpg"] = data[:len(data) - 40]
    # an EOI-less file PIL decodes: libjpeg's read-ahead stops at the end
    y, x = np.mgrid[0:64, 0:64]
    for q in range(50, 100):
        flat = np.stack([x * 2, y * 3, np.full_like(x, q)], -1).astype(
            np.uint8)
        data = pil_file(flat, "RGB", quality=q)[:-2]
        try:
            Image.open(io.BytesIO(data)).convert("RGBA")
        except OSError:
            continue
        files["cut_no_eoi_decodes.jpg"] = data
        break
    # bad Huffman codes: an AC table symbol edited, flipped entropy bytes,
    # a refinement scan's code sizes changed
    y, x = np.mgrid[0:64, 0:64]
    grad = np.stack([(7 * x) % 256, (5 * y) % 256, (3 * (x + y)) % 256],
                    -1).astype(np.uint8)
    data = bytearray(pil_file(grad, "RGB", quality=75))
    data[232] = 0x35
    files["badcode_ac_symbol.jpg"] = bytes(data)
    data = bytearray(pil_file(picture(11, 48, 48), "RGB", quality=85))
    sos = data.index(b"\xff\xda")
    for f in (0.2, 0.5, 0.8):
        i = sos + 20 + int((len(data) - sos - 22) * f)
        if 0xFF not in (data[i - 1], data[i], data[i + 1], data[i] ^ 0x44):
            data[i] ^= 0x44
    files["badcode_flipped.jpg"] = bytes(data)
    data = pil_file(picture(12, 48, 48), "RGB", quality=90, progressive=True)
    first, sc = scans(data)
    # the last scan is a refinement one in PIL's progression: its first
    # entropy bytes flipped
    start, end = sc[-1]
    sos = data.index(b"\xff\xda", start)
    d = bytearray(data)
    for k in range(3):
        i = sos + 12 + 3 * k
        if 0xFF not in (d[i - 1], d[i], d[i + 1], d[i] ^ 0x5A):
            d[i] ^= 0x5A
    files["badcode_refine.jpg"] = bytes(d)
    # scans out of the progression, a sequential scan with spectral
    # parameters
    data = pil_file(picture(13, 40, 48), "RGB", quality=85, progressive=True)
    first, sc = scans(data)
    segs = [data[a:b] for a, b in sc]
    head, tail = data[:first], data[sc[-1][1]:]
    files["order_ac_before_dc.jpg"] = head + b"".join(
        [segs[1], segs[0]] + segs[2:]) + tail
    files["order_repeated_scan.jpg"] = head + b"".join(
        segs[:3] + [segs[1]] + segs[3:]) + tail
    files["order_refine_first.jpg"] = head + b"".join(
        segs[:1] + [segs[-1]] + segs[1:-1]) + tail
    data = bytearray(pil_file(picture(14, 32, 40), "RGB", quality=85))
    sos = data.index(b"\xff\xda")
    ns = data[sos + 4]
    data[sos + 5 + 2 * ns + 1] = 0x10        # Se
    data[sos + 5 + 2 * ns + 2] = 0x21        # Ah, Al
    files["order_seq_spectral.jpg"] = bytes(data)
    return files


def digest(data: bytes) -> dict:
    try:
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except OSError:
        return dict(white=True)
    return dict(shape=list(rgba.shape),
                rgba_sha256=hashlib.sha256(rgba.tobytes()).hexdigest())


def main():
    os.makedirs(OUT, exist_ok=True)
    for old in glob.glob(os.path.join(OUT, "*.jpg")):
        os.remove(old)
    manifest = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_writer(tmp)
        for name, data in sorted(fixtures(exe, tmp).items()):
            with open(os.path.join(OUT, name), "wb") as f:
                f.write(data)
            manifest[name] = dict(bytes=len(data), **digest(data))
        # the JPEG-recovery city's maps at their full size
        root = os.path.join(tmp, "city")
        written = assets.write_city_assets(root, ground_size=(64, 128),
                                           formats="jpegrec")
        for name in sorted(written):
            with open(os.path.join(root, "meshes", name), "rb") as f:
                data = f.read()
            manifest["city/jpegrec/" + name] = dict(
                bytes=len(data), city_map=True, **digest(data))
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} entries, "
          f"{sum(r['bytes'] for r in manifest.values() if not r.get('city_map'))}"
          " bytes of fixtures")


if __name__ == "__main__":
    main()
