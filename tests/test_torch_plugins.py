"""Port parity: the small plugins (`scene/gbr.py`, `iptc.py`, `xbm.py`,
`xpm.py`, `sun.py`, `msp.py`, `xvthumb.py`, `imt.py`, `pixar.py`) against
PIL 12.1.0's `Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises, or a refusal that passes
the bytes on). Inputs, made from numpy seeds: files PIL writes (XBM, MSP
version 1) and files the writers here make for every mode and header path
of each plugin: GBR versions 1 (L) and 2 (RGBA); IPTC raw and JPEG, L and
one band of RGB or CMYK, with the records PIL misreads; XBM with and
without a hot spot, odd hex; XPM of one- and two-character keys, `P` and
`RGB`, `None` transparency; Sun rasters of every depth and file type,
palettes, RLE runs across rows; MSP versions 1 and 2; XV thumbnails, IMT
and PIXAR. Each plugin then gets a 300-file cut-and-flip sweep, which
states its counts. Then identify's two cases where IPTC or GBR stands first
in PIL's order, the committed fixtures of `tests/data/plugins/` against
their manifest, the plugin city's writer, and the bake against JAX's."""
import collections
import functools
import hashlib
import io
import json
import os
import struct
import tempfile

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import assets, identify, sun, textures, xpm
from test_torch_bmp import (assert_as_pil, assert_bake_matches_jax, pil_rgba,
                            port_rgba, sweep_outcome)
from test_torch_tga import tga_file

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "plugins")
# every plugin registered in PIL's own order before this module's cases are
# built (saving XBM first would register the preinit plugins first, and
# test_torch_identify.py holds `identify.FORMATS` to `Image.ID`)
Image.init()


# ----------------------------------------------------------------------------
# writers of what PIL does not write
# ----------------------------------------------------------------------------

def gbr_file(pixels: np.ndarray, version: int = 2, comment: bytes = b"hi",
             header_size=None, magic: bytes = b"GIMP") -> bytes:
    """(H, W) L or (H, W, 4) RGBA -> a GIMP brush."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    fixed = 20 if version == 1 else 28
    size = fixed + len(comment) + 1 if header_size is None else header_size
    head = struct.pack(">5I", size, version, w, h, depth)
    if version != 1:
        head += magic + struct.pack(">I", 10)
    return head + comment + b"\0" + np.ascontiguousarray(pixels).tobytes()


def iptc_record(rec: int, ds: int, payload: bytes) -> bytes:
    return bytes([0x1C, rec, ds]) + struct.pack(">H", len(payload)) + payload


def iptc_file(data: bytes, w: int, h: int, layers=1, component=0,
              band=None, compression=1, chunk=4000, extra=b"") -> bytes:
    """An IPTC file whose 8:10 records hold `data` in `chunk` pieces."""
    head = iptc_record(2, 0, b"\0\2") + iptc_record(2, 5, b"name")
    head += iptc_record(3, 60, bytes([layers, component]))
    if band is not None:
        head += iptc_record(3, 65, bytes([band]))
    head += iptc_record(3, 20, struct.pack(">I", w)) + \
        iptc_record(3, 30, struct.pack(">H", h))
    if compression is not None:
        head += iptc_record(3, 120, bytes([compression]))
    body = b"".join(iptc_record(8, 10, data[i:i + chunk])
                    for i in range(0, len(data), chunk))
    return head + body + extra


def sun_file(rows: bytes, w: int, h: int, depth: int, ftype: int = 1,
             palette: bytes = b"", ptype: int = 1) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(rows), ftype,
                       ptype if palette else 0, len(palette)) + palette + rows


def xbm_file(bits: np.ndarray, hotspot=None) -> bytes:
    """(H, W) bool -> an XBM as PIL's writer lays it out."""
    h, w = bits.shape
    packed = np.packbits(bits, axis=1, bitorder="little")
    head = b"#define im_width %d\n#define im_height %d\n" % (w, h)
    if hotspot:
        head += b"#define im_x_hot %d\n#define im_y_hot %d\n" % hotspot
    body = b",".join(b"0x%02x" % b for b in packed.ravel())
    return head + b"static char im_bits[] = {\n" + body + b"\n};\n"


def msp_rle_file(bits: np.ndarray) -> bytes:
    """(H, W) bool -> a version 2 (`LinS`) MSP of RLE rows (runs of 3 to
    255 bytes, literals of up to 255)."""
    h, w = bits.shape
    words = [0x694C, 0x536E, w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    for v in words[:12]:
        words[12] ^= v
    body, lens = [], []
    for row in np.packbits(bits, axis=1):
        enc, i, row = bytearray(), 0, row.tobytes()
        while i < len(row):
            j = i
            while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 2:
                enc += bytes([0, j - i + 1, row[i]])
                i = j + 1
                continue
            k, j = min(len(row), i + 255), i + 1
            while j < k and not (j + 2 < len(row)
                                 and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            enc += bytes([j - i]) + row[i:j]
            i = j
        lens.append(len(enc))
        body.append(bytes(enc))
    return (struct.pack("<16H", *words) + struct.pack(f"<{h}H", *lens)
            + b"".join(body))


def xvthumb_file(idx: np.ndarray, comment: bytes = b"#XVVERSION:2\n"):
    """(H, W) uint8 indices into the 3-3-2 palette -> an XV thumbnail."""
    h, w = idx.shape
    return b"P7 332\n" + comment + b"%d %d 255\n" % (w, h) + \
        np.ascontiguousarray(idx, np.uint8).tobytes()


def imt_file(grey: np.ndarray) -> bytes:
    """(H, W) uint8 -> an IMT file PIL reads as L."""
    h, w = grey.shape
    return (b"width %d\nheight %d\npixel n8\n\x0c" % (w, h)
            + np.ascontiguousarray(grey, np.uint8).tobytes())


def pixar_file(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> a PIXAR file PIL reads as RGB."""
    h, w, _ = img.shape
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + np.ascontiguousarray(img, np.uint8).tobytes()


def pil_saved(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def xpm_with_none(data: bytes, key: bytes = b"%") -> bytes:
    """An XPM with one more colour line, `key` c None (PIL's transparency:
    the key's own bytes), that no pixel uses."""
    lines = data.split(b"\n")
    w, h, n, bpp = lines[2].strip(b'",').split()
    lines[2] = b'"%s %s %d %s",' % (w, h, int(n) + 1, bpp)
    return b"\n".join(lines[:3] + [b'"%s c None",' % key] + lines[3:])


def _grey(rng, h, w):
    return (rng.integers(0, 256, (h, w)) // 32 * 32).astype(np.uint8)


def _jpeg(rng, h, w, mode):
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    return pil_saved(img.convert(mode), "JPEG", quality=90)


# ----------------------------------------------------------------------------
# each plugin's cases
# ----------------------------------------------------------------------------

def gbr_cases(rng):
    rgba = rng.integers(0, 256, (9, 13, 4), np.uint8)
    grey = _grey(rng, 9, 13)
    return {
        "v1-L": gbr_file(grey, version=1),
        "v2-RGBA": gbr_file(rgba),
        "v2-L-long-comment": gbr_file(grey, comment=b"x" * 300),
        "v2-header-under-28": gbr_file(rgba, header_size=24),
        "v2-bad-magic": gbr_file(rgba, magic=b"GIMQ"),
        "v1-header-past-end": gbr_file(grey, version=1, header_size=4000),
        "short-pixels": gbr_file(rgba)[:-5],
        "depth-3": gbr_file(rgba)[:16] + struct.pack(">I", 3) +
        gbr_file(rgba)[20:],
        "version-3": gbr_file(rgba)[:4] + struct.pack(">I", 3) +
        gbr_file(rgba)[8:],
        "zero-width": gbr_file(rgba[:, :0]),
        "short-header": gbr_file(rgba)[:22],
    }


def iptc_cases(rng):
    grey = _grey(rng, 11, 17)
    jl, jrgb = _jpeg(rng, 16, 24, "L"), _jpeg(rng, 16, 24, "RGB")
    cmyk = pil_saved(Image.fromarray(rng.integers(0, 256, (8, 8, 4),
                                                  np.uint8), "CMYK"),
                     "JPEG")
    raw = grey.tobytes()
    return {
        "raw-L": iptc_file(raw, 17, 11),
        "raw-L-chunks": iptc_file(raw, 17, 11, chunk=7),
        "raw-RGB-band": iptc_file(raw, 17, 11, 3, 1, band=2),
        "raw-RGB-no-band": iptc_file(raw, 17, 11, 3, 1),
        "raw-CMYK-band": iptc_file(raw, 17, 11, 4, 1, band=4),
        "raw-band-0": iptc_file(raw, 17, 11, 3, 1, band=0),
        "raw-band-past": iptc_file(raw, 17, 11, 3, 1, band=5),
        "jpeg-L": iptc_file(jl, 24, 16, compression=5),
        "jpeg-RGB": iptc_file(jrgb, 24, 16, compression=5),
        "jpeg-CMYK": iptc_file(cmyk, 8, 8, compression=5),
        "jpeg-band-L": iptc_file(jl, 24, 16, 3, 1, band=1, compression=5),
        "jpeg-band-RGB": iptc_file(jrgb, 24, 16, 3, 1, band=1,
                                   compression=5),
        "jpeg-garbage": iptc_file(b"garbage" * 9, 24, 16, compression=5),
        "compression-2": iptc_file(raw, 17, 11, compression=2),
        "no-compression": iptc_file(raw, 17, 11, compression=None),
        "no-mode": iptc_file(raw, 17, 11, 2, 0),
        "short-data": iptc_file(raw[:-20], 17, 11),
        "zero-width": iptc_file(raw, 0, 11),
        "zeros-after": iptc_file(raw, 17, 11, extra=b"\0" * 9),
        "garbage-after": iptc_file(raw, 17, 11, extra=b"\x1b\x02\x05ab"),
        "other-record-after": iptc_file(raw, 17, 11,
                                        extra=iptc_record(2, 5, b"x")),
        "length-133": iptc_file(raw, 17, 11)[:3] + b"\x85" +
        iptc_file(raw, 17, 11)[4:],
        "length-extended": b"\x1c\x02\x00\x82\x00\x00\x02ab" +
        iptc_file(raw, 17, 11)[7:],
        "repeated-3-60": iptc_record(3, 60, b"\1\0") +
        iptc_file(raw, 17, 11),
        "empty-3-20": iptc_record(3, 20, b"") + iptc_file(raw, 17, 11)[
            len(iptc_record(2, 0, b"\0\2")):],
        "no-8-10": iptc_file(b"", 17, 11),
    }


def xbm_cases(rng):
    bits = rng.random((13, 21)) < 0.5
    data = xbm_file(bits)
    return {
        "pil": pil_saved(Image.fromarray(bits), "XBM"),
        "pil-hotspot": pil_saved(Image.fromarray(bits), "XBM",
                                 hotspot=(3, 4)),
        "writer-hotspot": xbm_file(bits[:, :16], (1, 2)),
        "upper-and-odd": data.replace(b"0x", b"0X", 5).replace(
            b"0x", b"xx", 3).replace(b"0x0", b"0xz", 2),
        "truncated": data[:-12],
        "ends-at-x": data[:data.rindex(b"x") + 2],
        "header-past-512": b" " * 520 + data,
        "zero-width": data.replace(b"im_width 21", b"im_width 0"),
        "bits-after-512": data.replace(b"static", b"/*" + b"." * 500 +
                                       b"*/ static"),
    }


def xpm_cases(rng):
    cols = rng.integers(0, 256, (300, 3), np.uint8)
    idx = rng.integers(0, 40, (9, 14))
    one = xpm.encode_xpm(idx, cols[:40])
    lines = one.split(b"\n")
    rgb = xpm.encode_xpm(rng.integers(0, 300, (9, 14)), cols, bpp=2)
    return {
        "P-bpp1": one,
        "P-bpp2": xpm.encode_xpm(idx, cols[:40], bpp=2),
        "RGB-300": rgb,
        "P-none": xpm_with_none(one),
        "P-none-bpp2": xpm_with_none(xpm.encode_xpm(idx, cols[:40], bpp=2),
                                     b"%&"),
        "RGB-none": xpm_with_none(rgb, b"%&"),
        "colour-name": one.replace(b"c #", b"c red #", 1).replace(
            b"red #", b"red ", 1),
        "no-c-key": one.replace(b" c #", b" m #", 1),
        "bad-hex": one.replace(b"c #", b"c #zz", 1),
        "no-pixels-header": one.replace(b"/* pixels */\n", b""),
        "rows-split": one.replace(b'",\n"', b'",\n"', 3).replace(
            b'"a', b'"a"\n"', 1),
        "unknown-key": one[:-20] + b'"' + b"%" * 14 + b'",\n};\n',
        "short": b"\n".join(lines[:-5]) + b"\n",
        "bpp-0": one.replace(b" 40 1", b" 40 0", 1),
        "P-bpp3": xpm.encode_xpm(idx, cols[:40], bpp=3),
        "P-bpp2-odd-line": xpm.encode_xpm(idx, cols[:40], bpp=2).replace(
            b'",\n"', b'X",\n"', 1),
        "empty-width": one.replace(b'"14 9', b'" 9', 1),
        "no-header": b"/* XPM */\nstatic char *x[] = {\n",
    }


def sun_cases(rng):
    w, h = 21, 11
    out = {}
    for depth in (1, 4, 8, 24, 32):
        stride = (w * depth + 15) // 16 * 2
        rows = rng.integers(0, 256, stride * h, np.uint8).tobytes()
        for ftype in (0, 1, 3, 4, 5):
            out[f"raw-{depth}-type{ftype}"] = sun_file(rows, w, h, depth,
                                                       ftype)
        pal = rng.integers(0, 256, 48, np.uint8).tobytes()
        out[f"raw-{depth}-palette"] = sun_file(rows, w, h, depth, 1, pal)
        out[f"raw-{depth}-short"] = sun_file(rows[:-3], w, h, depth)
        nbytes = (w * depth + 7) // 8
        flat = np.repeat(rng.integers(0, 256, nbytes * h // 5 + 1),
                         5)[:nbytes * h].astype(np.uint8)
        flat[::17] = 0x80
        out[f"rle-{depth}"] = sun_file(_sun_rle(flat.tobytes()), w, h, depth,
                                       2)
        out[f"rle-{depth}-palette"] = sun_file(_sun_rle(flat.tobytes()), w,
                                               h, depth, 2, pal)
    img = rng.integers(0, 4, (h, w, 3)).astype(np.uint8) * 80
    enc = sun.encode_sun_rle(img)
    out.update({
        "writer-rle": enc,
        "rle-truncated": enc[:-4],
        "rle-ends-in-escape": enc + b"\x80",
        "rle-run-past-end": sun_file(b"\x80\xff\x07", 3, 2, 8, 2),
        "rle-run-across-rows": sun_file(b"\x80\x0a\x07\x01\x02" * 4, 5, 3,
                                        8, 2),
        "palette-1024": sun_file(rng.integers(0, 256, 1024 * w * h // 1024,
                                              np.uint8).tobytes(), w, h, 8,
                                 1, bytes(1024)),
        "palette-1025": sun_file(bytes(w * h), w, h, 8, 1, bytes(1025)),
        "palette-type-2": sun_file(bytes(w * h), w, h, 8, 1, bytes(48), 2),
        "type-6": sun_file(bytes(w * h), w, h, 8, 6),
        "depth-16": sun_file(bytes(2 * w * h), w, h, 16),
        "zero-height": sun_file(b"", w, 0, 8),
    })
    return out


def _sun_rle(raw: bytes) -> bytes:
    """RLE with runs of 2 and more (`0x80 n v` for n + 1 bytes), escaped
    0x80s, and runs that pass row ends."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j + 1 < len(raw) and raw[j + 1] == raw[i] and j - i < 255:
            j += 1
        if j > i:
            out += bytes([0x80, j - i, raw[i]])
        elif raw[i] == 0x80:
            out += b"\x80\x00"
        else:
            out.append(raw[i])
        i = j + 1
    return bytes(out)


def msp_cases(rng):
    bits = rng.random((13, 29)) < 0.3
    v2 = msp_rle_file(bits)
    h = 13
    rowmap_end = 32 + 2 * h
    zero_row = bytearray(v2)
    zero_row[32:34] = b"\0\0"
    return {
        "v1-pil": pil_saved(Image.fromarray(bits), "MSP"),
        "v2": v2,
        "v2-zero-row": bytes(zero_row),
        "v2-truncated-map": v2[:40],
        "v2-truncated-row": v2[:-3],
        "v2-short-run": v2[:rowmap_end] + b"\x00\x05",
        "bad-checksum": v2[:30] + b"\1\0" + v2[32:],
        "v1-short": pil_saved(Image.fromarray(bits), "MSP")[:-7],
        "short-header": v2[:20],
    }


def xvthumb_cases(rng):
    idx = rng.integers(0, 256, (9, 15)).astype(np.uint8)
    data = xvthumb_file(idx)
    return {
        "thumb": data,
        "comments": xvthumb_file(idx, b"#a\n#b c\n"),
        "no-comment": xvthumb_file(idx, b""),
        "one-field": b"P7 332\n15\n" + idx.tobytes(),
        "not-a-number": b"P7 332\n15 x 255\n" + idx.tobytes(),
        "short": data[:-4],
        "eof-in-comments": b"P7 332\n#only\n#comments",
        "zero-width": b"P7 332\n0 9 255\n",
    }


def imt_cases(rng):
    grey = _grey(rng, 7, 12)
    data = imt_file(grey)
    return {
        "imt": data,
        "comment": b"* made here\n" + data,
        "no-mode": data.replace(b"pixel n8\n", b""),
        "no-form-feed": data.replace(b"\x0c", b"\n"),
        "bad-width": data.replace(b"width 12", b"width x"),
        "long-line": b"name " + b"a" * 120 + b"\n" + data,
        "short": data[:-5],
        "no-line-feed": b"width 12 height 7 pixel n8" + b" " * 100,
        "height-first": data.replace(b"width 12\nheight 7\n",
                                     b"height 7\nwidth 12\n"),
    }


def pixar_cases(rng):
    img = rng.integers(0, 256, (6, 10, 3), np.uint8)
    data = pixar_file(img)
    return {
        "rgb": data,
        "other-mode": data[:424] + struct.pack("<HH", 14, 1) + data[428:],
        "short-header": data[:300],
        "short-pixels": data[:-8],
        "zero-width": data[:418] + b"\0\0" + data[420:],
    }


CASES = {"GBR": gbr_cases, "IPTC": iptc_cases, "XBM": xbm_cases,
         "XPM": xpm_cases, "SUN": sun_cases, "MSP": msp_cases,
         "XVTHUMB": xvthumb_cases, "IMT": imt_cases, "PIXAR": pixar_cases}


@functools.lru_cache(maxsize=None)
def _cases(fmt):
    return CASES[fmt](np.random.default_rng(sum(map(ord, fmt))))


@pytest.mark.parametrize("fmt,case", [(f, c) for f in CASES
                                      for c in _cases(f)])
def test_case_as_pil(fmt, case):
    data = _cases(fmt)[case]
    assert_as_pil(data)


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_each_plugin_decodes(fmt):
    """Every plugin has cases that PIL decodes, and each is the plugin
    `identify` names first."""
    decoded = [c for c, d in _cases(fmt).items() if pil_rgba(d) is not None]
    assert len(decoded) >= 1
    for c in decoded:
        assert identify.identify(_cases(fmt)[c]) == fmt, c


def test_xpm_none_sets_palette_alpha():
    """PIL keeps a `P` XPM's `None` key as its transparency, a byte
    string, so `convert` gives the first palette entries the key's
    character codes as alpha ("%" = 37)."""
    got = port_rgba(_cases("XPM")["P-none"])
    want = pil_rgba(_cases("XPM")["P-none"])
    np.testing.assert_array_equal(got, want)
    assert 37 in set(got[..., 3].ravel().tolist())


# ----------------------------------------------------------------------------
# the sweeps
# ----------------------------------------------------------------------------

def _fuzz_base(fmt, k):
    cases = _cases(fmt)
    good = [d for d in cases.values() if pil_rgba(d) is not None]
    return good[k % len(good)]


# each plugin's sweep files that raise NotImplementedError (a cut or flipped
# header that an unported plugin accepts first, or IPTC data that opens as
# a format IPTC's port does not take), a part. Of each 300 (PIL's bytes /
# white, of which a refusal of the plugin's `_open` / NotImplementedError):
# GBR 127 / 173, 24 / 0; IMT 79 / 221, 69 / 0; IPTC 64 / 236, 114 / 0; MSP
# 37 / 263, 129 / 0; PIXAR 205 / 95, 25 / 0; SUN 91 / 209, 66 / 0; XBM
# 48 / 252, 138 / 0; XPM 61 / 239, 44 / 0; XVTHUMB 139 / 161, 7 / 0
CUT_UNPORTED = {"GBR": 0, "IPTC": 0, "XBM": 0, "XPM": 0, "SUN": 0, "MSP": 0,
                "XVTHUMB": 0, "IMT": 0, "PIXAR": 0}


@pytest.mark.parametrize("fmt", sorted(CASES))
@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(fmt, part):
    """300 seeded cut or flipped files of each plugin (50 a part): PIL's
    bytes, PIL's error, or NotImplementedError; never pixels that
    differ."""
    rng = np.random.default_rng(2400 + 10 * part + sorted(CASES).index(fmt))
    seen = collections.Counter()
    for t in range(50):
        data = bytearray(_fuzz_base(fmt, 50 * part + t))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                # the first 48 bytes (the headers) draw half the flips
                i = int(rng.integers(0, min(len(data), 48))) \
                    if rng.random() < 0.5 else int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[sweep_outcome(bytes(data), inner=("IPTC holding",))] += 1
    assert seen["unported"] <= CUT_UNPORTED[fmt], seen


# ----------------------------------------------------------------------------
# identify's order cases
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["tga-28-byte-id", "ico-gbr"])
def test_order_cases_as_pil(case):
    """The two layouts where IPTC or GBR stands first in PIL's order before
    a plugin that was ported earlier: 50 seeded files each go where PIL
    takes them (that plugin's `_open`, then the next's), never to
    NotImplementedError."""
    rng = np.random.default_rng(2600 + len(case))
    seen = collections.Counter()
    for _ in range(50):
        if case == "tga-28-byte-id":
            w, h = (int(v) for v in rng.integers(1, 12, 2))
            pal = rng.integers(0, 256, 3 * 256, np.uint8).tobytes()
            ident = rng.integers(0, 256, 28, np.uint8)
            ident[:5] = (0x1C, int(rng.choice([1, 2, 3, 8])),
                         int(rng.integers(0, 256)),
                         int(rng.choice([0, 0, 4, 130, 200])),
                         int(rng.integers(0, 256)))
            data = tga_file(w, h, 1, 8, rng.integers(0, 256, w * h,
                                                     np.uint8).tobytes(),
                            (0, 256, 24), pal, idlen=28)
            data = data[:18] + ident.tobytes() + data[46:]
            want = "IPTC"
        else:
            # ICO's `00 00 01 00` is GBR's header size 256, its first entry
            # GBR's version: the pixels start at byte 256
            w, h = (int(v) for v in rng.integers(1, 12, 2))
            depth = int(rng.choice([1, 4]))
            version = int(rng.choice([1, 2]))
            data = (b"\0\0\1\0\0\0\0" + bytes([version])
                    + struct.pack(">3I", w, h, depth)
                    + (b"GIMP\0\0\0\1" if version == 2 else b""))
            data += rng.integers(0, 256, 256 - len(data) + int(rng.integers(
                0, 2)) * w * h * depth + int(rng.integers(-8, 8)) % 16,
                np.uint8).tobytes()
            want = "GBR"
        assert identify.candidates(data)[0] == want
        seen[sweep_outcome(data)] += 1
    assert "unported" not in seen, seen
    assert seen["pixels"] + seen["white"] == 50


# ----------------------------------------------------------------------------
# the fixtures, the city's writer, the bake
# ----------------------------------------------------------------------------

# (tools/make_plugin_fixtures.py imports the writers above before it writes
# the manifest)
_MANIFEST_PATH = os.path.join(FIXTURES, "manifest.json")
MANIFEST = json.load(open(_MANIFEST_PATH)) if os.path.exists(
    _MANIFEST_PATH) else {}
FILES = sorted(n for n, r in MANIFEST.items() if not r.get("city_map"))


def test_manifest_lists_every_kind():
    kinds = {n.split(".")[-1] for n in FILES}
    assert kinds == {"tif", "psd", "icns", "gbr", "iptc", "xbm", "xpm",
                     "ras", "msp", "xv", "imt", "pxr"}
    assert sum(MANIFEST[n]["bytes"] for n in FILES) < 400_000
    assert sorted(n for n in MANIFEST if n not in FILES) == [
        "city/b0_base.tif", "city/b1_base.tif", "city/b2_base.tif"]


@pytest.mark.parametrize("name", FILES)
def test_fixture_matches_manifest(name):
    """Each fixture decodes, in PIL and in the port (from its path, as the
    bake reads it), to the RGBA digest of `manifest.json`, which
    `chip_smoke.py::plugin_phase` checks on the card's host."""
    rec = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == rec["bytes"]
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec["rgba_sha256"]
    got = textures._decode_image(path)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["rgba_sha256"]


@functools.lru_cache(maxsize=None)
def _city(map_size):
    root = tempfile.mkdtemp(prefix="plugin_city_")
    kw = {} if map_size == 2048 else dict(map_size=map_size,
                                          emissive_size=128)
    written = assets.write_city_assets(root, ground_size=(64, 128),
                                       formats="plugins", **kw)
    return root, written


@pytest.mark.parametrize("map_size", [256, 2048])
def test_city_maps_as_pil(map_size):
    """The plugin city's maps (`assets.write_city_assets(...,
    formats="plugins")`): every lossless map decodes, in PIL and in the
    port, to the texels its writer reports; each LAB base colour to PIL's
    bytes, which at full size are the digests of the fixtures' manifest
    that `chip_smoke.py::format_phase` holds the card's host to."""
    root, written = _city(map_size)
    kinds = collections.Counter()
    for name, (_img, want) in sorted(written.items()):
        path = os.path.join(root, "meshes", name)
        pil = np.asarray(Image.open(path).convert("RGBA"))
        got = textures._decode_image(path)
        np.testing.assert_array_equal(got, pil)
        kinds[os.path.splitext(name)[1]] += 1
        if want is not None:
            np.testing.assert_array_equal(got, want)
        elif map_size == 2048:
            rec = MANIFEST["city/" + name]
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                rec["rgba_sha256"]
    assert kinds == {".tif": 3, ".ras": 3, ".xpm": 3, ".icns": 1}


def test_bake_matches_jax():
    rng = np.random.default_rng(29)
    sources = [_cases(f)[c] for f, c in (
        ("GBR", "v2-RGBA"), ("IPTC", "raw-RGB-band"), ("XBM", "pil"),
        ("XPM", "P-bpp2"), ("SUN", "rle-24"), ("MSP", "v2"),
        ("XVTHUMB", "thumb"), ("IMT", "imt"), ("PIXAR", "rgb"))]
    sources.append(sun.encode_sun_rle(rng.integers(0, 256, (20, 30, 3),
                                                   np.uint8)))
    assert_bake_matches_jax(sources)
