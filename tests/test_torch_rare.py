"""Port parity: the integer and float plugins (`scene/mcidas.py`,
`spider.py`, `fits.py`, `im.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises, or a refusal that passes
the bytes on). Inputs, made from numpy seeds: files PIL writes (IM in every
mode it saves, SPIDER) and files the writers here and the port's make for
every mode and header path: McIdas areas of 1, 2 and 4 bytes, with row
prefixes and bands; SPIDER in both byte orders, stacks and single stack
images; FITS of every BITPIX, NAXIS 1, extensions, `GZIP_1` tables, the
short data unit; IM of every `Image type` PIL opens, `Lut` palettes, the
odd bit depths of the `bit` decoder, three-plane `RGB3`, and the header
faults. Each plugin then gets a 300-file cut-and-flip sweep, which states
its counts. The FLI / FLC and PCD cases, the fixtures, the YCbCr
conversion and the city are in test_torch_rare_anim.py and
test_torch_rare_city.py, which import the writers here."""
import collections
import functools
import gzip
import io
import os
import struct
import tempfile

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import fits, identify, im, mcidas, spider, textures
from test_torch_bmp import (assert_as_pil, pil_rgba, port_rgba,
                            sweep_outcome)

# every plugin registered in PIL's own order before the cases are built
Image.init()


# ----------------------------------------------------------------------------
# writers of what PIL does not write
# ----------------------------------------------------------------------------

def mcidas_file(pixels: bytes, w: int, h: int, bpp: int = 1, prefix: int = 0,
                bands: int = 1, offset: int = 256, words=None) -> bytes:
    """A McIdas area: the 64-word directory, then rows of `prefix` bytes
    and `bands` x w pixels of `bpp` bytes (only the first band is read)."""
    d = [0] * 64
    d[1], d[8], d[9], d[10], d[13], d[14], d[33] = (4, h, w, bpp, bands,
                                                    prefix, offset)
    for k, v in (words or {}).items():
        d[k - 1] = v
    return struct.pack("!64i", *d) + b"\0" * max(0, offset - 256) + pixels


def mcidas_rows(rng, w, h, bpp, prefix=0, bands=1) -> bytes:
    return rng.integers(0, 256, h * (prefix + w * bpp * bands),
                        np.uint8).tobytes()


def spider_file(img: np.ndarray, big: bool = True, words=None,
                stack: bool = False) -> bytes:
    """A SPIDER image (`spider.encode_spider`'s header), `words` setting
    header values by PIL's 1-based index; `stack` puts a stack header
    (h[24] = 1, h[26] = 1) before the image and its own header."""
    data = bytearray(spider.encode_spider(img, big))
    order = ">f" if big else "<f"
    for k, v in (words or {}).items():
        struct.pack_into(order, data, 4 * (k - 1), v)
    if stack:
        head = bytearray(data[:1024])
        struct.pack_into(order, head, 4 * 23, 1.0)
        struct.pack_into(order, head, 4 * 25, 1.0)
        data = head + data
    return bytes(data)


def fits_cards(cards) -> bytes:
    """Header cards as they stand in the file ((key, value text) pairs,
    "END" last), padded to 2880 bytes."""
    head = b"".join((f"{k:<8}= {v}" if v is not None else k).ljust(80)
                    .encode("latin-1") for k, v in cards)
    return head + b" " * (-len(head) % 2880)


def fits_gzip_file(img: np.ndarray, zbitpix: int = 8) -> bytes:
    """(H, W) -> a FITS file whose image is a `GZIP_1` tile-compressed
    BINTABLE, as PIL's `FitsGzipDecoder` reads it: the rows bottom-up, each
    pixel's value in the last bytes of a big-endian 4-byte word, one gzip
    member after the (here one-row) table."""
    h, w = img.shape
    words = np.ascontiguousarray(img[::-1]).astype(">u4")
    table = b"\0" * 8
    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
             ("NAXIS1", 8), ("NAXIS2", 1), ("PCOUNT", 0), ("GCOUNT", 1),
             ("TFIELDS", 1), ("ZIMAGE", True), ("ZCMPTYPE", "GZIP_1"),
             ("ZBITPIX", zbitpix), ("ZNAXIS", 2), ("ZNAXIS1", w),
             ("ZNAXIS2", h)]
    primary = fits._unit([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                          ("EXTEND", True)])
    return primary + fits._unit(cards) + table + gzip.compress(
        words.tobytes(), mtime=0)


def im_file(header: bytes, body: bytes, pad: bool = True,
            lut: bytes = b"") -> bytes:
    """An IM file: header lines (CR LF), NUL padding to 511 bytes and ^Z
    as PIL's writer puts them, an optional 768-byte Lut, the pixels."""
    if pad:
        header += b"\0" * max(0, 511 - len(header))
    return header + b"\x1a" + lut + body


def im_header(kind: str, w: int, h: int, extra: bytes = b"") -> bytes:
    return (b"Image type: %s\r\nImage size (x*y): %d*%d\r\n" % (
        kind.encode(), w, h)) + extra


# bytes a pixel (bits for the 1- and 2/4-bit types) of each `Image type`
def _im_bits(kind: str) -> int:
    mode, rawmode = im.OPEN[kind]
    if rawmode.startswith("F;"):
        try:
            return int(rawmode[2:].rstrip("SF"))
        except ValueError:
            pass
    return {"1": 1, "P;2": 2, "P;4": 4, "L": 8, "RGB;L": 24, "RLB": 24,
            "RGB": 24, "I;32": 32, "RGB;T": 8, "RYB;T": 8, "LA;L": 16,
            "PA;L": 16, "RGBA;L": 32, "RGBX;L": 32, "CMYK;L": 32,
            "YCbCr;L": 24, "I;16": 16, "I;16L": 16, "I;16B": 16,
            "I;32S": 32}[rawmode]


def im_of_kind(rng, kind: str, w: int = 11, h: int = 7, lut: bytes = b"",
               extra: bytes = b"") -> bytes:
    """An IM file of `Image type: kind` with random pixel bytes enough for
    it (three planes for RGB3 / RYB3)."""
    bits = _im_bits(kind)
    n = h * ((w * bits + 7) // 8)
    if im.OPEN[kind][1] in ("RGB;T", "RYB;T"):
        n = 3 * w * h
    body = rng.integers(0, 256, n, np.uint8).tobytes()
    if extra or lut:
        extra += b"Lut: 1\r\n" if lut else b""
    return im_file(im_header(kind, w, h, extra), body, lut=lut)


def pil_saved(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# ----------------------------------------------------------------------------
# each plugin's cases
# ----------------------------------------------------------------------------

def mcidas_cases(rng):
    w, h = 13, 9
    one = mcidas_rows(rng, w, h, 1)
    return {
        "1-byte": mcidas_file(one, w, h),
        "2-byte": mcidas_file(mcidas_rows(rng, w, h, 2), w, h, 2),
        "4-byte": mcidas_file(mcidas_rows(rng, w, h, 4), w, h, 4),
        "4-byte-small": mcidas_file(
            np.repeat(rng.integers(0, 300, (w * h, 1)).astype(">i4"), 1)
            .tobytes(), w, h, 4),
        "prefix": mcidas_file(mcidas_rows(rng, w, h, 1, prefix=5), w, h,
                              prefix=5),
        "bands": mcidas_file(mcidas_rows(rng, w, h, 2, bands=3), w, h, 2,
                             bands=3),
        "offset": mcidas_file(one, w, h, offset=300),
        "3-byte": mcidas_file(one, w, h, 3),
        "zero-width": mcidas_file(one, 0, h),
        "negative-height": mcidas_file(one, w, -2),
        "short-header": mcidas_file(one, w, h)[:200],
        "short-pixels": mcidas_file(one, w, h)[:-3],
        "negative-stride": mcidas_file(one, w, h, bands=-1),
        "zero-stride": mcidas_file(one, w, h, bands=0),
        "stride-under-row": mcidas_file(one, w, h, prefix=-5),
        "bad-magic": b"\0" * 7 + b"\5" + mcidas_file(one, w, h)[8:],
    }


def spider_cases(rng):
    img = (rng.random((9, 12)) * 300 - 20).astype(np.float32)
    ints = rng.integers(0, 256, (9, 12)).astype(np.float32)
    be = spider_file(img)
    return {
        "big": be,
        "little": spider_file(img, big=False),
        "integers": spider_file(ints),
        "nan-inf": spider_file(np.where(rng.random((9, 12)) < 0.2, np.nan,
                                        np.where(rng.random((9, 12)) < 0.2,
                                                 np.inf, img))),
        "pil": pil_saved(Image.fromarray(img, "F"), "SPIDER"),
        "stack": spider_file(ints, stack=True),
        "stack-image": spider_file(ints, words={27: 1.0}),
        "stack-nan-count": spider_file(ints, words={24: 1.0,
                                                    26: float("nan")}),
        "nan-stack": spider_file(ints, words={24: float("nan")}),
        # infinite stack words: `int` overflows in PIL's `_open` (white)
        **{f"{name}-{'big' if big else 'little'}": spider_file(
            ints, big, words=words)
           for big in (True, False)
           for name, words in (("inf-stack", {24: float("inf")}),
                               ("minus-inf-stack", {24: float("-inf")}),
                               ("inf-image-number", {27: float("inf")}),
                               ("minus-inf-image-number",
                                {27: float("-inf")}),
                               ("stack-inf-count", {24: 1.0,
                                                    26: float("inf")}))},
        "negative-stack": spider_file(ints, words={24: -1.0}),
        "iform-3": spider_file(ints, words={5: 3.0}),
        "zero-width": spider_file(ints, words={12: 0.0}),
        "short-pixels": be[:-10],
        "short-header": be[:100],
        "odd-header-length": spider_file(ints, words={13: 2.0, 22: 600.0,
                                                      23: 300.0}),
        "negative-header-length": spider_file(ints, words={13: -1.0,
                                                           22: -1024.0}),
    }


def fits_cases(rng):
    g = rng.integers(0, 256, (6, 10))
    wide = rng.integers(-40000, 70000, (6, 10))
    flt = rng.random((6, 10)) * 300 - 10
    base = [("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "2"),
            ("NAXIS1", "10"), ("NAXIS2", "6")]
    pixels = np.ascontiguousarray(g[::-1]).astype(">u1").tobytes()

    def cards(*changes, drop=(), end=True):
        c = dict(base)
        c.update(changes)
        out = [(k, v) for k, v in c.items() if k not in drop]
        return fits_cards(out + ([("END", None)] if end else []))

    return {
        "8": fits.encode_fits(g, 8),
        "16": fits.encode_fits(wide, 16),
        "32": fits.encode_fits(wide, 32),
        "-32": fits.encode_fits(flt, -32),
        "-64": fits.encode_fits(flt, -64),
        "16-small": fits.encode_fits(g, 16),
        "naxis-1": cards(("NAXIS", "1"), ("NAXIS1", "24")) + bytes(range(24)),
        "naxis-3": cards(("NAXIS", "3"), ("NAXIS3", "1")) + pixels,
        "comment": cards(("BITPIX", "8 / bits a pixel")) + pixels,
        "no-equals": fits_cards([("SIMPLE", "T")] + [
            (k, v) for k, v in base[1:]] + [("END", None)])
        .replace(b"BITPIX  = 8", b"BITPIX    8") + pixels,
        "extension": fits_cards([("SIMPLE", "T"), ("BITPIX", "8"),
                                 ("NAXIS", "0"), ("END", None)])
        + fits_cards([("XTENSION", "'IMAGE   '")] + base[1:]
                     + [("END", None)]) + pixels,
        "no-image": fits_cards([("SIMPLE", "T"), ("BITPIX", "8"),
                                ("NAXIS", "0"), ("END", None)]) + pixels,
        "gzip-8": fits_gzip_file(g, 8),
        "gzip-16": fits_gzip_file(wide, 16),
        "gzip-32": fits_gzip_file(wide, 32),
        "gzip-float": fits_gzip_file(g, -32),
        "gzip-short": fits_gzip_file(g, 8)[:-9],
        "gzip-padded": fits_gzip_file(g, 8) + b"\0" * 100,
        "gzip-other": fits_gzip_file(g, 8).replace(b"GZIP_1",
                                                          b"RICE_1"),
        "short-data-unit": cards() + pixels[:50],
        "short-file": cards() + pixels[:-7],
        "no-data": cards(),
        "bitpix-64": cards(("BITPIX", "64")) + pixels,
        "bitpix-text": cards(("BITPIX", "eight")) + pixels,
        "no-naxis": cards(drop=("NAXIS",)) + pixels,
        "no-naxis2": cards(drop=("NAXIS2",)) + pixels,
        "simple-f": cards(("SIMPLE", "F")) + pixels,
        "zero-width": cards(("NAXIS1", "0")) + pixels,
        "no-end": cards(end=False)[:400],
    }


_IM_KINDS = sorted(im.OPEN)


def im_cases(rng):
    cases = {k: im_of_kind(rng, k) for k in _IM_KINDS}
    ramp = bytes(range(256)) * 3
    grey = bytes(255 - i for i in range(256)) * 3
    colour = rng.integers(0, 256, 768, np.uint8).tobytes()
    for lut_name, lut in (("linear", ramp), ("grey", grey),
                          ("colour", colour)):
        for kind in ("Greyscale image", "LA image", "B2 image",
                     "RGB image", "L 16 image"):
            cases[f"lut-{lut_name}-{kind}"] = im_of_kind(rng, kind, lut=lut,
                                                         extra=b"Name: x\r\n")
    body = rng.integers(0, 256, 11 * 7 * 4, np.uint8).tobytes()
    head = im_header("Greyscale image", 11, 7)
    cases.update({
        "pil-L": pil_saved(Image.fromarray(rng.integers(0, 256, (7, 11),
                                                        np.uint8)), "IM"),
        "short-lut": im_file(head + b"Lut: 1\r\n", body[:300], lut=b""),
        "mode-type-RGB": im_file(im_header("RGB", 11, 7), body),
        "mode-type-P": im_file(im_header("P", 11, 7), body),
        "mode-type-LAB": im_file(im_header("LAB", 11, 7), body),
        "mode-type-unknown": im_file(im_header("Colour", 11, 7), body),
        "mode-type-RGBX-stale": im_file(
            im_header("RGB image", 11, 7) + b"Image type: RGBX\r\n", body),
        "mode-type-F-stale": im_file(
            im_header("L*12 image", 11, 7) + b"Image type: F\r\n", body),
        "mode-type-RGBA-tiles": im_file(
            im_header("RGB3 image", 11, 7) + b"Image type: RGBA\r\n", body),
        "size-float": im_file(im_header("Greyscale image", 11, 7).replace(
            b"11*7", b"11.0*7"), body),
        "size-one": im_file(im_header("Greyscale image", 11, 7).replace(
            b"11*7", b"11"), body),
        "size-three": im_file(im_header("Greyscale image", 11, 7).replace(
            b"11*7", b"11*7*2"), body),
        "size-text": im_file(im_header("Greyscale image", 11, 7).replace(
            b"11*7", b"eleven*7"), body),
        "size-zero": im_file(im_header("Greyscale image", 0, 7), body),
        "default-size": im_file(b"Image type: Greyscale image\r\n",
                                body * 900),
        "scale-bad": im_file(head + b"Scale (x,y): 1,x\r\n", body),
        "no-tags": im_file(b"Foo: bar\r\n", body),
        "not-key-value": im_file(head + b"just words\r\n", body),
        "long-line": im_file(head + b"Name: " + b"a" * 120 + b"\r\n", body),
        "no-ctrl-z": head + body.replace(b"\x1a", b"\x1b"),
        "nul-no-ctrl-z": head + b"\0" * 40,
        "lf-only": im_file(head.replace(b"\r\n", b"\n"), body),
        "cr-first": im_file(b"\r" + head, body),
        "comments": im_file(b"Comment: one\r\nComment: two\r\n" + head,
                            body),
        "short-body": im_file(head, body[:40]),
        "unpadded": im_file(head, body, pad=False),
        "PA-image-colour-lut": im_of_kind(rng, "PA image", lut=colour),
    })
    return cases


CASES = {"MCIDAS": mcidas_cases, "SPIDER": spider_cases,
         "FITS": fits_cases, "IM": im_cases}


@functools.lru_cache(maxsize=None)
def _cases(fmt):
    return CASES[fmt](np.random.default_rng(sum(map(ord, fmt)) + 20))


@pytest.mark.parametrize("fmt,case", [(f, c) for f in CASES
                                      for c in _cases(f)])
def test_case_as_pil(fmt, case):
    assert_as_pil(_cases(fmt)[case])


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_each_plugin_decodes(fmt):
    """Every plugin has cases that PIL decodes, and each is the plugin
    `identify` names first."""
    decoded = [c for c, d in _cases(fmt).items() if pil_rgba(d) is not None]
    assert len(decoded) >= 3
    for c in decoded:
        assert identify.identify(_cases(fmt)[c]) == fmt, c


def test_im_opens_every_type_pil_opens():
    """Each `Image type` of IM's OPEN table: PIL decodes it (except the
    three whose raw mode it has no unpacker for: white), and the port gives
    its bytes."""
    cases = _cases("IM")
    white = sorted(k for k in _IM_KINDS if pil_rgba(cases[k]) is None)
    assert white == ["PA image", "RLB image", "RYB image"]
    for k in _IM_KINDS:
        assert_as_pil(cases[k])


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "I", "F", "I;16",
                                  "I;16L", "I;16B", "RGB", "RGBA", "CMYK",
                                  "YCbCr"])
def test_im_pil_written(mode):
    """IM files PIL writes, in each mode its writer takes (P through its
    `Lut`)."""
    rng = np.random.default_rng(len(mode) + 7)
    src = Image.fromarray(rng.integers(0, 256, (9, 14, 3), np.uint8))
    if mode in ("I", "F", "I;16", "I;16L", "I;16B"):
        src = Image.fromarray(rng.integers(0, 400, (9, 14)).astype(
            np.int32)).convert(mode)
    elif mode == "P":
        src = src.quantize(37)
    else:
        src = src.convert(mode)
    data = pil_saved(src, "IM")
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("bits", range(2, 32))
def test_im_bit_decoder_depths(bits):
    """`L*n image` of each odd depth goes through PIL's `bit` decoder
    (fill 3, padded rows, bottom-up, a row's leftover bits OR-ed into the
    next): values that fit 8 bits and random bytes, odd widths."""
    rng = np.random.default_rng(bits)
    kind = f"L*{bits} image"
    for w in (1, 5, 13):
        assert_as_pil(im_of_kind(rng, kind, w, 6))
        # small values, so that the grey levels are not all 255
        vals = rng.integers(0, 256, (6, w)) >> max(0, 8 - bits)
        row = (w * bits + 7) // 8
        body = b""
        for r in vals[::-1]:
            acc = sum(int(v) << (i * bits) for i, v in enumerate(r))
            body += acc.to_bytes(row, "little")
        assert_as_pil(im_file(im_header(kind, w, 6), body), must_decode=True)


@pytest.mark.parametrize("part", range(4))
def test_im_type_then_mode_as_pil(part):
    """A header whose `Image type` line names a PIL mode (or none) after a
    line of IM's OPEN table: the mode the last line sets with the raw mode
    the first left, each with and without a colour `Lut`, as PIL decodes
    it or refuses it; never NotImplementedError."""
    rng = np.random.default_rng(part)
    body = rng.integers(0, 256, 11 * 7 * 12, np.uint8).tobytes()
    colour = rng.integers(0, 256, 768, np.uint8).tobytes()
    seen = collections.Counter()
    for kind in _IM_KINDS[part::4]:
        for mode in im._PIL_MODES + ("Colour", "RGB image "):
            for lut in (b"", colour):
                head = im_header(kind, 11, 7) + b"Image type: %s\r\n" % (
                    mode.encode()) + (b"Lut: 1\r\n" if lut else b"")
                seen[sweep_outcome(im_file(head, body, lut=lut))] += 1
    assert "unported" not in seen and seen["pixels"] >= 50, seen


def test_mcidas_from_file_maps_its_rows():
    """Read from a file, PIL memory-maps an `L` or `I;16B` McIdas area, so
    a stride of 0 or less reads packed rows where bytes in memory refuse
    it; the port, given the path, does the same."""
    cases = _cases("MCIDAS")
    outcome = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in cases.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            try:
                want = np.asarray(Image.open(path).convert("RGBA"))
            except Exception:
                want = None
            try:
                got = textures._decode_image(path)
            except (OSError, ValueError):
                got = None
            if want is None:
                assert got is None, name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
            outcome[(want is None, pil_rgba(data) is None)] += 1
    # the negative and zero strides: pixels from a file, white in memory
    assert outcome[(False, True)] >= 1, outcome


# ----------------------------------------------------------------------------
# the sweeps
# ----------------------------------------------------------------------------

def _fuzz_base(fmt, k):
    good = [d for d in _cases(fmt).values() if pil_rgba(d) is not None]
    return good[k % len(good)]


# each plugin's sweep files that raise NotImplementedError, a part. Of each
# 300 (PIL's bytes / white, of which a refusal of the plugin's `_open` /
# NotImplementedError): FITS 106 / 194, 41 / 0; IM 116 / 184, 79 / 0;
# MCIDAS 175 / 125, 68 / 0; SPIDER 158 / 142, 54 / 0
CUT_UNPORTED = {"MCIDAS": 0, "SPIDER": 0, "FITS": 0, "IM": 0}


def cut_or_flip(rng, data: bytes, head: int = 48) -> bytes:
    """A cut (3 in 10) or 1-3 flipped bytes, half of them in the first
    `head` bytes."""
    data = bytearray(data)
    if rng.random() < 0.3:
        return bytes(data[:int(rng.integers(0, len(data)))])
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(0, min(len(data), head))) \
            if rng.random() < 0.5 else int(rng.integers(0, len(data)))
        data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
            else data[i] ^ (1 << int(rng.integers(0, 8)))
    return bytes(data)


# the header bytes that draw half the flips: FITS's first cards, IM's text
_HEAD = {"MCIDAS": 256, "SPIDER": 108, "FITS": 480, "IM": 80}


@pytest.mark.parametrize("fmt", sorted(CASES))
@pytest.mark.parametrize("part", range(6))
def test_cut_or_flipped_as_pil(fmt, part):
    """300 seeded cut or flipped files of each plugin (50 a part): PIL's
    bytes, PIL's error, or NotImplementedError; never pixels that
    differ."""
    rng = np.random.default_rng(2700 + 10 * part + sorted(CASES).index(fmt))
    seen = collections.Counter()
    for t in range(50):
        data = cut_or_flip(rng, _fuzz_base(fmt, 50 * part + t), _HEAD[fmt])
        seen[sweep_outcome(data)] += 1
    assert seen["unported"] <= CUT_UNPORTED[fmt], seen
