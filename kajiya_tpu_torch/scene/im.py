"""IFUNC Image Memory (IM) texture decoding, as PIL 12.1.0's
`ImImagePlugin` reads it (`Image.open(f).convert("RGBA")`, byte for byte).

A text header of `Key: value` lines (each at most 100 bytes, a line feed
within the first 100, one of the format's keys among them; any other line
is a refusal) up to a NUL or ^Z, then the bytes up to the ^Z (none: "File
truncated", a refusal). `Image type` names the mode and raw mode through
`OPEN` (a value not there becomes the mode itself, with the raw mode of
the last known type, "L" by default); `Image size (x*y)` the size (numbers
`int`, else `float`, reads; a value neither reads is PIL's ValueError:
white). A `Lut` line puts 768 bytes of R, G and B planes after the ^Z: on
an `L` or `P` image that is not grey it makes a `P` image of that palette,
on `LA` / `PA` a `PA` image, and otherwise only sets an attribute PIL's
load never reads. The pixels follow, bottom-up, through PIL's `raw`
decoder; `RGB3` / `RYB3` are three planes G, R, B; the `L*n` types of an
n other than 8, 16 and 32 go through PIL's `bit` decoder into `F`
(`raster.bit_decode`); `YCC` is `YCbCr`, converted as PIL converts it.
A mode and raw mode PIL has no unpacker for raises ValueError (white).
"""
from __future__ import annotations

import re

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

COMMENT, FRAMES, LUT = "Comment", "File size (no of images)", "Lut"
SCALE, SIZE, MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
TAGS = (COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name",
        SCALE, SIZE, MODE)

OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# the image modes PIL's `Image.core.new` knows; any other raises at load
_PIL_MODES = ("1", "L", "LA", "La", "P", "PA", "RGB", "RGBA", "RGBa",
              "RGBX", "CMYK", "YCbCr", "LAB", "HSV", "I", "F", "I;16",
              "I;16L", "I;16B", "I;16N")
# the raw modes PIL unpacks into RGBX, which stores and converts as RGB
_RGBX_RAW = ("RGB", "RGB;L", "RGBX;L", "R", "G", "B")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _readline(fp: Stream) -> bytes:
    end = fp.data.find(b"\n", fp.pos)
    return fp.read(-1 if end < 0 else end + 1 - fp.pos)


def _header(fp: Stream):
    """ImImageFile._open up to the tile: (info, mode, rawmode, palette or
    None, data offset)."""
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + _readline(fp)
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k != COMMENT:
            info[k] = v
        n += k in TAGS
    if not n:
        raise SyntaxError("Not an IM file")
    mode = info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if LUT in info:
        lut = fp.read(768)
        greyscale, linear = True, True
        for i in range(256):
            if lut[i] == lut[i + 256] == lut[i + 512]:
                linear = linear and lut[i] == i
            else:
                greyscale = False
        if mode in ("L", "LA", "P", "PA") and not greyscale:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = raster.planar_palette(lut)
    return info, mode, rawmode, palette, fp.tell()


def decode_im(data: bytes) -> np.ndarray:
    """IM bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("IM"):
        info, mode, rawmode, palette, offset = _header(Stream(data))
        size = info[SIZE]
        if not mode or size[0] <= 0 or size[1] <= 0:
            raise Refused("IM: no mode or size (ImageFile refuses it)")
    if not (isinstance(size, tuple) and len(size) == 2
            and all(isinstance(v, int) for v in size)):
        raise DecodeError(f"IM: size {size!r} is no pair of integers")
    w, h = size
    check_pixels(w, h)
    if mode not in _PIL_MODES:
        raise DecodeError(f"IM: unrecognized image mode {mode!r}")
    if mode == "RGBX":
        if rawmode not in _RGBX_RAW + ("RGB;T", "RYB;T"):
            raise DecodeError(f"IM: unknown raw mode {rawmode} for RGBX")
        mode = "RGB"
    if mode in ("La", "RGBa", "HSV", "I;16N"):
        raise DecodeError(f"IM: unknown raw mode {rawmode} for {mode}")
    bits = None
    if rawmode.startswith("F;"):
        try:
            bits = int(rawmode[2:])
        except ValueError:
            pass
    if bits is not None and bits not in (8, 16, 32):
        if mode != "F":
            raise DecodeError("IM: the bit decoder takes only F images")
        px = raster.bit_decode(data, offset, w, h, bits)
    elif rawmode in ("RGB;T", "RYB;T"):
        px = raster.new(mode, w, h)
        for band, at in (("G", offset), ("R", offset + w * h),
                         ("B", offset + 2 * w * h)):
            px = raster.raw_decode(data, at, mode, band, w, h, 0, -1,
                                   out=px[::-1])
    else:
        px = raster.raw_decode(data, offset, mode, rawmode, w, h, 0, -1,
                               out=raster.new(mode, w, h))
    if mode in ("P", "PA") and palette is None:
        palette = raster.palette("RGB", b"")
    return raster.to_rgba(mode, px, palette)


def encode_im_rgb(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an IM `RGB image` (line-interleaved `RGB;L`
    rows, bottom-up) PIL reads as these texels."""
    h, w, _ = img.shape
    head = (b"Image type: RGB image\r\nImage size (x*y): %d*%d\r\n"
            b"File size (no of images): 1\r\n" % (w, h))
    head += b"\0" * (511 - len(head)) + b"\x1a"
    rows = np.ascontiguousarray(img[::-1].transpose(0, 2, 1))
    return head + rows.tobytes()
