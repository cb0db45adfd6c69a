"""TIFF texture decoding: the first image of a TIFF or BigTIFF file, as PIL
12.1.0's `TiffImagePlugin` gives it (`Image.open(f).convert("RGBA")`,
byte for byte).

`_open` follows the plugin statement by statement: the header, the first
image file directory as `ImageFileDirectory_v2` reads it (its tag types,
count checks and the value rules of `_setitem`: a tag whose spec has one
value gives the first, a BYTE tag gives bytes, and so on), and `_setup`'s
mode table (`OPEN_INFO`, copied as data), size, orientation, tiles and
palette. What `_open` raises as SyntaxError, TypeError, KeyError (an
unknown compression) or IndexError is `identify.Refused`; what makes the
plugin raise otherwise (an "Invalid dimensions" ValueError, a Windows
Media Photo file) is `raster.DecodeError`, which the bake turns white.

Then the two routes of `_setup`:
- compression 1 ("raw"): PIL's `raw` decoder per strip or tile, in file
  order, with the plugin's strides (an edge tile's, planar layers as
  single-band raw modes);
- every other compression: libtiff 4.7.1 over the whole file, as PIL's
  `TiffDecode.c` drives it. The port reads the directory as libtiff does
  for the fields decoding needs, decodes each strip or tile (PackBits and
  LZW in `csrc/tiff_decoder.cpp`; deflate through `zlib`; LZMA through
  `lzma`; JPEG through `jpeg.py`'s decoder with the JPEGTables spliced in
  and libjpeg's YCbCr -> RGB), undoes the predictors as libtiff does
  (horizontal differencing at 8, 16 and 32 bits, the floating-point
  predictor), and unpacks rows with the rawmode the plugin chose.
  YCbCr that is not JPEG goes through libtiff's `TIFFRGBAImage`
  (`tif_color.c`'s integer conversion, ReferenceBlackWhite, subsampling).
After either route, `exif_transpose` applies the Orientation tag, and
`raster.to_rgba` converts the mode.

A LAB image (photometric 8) converts as PIL's LittleCMS transform does
(`lab.py`). NotImplementedError ("TIFF ..., see ROADMAP.md"): directories
or streams whose outcome in libtiff the port does not model (it never
guesses pixels).
"""
from __future__ import annotations

import ctypes
import io
import lzma
import os
import re
import struct
import threading
import zlib
from fractions import Fraction
from numbers import Number

import numpy as np

from .. import hostlib
from . import raster
from .identify import _TIFF as PREFIXES
from .identify import check_pixels, opening
from .raster import DecodeError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "tiff_decoder.cpp")
ZSTD_SOURCE = os.path.join(_PKG, "csrc", "zstd_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_zstd = None


def library() -> ctypes.CDLL:
    """The PackBits, LZW, CCITT and ThunderScan codecs, compiled at first
    use into BUILD_DIR."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostlib.load(SOURCE, "tiff_decoder", CXX, CXX_FLAGS, BUILD_DIR,
                           "the TIFF decoder")
        i64, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.kt_tiff_fax.argtypes = [ctypes.c_char_p, i64, ptr, i64, i32, i32,
                                    i32, i64, ptr, i32, i32,
                                    ctypes.POINTER(i64),
                                    ctypes.POINTER(i32)]
        lib.kt_tiff_fax.restype = i32
        lib.kt_tiff_fax_encode.argtypes = [ctypes.c_char_p, i32, i32, i64, i32,
                                           i32, ptr, i64]
        lib.kt_tiff_fax_encode.restype = i64
        lib.kt_tiff_thunder.argtypes = [ctypes.c_char_p, i64, ptr, i64, i32,
                                        i64]
        lib.kt_tiff_thunder.restype = i32
        lib.kt_tiff_thunder_encode.argtypes = [ctypes.c_char_p, i32, i32, ptr]
        lib.kt_tiff_thunder_encode.restype = i64
        lib.kt_tiff_packbits.argtypes = [ctypes.c_char_p, i64, ptr, i64]
        lib.kt_tiff_packbits.restype = ctypes.c_int
        lib.kt_tiff_lzw.argtypes = [ctypes.c_char_p, i64, ptr, i64,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.kt_tiff_lzw.restype = ctypes.c_int
        lib.kt_tiff_lzw_encode.argtypes = [ctypes.c_char_p, i64, ptr, i64]
        lib.kt_tiff_lzw_encode.restype = i64
        lib.kt_tiff_packbits_encode.argtypes = [ctypes.c_char_p, i64, ptr]
        lib.kt_tiff_packbits_encode.restype = i64
        _lib = lib
        return lib


def zstd_library() -> ctypes.CDLL:
    """The zstd decoder and encoder (`csrc/zstd_decoder.cpp`), compiled at
    first use into BUILD_DIR."""
    global _zstd
    with _lock:
        if _zstd is not None:
            return _zstd
        lib = hostlib.load(ZSTD_SOURCE, "zstd_decoder", CXX, CXX_FLAGS,
                           BUILD_DIR, "the zstd decoder")
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        lib.kt_zstd_tiff.argtypes = [ctypes.c_char_p, i64, ptr, i64, ptr]
        lib.kt_zstd_tiff.restype = ctypes.c_int
        lib.kt_zstd_encode.argtypes = [ctypes.c_char_p, i64, ptr, i64,
                                       ctypes.c_int, ctypes.c_int]
        lib.kt_zstd_encode.restype = i64
        _zstd = lib
        return lib


COMPRESSION_INFO = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
    50000: "zstd", 50001: "webp"}
# the CCITT compressions (tif_fax3.c)
_FAX = (2, 3, 4, 32771)
# the codecs whose strips libtiff's predictor undoes
_PREDICTED = (5, 8, 32946, 34925, 50000)

II, MM = b"II", b"MM"
# (ByteOrder, PhotoInterpretation, SampleFormat, FillOrder, BitsPerSample,
#  ExtraSamples) => mode, rawmode (TiffImagePlugin.OPEN_INFO)
OPEN_INFO = {
    (b'II', 0, (1,), 1, (1,), ()): ('1', '1;I'),
    (b'MM', 0, (1,), 1, (1,), ()): ('1', '1;I'),
    (b'II', 0, (1,), 2, (1,), ()): ('1', '1;IR'),
    (b'MM', 0, (1,), 2, (1,), ()): ('1', '1;IR'),
    (b'II', 1, (1,), 1, (1,), ()): ('1', '1'),
    (b'MM', 1, (1,), 1, (1,), ()): ('1', '1'),
    (b'II', 1, (1,), 2, (1,), ()): ('1', '1;R'),
    (b'MM', 1, (1,), 2, (1,), ()): ('1', '1;R'),
    (b'II', 0, (1,), 1, (2,), ()): ('L', 'L;2I'),
    (b'MM', 0, (1,), 1, (2,), ()): ('L', 'L;2I'),
    (b'II', 0, (1,), 2, (2,), ()): ('L', 'L;2IR'),
    (b'MM', 0, (1,), 2, (2,), ()): ('L', 'L;2IR'),
    (b'II', 1, (1,), 1, (2,), ()): ('L', 'L;2'),
    (b'MM', 1, (1,), 1, (2,), ()): ('L', 'L;2'),
    (b'II', 1, (1,), 2, (2,), ()): ('L', 'L;2R'),
    (b'MM', 1, (1,), 2, (2,), ()): ('L', 'L;2R'),
    (b'II', 0, (1,), 1, (4,), ()): ('L', 'L;4I'),
    (b'MM', 0, (1,), 1, (4,), ()): ('L', 'L;4I'),
    (b'II', 0, (1,), 2, (4,), ()): ('L', 'L;4IR'),
    (b'MM', 0, (1,), 2, (4,), ()): ('L', 'L;4IR'),
    (b'II', 1, (1,), 1, (4,), ()): ('L', 'L;4'),
    (b'MM', 1, (1,), 1, (4,), ()): ('L', 'L;4'),
    (b'II', 1, (1,), 2, (4,), ()): ('L', 'L;4R'),
    (b'MM', 1, (1,), 2, (4,), ()): ('L', 'L;4R'),
    (b'II', 0, (1,), 1, (8,), ()): ('L', 'L;I'),
    (b'MM', 0, (1,), 1, (8,), ()): ('L', 'L;I'),
    (b'II', 0, (1,), 2, (8,), ()): ('L', 'L;IR'),
    (b'MM', 0, (1,), 2, (8,), ()): ('L', 'L;IR'),
    (b'II', 1, (1,), 1, (8,), ()): ('L', 'L'),
    (b'MM', 1, (1,), 1, (8,), ()): ('L', 'L'),
    (b'II', 1, (2,), 1, (8,), ()): ('L', 'L'),
    (b'MM', 1, (2,), 1, (8,), ()): ('L', 'L'),
    (b'II', 1, (1,), 2, (8,), ()): ('L', 'L;R'),
    (b'MM', 1, (1,), 2, (8,), ()): ('L', 'L;R'),
    (b'II', 1, (1,), 1, (12,), ()): ('I;16', 'I;12'),
    (b'II', 0, (1,), 1, (16,), ()): ('I;16', 'I;16'),
    (b'II', 1, (1,), 1, (16,), ()): ('I;16', 'I;16'),
    (b'MM', 1, (1,), 1, (16,), ()): ('I;16B', 'I;16B'),
    (b'II', 1, (1,), 2, (16,), ()): ('I;16', 'I;16R'),
    (b'II', 1, (2,), 1, (16,), ()): ('I', 'I;16S'),
    (b'MM', 1, (2,), 1, (16,), ()): ('I', 'I;16BS'),
    (b'II', 0, (3,), 1, (32,), ()): ('F', 'F;32F'),
    (b'MM', 0, (3,), 1, (32,), ()): ('F', 'F;32BF'),
    (b'II', 1, (1,), 1, (32,), ()): ('I', 'I;32N'),
    (b'II', 1, (2,), 1, (32,), ()): ('I', 'I;32S'),
    (b'MM', 1, (2,), 1, (32,), ()): ('I', 'I;32BS'),
    (b'II', 1, (3,), 1, (32,), ()): ('F', 'F;32F'),
    (b'MM', 1, (3,), 1, (32,), ()): ('F', 'F;32BF'),
    (b'II', 1, (1,), 1, (8, 8), (2,)): ('LA', 'LA'),
    (b'MM', 1, (1,), 1, (8, 8), (2,)): ('LA', 'LA'),
    (b'II', 2, (1,), 1, (8, 8, 8), ()): ('RGB', 'RGB'),
    (b'MM', 2, (1,), 1, (8, 8, 8), ()): ('RGB', 'RGB'),
    (b'II', 2, (1,), 2, (8, 8, 8), ()): ('RGB', 'RGB;R'),
    (b'MM', 2, (1,), 2, (8, 8, 8), ()): ('RGB', 'RGB;R'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8), ()): ('RGBA', 'RGBA'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8), ()): ('RGBA', 'RGBA'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8), (0,)): ('RGB', 'RGBX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8), (0,)): ('RGB', 'RGBX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ('RGB', 'RGBXX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ('RGB', 'RGBXX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ('RGB', 'RGBXXX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ('RGB', 'RGBXXX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8), (1,)): ('RGBA', 'RGBa'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8), (1,)): ('RGBA', 'RGBa'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ('RGBA', 'RGBaX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ('RGBA', 'RGBaX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ('RGBA', 'RGBaXX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ('RGBA', 'RGBaXX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8), (2,)): ('RGBA', 'RGBA'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8), (2,)): ('RGBA', 'RGBA'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ('RGBA', 'RGBAX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ('RGBA', 'RGBAX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ('RGBA', 'RGBAXX'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ('RGBA', 'RGBAXX'),
    (b'II', 2, (1,), 1, (8, 8, 8, 8), (999,)): ('RGBA', 'RGBA'),
    (b'MM', 2, (1,), 1, (8, 8, 8, 8), (999,)): ('RGBA', 'RGBA'),
    (b'II', 2, (1,), 1, (16, 16, 16), ()): ('RGB', 'RGB;16L'),
    (b'MM', 2, (1,), 1, (16, 16, 16), ()): ('RGB', 'RGB;16B'),
    (b'II', 2, (1,), 1, (16, 16, 16, 16), ()): ('RGBA', 'RGBA;16L'),
    (b'MM', 2, (1,), 1, (16, 16, 16, 16), ()): ('RGBA', 'RGBA;16B'),
    (b'II', 2, (1,), 1, (16, 16, 16, 16), (0,)): ('RGB', 'RGBX;16L'),
    (b'MM', 2, (1,), 1, (16, 16, 16, 16), (0,)): ('RGB', 'RGBX;16B'),
    (b'II', 2, (1,), 1, (16, 16, 16, 16), (1,)): ('RGBA', 'RGBa;16L'),
    (b'MM', 2, (1,), 1, (16, 16, 16, 16), (1,)): ('RGBA', 'RGBa;16B'),
    (b'II', 2, (1,), 1, (16, 16, 16, 16), (2,)): ('RGBA', 'RGBA;16L'),
    (b'MM', 2, (1,), 1, (16, 16, 16, 16), (2,)): ('RGBA', 'RGBA;16B'),
    (b'II', 3, (1,), 1, (1,), ()): ('P', 'P;1'),
    (b'MM', 3, (1,), 1, (1,), ()): ('P', 'P;1'),
    (b'II', 3, (1,), 2, (1,), ()): ('P', 'P;1R'),
    (b'MM', 3, (1,), 2, (1,), ()): ('P', 'P;1R'),
    (b'II', 3, (1,), 1, (2,), ()): ('P', 'P;2'),
    (b'MM', 3, (1,), 1, (2,), ()): ('P', 'P;2'),
    (b'II', 3, (1,), 2, (2,), ()): ('P', 'P;2R'),
    (b'MM', 3, (1,), 2, (2,), ()): ('P', 'P;2R'),
    (b'II', 3, (1,), 1, (4,), ()): ('P', 'P;4'),
    (b'MM', 3, (1,), 1, (4,), ()): ('P', 'P;4'),
    (b'II', 3, (1,), 2, (4,), ()): ('P', 'P;4R'),
    (b'MM', 3, (1,), 2, (4,), ()): ('P', 'P;4R'),
    (b'II', 3, (1,), 1, (8,), ()): ('P', 'P'),
    (b'MM', 3, (1,), 1, (8,), ()): ('P', 'P'),
    (b'II', 3, (1,), 1, (8, 8), (0,)): ('P', 'PX'),
    (b'MM', 3, (1,), 1, (8, 8), (0,)): ('P', 'PX'),
    (b'II', 3, (1,), 1, (8, 8), (2,)): ('PA', 'PA'),
    (b'MM', 3, (1,), 1, (8, 8), (2,)): ('PA', 'PA'),
    (b'II', 3, (1,), 2, (8,), ()): ('P', 'P;R'),
    (b'MM', 3, (1,), 2, (8,), ()): ('P', 'P;R'),
    (b'II', 5, (1,), 1, (8, 8, 8, 8), ()): ('CMYK', 'CMYK'),
    (b'MM', 5, (1,), 1, (8, 8, 8, 8), ()): ('CMYK', 'CMYK'),
    (b'II', 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ('CMYK', 'CMYKX'),
    (b'MM', 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ('CMYK', 'CMYKX'),
    (b'II', 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ('CMYK', 'CMYKXX'),
    (b'MM', 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ('CMYK', 'CMYKXX'),
    (b'II', 5, (1,), 1, (16, 16, 16, 16), ()): ('CMYK', 'CMYK;16L'),
    (b'MM', 5, (1,), 1, (16, 16, 16, 16), ()): ('CMYK', 'CMYK;16B'),
    (b'II', 6, (1,), 1, (8,), ()): ('L', 'L'),
    (b'MM', 6, (1,), 1, (8,), ()): ('L', 'L'),
    (b'II', 6, (1,), 1, (8, 8, 8), ()): ('RGB', 'RGBX'),
    (b'MM', 6, (1,), 1, (8, 8, 8), ()): ('RGB', 'RGBX'),
    (b'II', 8, (1,), 1, (8, 8, 8), ()): ('LAB', 'LAB'),
    (b'MM', 8, (1,), 1, (8, 8, 8), ()): ('LAB', 'LAB'),
}
MAX_SAMPLESPERPIXEL = max(len(key[4]) for key in OPEN_INFO)

# TiffTags.TAGS_V2 of the tags the plugin reads: (length, enum); a tag not
# listed has length None
_TAGS = {
    256: (1, {}), 257: (1, {}), 258: (0, {}),
    259: (1, {"Uncompressed": 1, "CCITT 1d": 2, "Group 3 Fax": 3,
              "Group 4 Fax": 4, "LZW": 5, "JPEG": 6, "PackBits": 32773}),
    262: (1, {"WhiteIsZero": 0, "BlackIsZero": 1, "RGB": 2,
              "RGB Palette": 3, "Transparency Mask": 4, "CMYK": 5,
              "YCbCr": 6, "CieLAB": 8, "CFA": 32803, "LinearRaw": 32892}),
    266: (1, {}), 273: (0, {}), 274: (1, {}), 277: (1, {}), 278: (1, {}),
    279: (0, {}), 282: (1, {}), 283: (1, {}),
    284: (1, {"Contiguous": 1, "Separate": 2}),
    296: (1, {"none": 1, "inch": 2, "cm": 3}),
    317: (1, {"none": 1, "Horizontal Differencing": 2}),
    320: (0, {}), 322: (1, {}), 323: (1, {}), 324: (0, {}), 325: (0, {}),
    338: (0, {}), 339: (0, {}), 347: (1, {}), 529: (3, {}), 530: (2, {}),
    532: (6, {}), 700: (0, {}), 34675: (1, {})}
# bytes per value of each tag type `ImageFileDirectory_v2` loads, and the
# struct code of the plain numeric ones
_UNIT = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
         11: 4, 12: 8, 13: 4, 16: 8}
_FMT = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d", 13: "L",
        16: "Q"}
_TYPES_BYTE, _TYPES_UNDEFINED = 1, 7


class TiffError(DecodeError):
    """PIL raises while it opens or loads the TIFF: the bake turns the
    source white."""


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"TIFF {what} is not decoded (ROADMAP.md section 1)")


# ----------------------------------------------------------------------------
# the image file directory (ImageFileDirectory_v2)
# ----------------------------------------------------------------------------

def _rational(num: int, den: int):
    """IFDRational's value: a Fraction, NaN for a zero denominator (it
    hashes, compares and multiplies as PIL's does)."""
    return float("nan") if den == 0 else Fraction(num, den)


class _Ifd:
    """The first image's directory: raw (type, bytes) per tag, decoded on
    first use as `ImageFileDirectory_v2.__getitem__` decodes them."""

    def __init__(self, ifh: bytes):
        if not ifh.startswith(PREFIXES):
            raise SyntaxError(f"not a TIFF file (header {ifh!r} not valid)")
        self.prefix = ifh[:2]
        self.endian = ">" if self.prefix == MM else "<"
        self.bigtiff = ifh[2] == 43
        self.next = self.unpack("Q", ifh[8:])[0] if self.bigtiff else \
            self.unpack("L", ifh[4:])[0]
        self.raw: dict[int, tuple[int, bytes]] = {}
        self.values: dict[int, object] = {}
        self.offset = None

    def unpack(self, fmt: str, data: bytes):
        return struct.unpack(self.endian + fmt, data)

    def load(self, fp: io.BytesIO) -> None:
        self.raw, self.values = {}, {}
        self.offset = fp.tell()
        # what libtiff would read otherwise: the entry count, entries cut by
        # the end of the file, entries PIL skips or reads twice
        self.count, self.cut, self.odd = None, False, False
        big = self.bigtiff
        seen = set()
        try:
            count = self.unpack("Q" if big else "H",
                                _ensure_read(fp, 8 if big else 2))[0]
            self.count = count
            for _ in range(count):
                try:
                    entry = _ensure_read(fp, 20 if big else 12)
                except OSError:
                    self.cut = True
                    raise
                tag, typ, n, data = self.unpack("HHQ8s" if big else "HHL4s",
                                                entry)
                self.odd |= tag in seen or typ not in _UNIT
                seen.add(tag)
                if typ not in _UNIT:
                    continue            # an unsupported type is skipped
                size = n * _UNIT[typ]
                if size > (8 if big else 4):
                    here = fp.tell()
                    (offset,) = self.unpack("Q" if big else "L", data)
                    if offset >= 2 ** 63:
                        # BytesIO.seek's OverflowError escapes PIL's _open
                        raise TiffError("tag data offset out of range")
                    fp.seek(offset)
                    try:
                        data = _safe_read(fp, size)
                    except OSError:
                        self.odd = True
                        raise
                    fp.seek(here)
                else:
                    data = data[:size]
                if not data:
                    self.odd = True     # libtiff reads an empty entry
                    continue
                self.raw[tag] = (typ, data)
            (self.next,) = self.unpack("Q" if big else "L",
                                       _ensure_read(fp, 8 if big else 4))
        except OSError:
            return                      # PIL warns and keeps what it read

    def __contains__(self, tag: int) -> bool:
        return tag in self.raw

    def __getitem__(self, tag: int):
        if tag not in self.values:
            typ, data = self.raw[tag]
            self.values[tag] = self._decode(tag, typ, data)
        return self.values[tag]

    def get(self, tag: int, default=None):
        return self[tag] if tag in self.raw else default

    def _decode(self, tag: int, typ: int, data: bytes):
        if typ in (_TYPES_BYTE, _TYPES_UNDEFINED):
            v = data
        elif typ == 2:
            v = (data[:-1] if data.endswith(b"\0") else data).decode(
                "latin-1", "replace")
        elif typ in (5, 10):
            vals = self.unpack(f"{len(data) // 4}{'L' if typ == 5 else 'l'}",
                               data)
            v = tuple(_rational(a, b) for a, b in zip(vals[::2], vals[1::2]))
        else:
            v = self.unpack(f"{len(data) // _UNIT[typ]}{_FMT[typ]}", data)
        # _setitem: enums for strings, then one value or all of them
        length, enum = _TAGS.get(tag, (None, {}))
        values = [v] if isinstance(v, (Number, bytes, str)) else v
        values = tuple(enum.get(x, x) if isinstance(x, str) else x
                       for x in values)
        if length == 1 or typ == _TYPES_BYTE or \
                (length is None and len(values) == 1):
            return values[0]
        return values


def _ensure_read(fp: io.BytesIO, size: int) -> bytes:
    out = fp.read(size)
    if len(out) != size:
        raise OSError("Corrupt EXIF data")
    return out


def _safe_read(fp: io.BytesIO, size: int) -> bytes:
    if size > len(fp.getbuffer()) - fp.tell():
        raise OSError("Truncated File Read")
    return fp.read(size)


# ----------------------------------------------------------------------------
# TiffImageFile._open / _seek / _setup
# ----------------------------------------------------------------------------

class _Image:
    """What `_setup` leaves: mode, sizes, the tile list or the libtiff
    route, and the palette."""


def _open(data: bytes) -> _Image:
    fp = io.BytesIO(data)
    ifh = fp.read(8)
    if ifh[2] == 43:
        ifh += fp.read(8)
    ifd = _Ifd(ifh)
    if not ifd.next:
        raise EOFError("no more images in TIFF file")
    if ifd.next >= 2 ** 63:
        raise TiffError("Unable to seek to frame")
    fp.seek(ifd.next)
    ifd.load(fp)
    return _setup(ifd)


def _setup(ifd: _Ifd) -> _Image:
    im = _Image()
    im.ifd = ifd
    if 0xBC01 in ifd:
        raise TiffError("Windows Media Photo files not yet supported")
    im.compression = COMPRESSION_INFO[ifd.get(259, 1)]
    im.planar = ifd.get(284, 1)
    photo = ifd.get(262, 0)
    if im.compression == "tiff_jpeg":
        photo = 6
    fillorder = ifd.get(266, 1)
    try:
        xsize = ifd[256]
        ysize = ifd[257]
    except KeyError as e:
        raise TypeError("Missing dimensions") from e
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise TiffError("Invalid dimensions")
    im.tile_size = (xsize, ysize)
    im.size = (ysize, xsize) if ifd.get(274) in (5, 6, 7, 8) else \
        (xsize, ysize)
    sample_format = ifd.get(339, (1,))
    if len(sample_format) > 1 and \
            max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps_tuple = ifd.get(258, (1,))
    extra_tuple = ifd.get(338, ())
    if photo in (2, 6, 8):
        bps_count = 3
    elif photo == 5:
        bps_count = 4
    else:
        bps_count = 1
    bps_count += len(extra_tuple)
    bps_actual_count = len(bps_tuple)
    spp = ifd.get(277, 3 if im.compression == "tiff_jpeg" and photo in (2, 6)
                  else 1)
    if spp > MAX_SAMPLESPERPIXEL:
        raise SyntaxError("Invalid value for samples per pixel")
    if spp < bps_actual_count:
        bps_tuple = bps_tuple[:spp]
    elif spp > bps_actual_count and bps_actual_count == 1:
        bps_tuple = bps_tuple * spp
    if len(bps_tuple) != spp:
        raise SyntaxError("unknown data organization")
    key = (ifd.prefix, photo, sample_format, fillorder, bps_tuple,
           extra_tuple)
    try:
        im.mode, rawmode = OPEN_INFO[key]
    except KeyError as e:
        raise SyntaxError("unknown pixel mode") from e
    xres, yres = ifd.get(282, 1), ifd.get(283, 1)
    if xres and yres and ifd.get(296) == 3:
        (xres * 2.54, yres * 2.54)      # PIL's dpi; raises where it does
    im.libtiff = im.compression != "raw"
    im.tiles = []
    if im.libtiff:
        if fillorder == 2:
            key = key[:3] + (1,) + key[4:]
            im.mode, rawmode = OPEN_INFO[key]
        if photo == 6 and im.compression == "jpeg" and im.planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    elif 273 in ifd or 324 in ifd:
        if 273 in ifd:
            offsets = ifd[273]
            h = ifd.get(278, ysize)
            w = xsize
        else:
            offsets = ifd[324]
            w, h = ifd.get(322), ifd.get(323)
            if not isinstance(w, int) or not isinstance(h, int):
                raise TiffError("Invalid tile dimensions")
        if w == xsize and h == ysize and im.planar != 2:
            offsets = offsets[-1:]
        x = y = layer = 0
        for offset in offsets:
            stride = w * sum(bps_tuple) / 8 if x + w > xsize else 0
            tile_rawmode = rawmode
            if im.planar == 2:
                tile_rawmode = rawmode[layer]
                stride /= bps_count
            im.tiles.append(((x, y, min(x + w, xsize), min(y + h, ysize)),
                             offset, (tile_rawmode, int(stride))))
            x += w
            if x >= xsize:
                x, y = 0, y + h
                if y >= ysize:
                    y = 0
                    layer += 1
    else:
        raise SyntaxError("unknown data organization")
    im.rawmode = rawmode
    im.palette = None
    if im.mode in ("P", "PA"):
        im.palette = bytes(_o8(b // 256) for b in ifd[320])
    if not im.mode or im.size[0] <= 0 or im.size[1] <= 0:
        raise SyntaxError("no mode or size (PIL: not identified)")
    return im


def _o8(v) -> int:
    """PIL's o8, `bytes((v & 255,))`: TypeError for what is not an int."""
    if not isinstance(v, int):
        raise TypeError(f"cannot pack {v!r} as a palette byte")
    return v & 255


# ----------------------------------------------------------------------------
# the raw route (ImageFile.load with PIL's raw decoder)
# ----------------------------------------------------------------------------

def _load_raw(data: bytes, im: _Image) -> np.ndarray:
    xsize, ysize = im.tile_size
    img = raster.new(im.mode, xsize, ysize)
    tiles = sorted(im.tiles, key=lambda t: t[1])
    # ImageFile.load drops consecutive tiles that differ only in offset
    kept = []
    for t in tiles:
        if kept and kept[-1][0] == t[0] and kept[-1][2] == t[2]:
            kept[-1] = t
        else:
            kept.append(t)
    err = -3
    for extents, offset, (rawmode, stride) in kept:
        offset = _index(offset)
        x0, y0, x1, y1 = extents
        if x0 == 0 and x1 == 0:
            x0, y0, x1, y1 = 0, 0, xsize, ysize
        if x1 <= x0 or x1 > xsize or y1 <= y0 or y1 > ysize or x0 < 0 or \
                y0 < 0:
            raise TiffError("tile cannot extend outside image")
        try:
            img[y0:y1, x0:x1] = raster.raw_decode(
                data, offset, im.mode, rawmode, x1 - x0, y1 - y0, stride,
                out=img[y0:y1, x0:x1])
        except raster.StrideError:
            err = -8                    # IMAGING_CODEC_CONFIG, tile skipped
            continue
        err = 0
    if err < 0:
        raise TiffError(f"decoder error {err}")
    return img


def _index(v) -> int:
    """fp.seek's argument: an integer (PIL raises TypeError otherwise)."""
    if isinstance(v, (bool, int, np.integer)):
        return int(v)
    raise TiffError(f"tile offset {v!r} is not an integer")


# ----------------------------------------------------------------------------
# the libtiff route (TiffDecode.c over libtiff 4.7.1)
# ----------------------------------------------------------------------------

class _Dir:
    """The fields libtiff's TIFFReadDirectory gives the decoder, read from
    the same directory; a field in a form whose libtiff reading the port
    does not model raises NotImplementedError."""

    def __init__(self, ifd: _Ifd, data: bytes):
        self.ifd = ifd
        # TIFFClientOpen's header checks, which PIL's prefixes do not make
        version = struct.unpack_from(ifd.endian + "H", data, 2)[0]
        if version not in (42, 43) or (version == 43 and struct.unpack_from(
                ifd.endian + "HH", data, 4) != (8, 0)):
            raise TiffError("libtiff: not a TIFF file (bad version)")
        # TIFFFetchDirectory: a count of 1 to 4096 entries, all in the file
        if ifd.count is None or not 0 < ifd.count <= 4096 or ifd.cut:
            raise TiffError("libtiff cannot read the directory")
        if ifd.odd:
            raise _unported("a directory with entries PIL skips or repeats")
        self.width = self.scalar(256, required=True)
        self.length = self.scalar(257, required=True)
        self.spp = self.scalar(277, 1)
        self.bps = self.per_sample(258, 1)
        self.compression = self.scalar(259, 1)
        self.photometric = self.scalar(262, None)
        self.planar = self.scalar(284, 1)
        self.fillorder = self.scalar(266, 1)
        self.predictor = self.scalar(317, 1)
        self.sampleformat = self.per_sample(339, 1)
        if self.photometric == 6 and self.planar == 1 and 530 in ifd and \
                any(v not in (1, 2, 4) for v in self.entry(530)):
            raise TiffError("libtiff: invalid YCbCr subsampling")
        if self.planar not in (1, 2):
            raise TiffError("libtiff: bad PlanarConfiguration")
        if self.fillorder not in (1, 2) or self.width <= 0 or \
                self.length <= 0 or self.spp <= 0:
            raise _unported("directory values outside libtiff's checks")
        if self.photometric == 3 and (320 not in ifd or len(self.entry(320))
                                      != 3 << self.bps):
            raise TiffError("libtiff: missing required Colormap")
        self.tiled = 322 in ifd or 323 in ifd or 324 in ifd or 325 in ifd
        if self.tiled:
            self.tw = self.scalar(322, required=True)
            self.th = self.scalar(323, required=True)
            if self.tw <= 0 or self.th <= 0:
                raise _unported("an empty tile size")
            across = -(-self.width // self.tw)
            down = -(-self.length // self.th)
            n = across * down
            self.across = across
        else:
            rps = self.scalar(278, 2 ** 32 - 1)
            if rps <= 0:
                raise _unported("a zero RowsPerStrip")
            self.rps = rps
            n = -(-self.length // rps) if rps < 2 ** 32 - 1 else 1
        self.per_plane = n
        if self.planar == 2:
            n *= self.spp
        self.offsets = self.array(324 if self.tiled else 273, n)
        self.counts = self.array(325 if self.tiled else 279, n)
        if self.counts[0] == 0 and self.offsets[0] != 0:
            raise _unported("StripByteCounts that libtiff re-estimates")
        self.extra = ifd.get(338, ())
        if 338 in ifd and ifd.raw[338][0] != 3:
            raise _unported("an ExtraSamples tag of another type")

    def entry(self, tag):
        typ, data = self.ifd.raw[tag]
        ints = (3, 4, 16) if self.ifd.bigtiff else (3, 4)
        if typ not in ints:
            raise _unported(f"tag {tag} of type {typ}")
        return self.ifd.unpack(f"{len(data) // _UNIT[typ]}{_FMT[typ]}", data)

    def scalar(self, tag, default=None, required=False):
        if tag not in self.ifd:
            if required:
                raise _unported(f"a directory without tag {tag}")
            return default
        v = self.entry(tag)
        if len(v) != 1:
            raise _unported(f"tag {tag} with {len(v)} values")
        return v[0]

    def per_sample(self, tag, default):
        if tag not in self.ifd:
            return default
        v = self.entry(tag)
        if len(v) not in (1, self.spp) or len(set(v)) != 1:
            raise _unported(f"tag {tag} with values that differ per sample")
        return v[0]

    def array(self, tag, n):
        if tag not in self.ifd:
            raise _unported(f"a directory without tag {tag}")
        v = self.entry(tag)
        if len(v) != n:
            raise _unported(f"tag {tag} with {len(v)} values for {n}")
        return v

    def row_size(self, width: int) -> int:
        """TIFFScanlineSize / TIFFTileRowSize of `width` pixels."""
        s = self.spp if self.planar == 1 else 1
        return (width * self.bps * s + 7) // 8


def _read_segment(data: bytes, d: _Dir, i: int, size: int,
                  state: dict | None = None) -> bytes:
    """TIFFFillStrip / TIFFFillTile's raw bytes of strip or tile i (its
    file offset kept in `state`: the RLEW codec aligns to even addresses,
    and PIL's buffer holds the file from one)."""
    offset, count = d.offsets[i], d.counts[i]
    if state is not None:
        state["offset"] = offset
    if count == 0:
        raise TiffError(f"invalid byte count of strip or tile {i}")
    if count > 1024 * 1024 and size and (count - 4096) // 10 > size:
        count = size * 10 + 4096
    if count > len(data) or offset > len(data) - count:
        raise TiffError(f"read error on strip or tile {i}")
    raw = data[offset:offset + count]
    if d.fillorder == 2 and d.compression != 7:
        raw = raster.REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    return raw


def _decode_segment(raw: bytes, d: _Dir, occ: int, state: dict,
                    seg: tuple = (0, 0)) -> bytes:
    """One codec call of occ bytes (TIFFReadEncodedStrip / Tile); `seg` is
    the strip's or tile's (width, rows), which the JPEG codec checks."""
    comp = d.compression
    if comp == 7:
        return _decode_jpeg_segment(raw, d, occ, state, seg)
    if comp == 32773:
        out = np.empty(occ, np.uint8)
        if library().kt_tiff_packbits(raw, len(raw), out.ctypes.data, occ):
            raise TiffError("PackBits: not enough data")
        return out.tobytes()
    if comp == 5:
        out = np.empty(occ, np.uint8)
        compat = ctypes.c_int(state.get("compat", 0))
        st = library().kt_tiff_lzw(raw, len(raw), out.ctypes.data, occ,
                                   ctypes.byref(compat))
        state["compat"] = compat.value
        if st:
            raise TiffError("LZW: corrupt or short data")
        return out.tobytes()
    if comp in _FAX:
        return _decode_fax(raw, d, occ, state, seg)
    if comp == 32809:
        return _decode_thunder(raw, d, occ)
    if comp == 50000:
        out = np.empty(occ, np.uint8)
        bufs = state.setdefault("zstd", (ctypes.c_longlong * 3)())
        st = zstd_library().kt_zstd_tiff(raw, len(raw), out.ctypes.data, occ,
                                         bufs)
        if st == 2:
            raise _unported("zstd data whose outcome in libzstd is not "
                            "modelled")
        if st:
            raise TiffError("zstd: corrupt or short data")
        return out.tobytes()
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, occ)
        except zlib.error as e:
            raise TiffError(f"deflate: {e}") from e
    elif comp == 34925:
        out = _lzma(raw, occ)
    else:
        raise TiffError(f"compression {comp} has no decoder in libtiff")
    if len(out) < occ:
        raise TiffError("not enough data")
    return out


def _decode_fax(raw, d, occ, state, seg):
    """Fax3DecodeRLE / Fax3Decode1D / Fax3Decode2D / Fax4Decode into PIL's
    strip or tile buffer, which outlives the segment: Group 4 data that
    ends early (an EOFB, the end of the data), and a tile whose codec fails
    (TIFFReadEncodedTile takes its -1 for success), leave the rows after it
    as the previous segment left them. The run arrays and Group 3's
    no-EOL mode outlive the segment too, as libtiff's do."""
    if d.bps != 1:
        raise TiffError("Bits/sample must be 1 for Group 3/4")
    if d.spp != 1 and d.planar == 1:
        raise TiffError("Samples/pixel shall be 1 for Group 3/4")
    width = seg[0]
    rowbytes = d.row_size(width)
    opts = d.scalar(292, 0) if d.compression == 3 else 0
    two_d = d.compression == 4 or (d.compression == 3 and opts & 1)
    if "fax" not in state:
        nruns = -(-(width + 1) // 32) * 32 * (2 if two_d else 1)
        state["fax"] = (np.zeros(2 * nruns + 2, np.uint32), nruns)
        state["buf"], state["defined"] = np.zeros(0, np.uint8), 0
    runs, nruns = state["fax"]
    noeol = state.setdefault("noeol", ctypes.c_int(0))
    if state["buf"].size < occ:
        grown = np.zeros(occ, np.uint8)
        grown[:state["buf"].size] = state["buf"]
        state["buf"] = grown
    buf = state["buf"]
    rows = ctypes.c_longlong()
    st = library().kt_tiff_fax(raw, len(raw), buf.ctypes.data, occ,
                               d.compression, opts, width, rowbytes,
                               runs.ctypes.data, nruns,
                               state.get("offset", 0) & 1, ctypes.byref(rows),
                               ctypes.byref(noeol))
    if st == 2:
        raise _unported("CCITT data that libtiff decodes against memory "
                        "before its run arrays")
    if st and not d.tiled:
        # TIFFReadEncodedTile takes the codec's -1 for success
        raise TiffError("CCITT: premature end or corrupt data")
    written = min(rows.value * rowbytes, occ)
    if written < occ and occ > state["defined"]:
        raise _unported("CCITT data that ends before the strip or tile, "
                        "whose rows PIL's buffer left undefined")
    state["defined"] = max(state["defined"], written)
    return buf[:occ].tobytes()


def _decode_thunder(raw, d, occ):
    """ThunderDecodeRow: one ThunderDecode a row of ImageWidth pixels."""
    if d.bps != 4:
        raise TiffError("the Thunder decoder only supports 4 bits a sample")
    if d.tiled:
        raise _unported("tiled ThunderScan (libtiff decodes rows of the "
                        "image's width into the tile)")
    out = np.zeros(occ, np.uint8)
    if library().kt_tiff_thunder(raw, len(raw), out.ctypes.data, occ,
                                 d.width, d.row_size(d.width)):
        raise TiffError("ThunderScan: not enough or too much data")
    return out.tobytes()


def _lzma(raw: bytes, occ: int) -> bytes:
    """LZMADecode: one lzma_code run of the .xz stream into occ bytes. An
    error after the output is full (a damaged check or index) goes unseen,
    so on an error the stream is fed again a byte at a time to learn how
    much came out before it; data short of occ bytes is libtiff's error.
    Where a byte's call fails, libtiff may have kept that call's output:
    NotImplementedError."""
    try:
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw, occ)
    except lzma.LZMAError:
        pass
    dec, out = lzma.LZMADecompressor(lzma.FORMAT_XZ), bytearray()
    try:
        for i in range(len(raw)):
            out += dec.decompress(raw[i:i + 1], occ - len(out))
            if len(out) >= occ:
                break
    except lzma.LZMAError as e:
        # the call that meets the error may also have filled the output,
        # which libtiff then keeps: the port cannot tell
        raise _unported("LZMA data with an error near its end") from e
    return bytes(out[:occ])


def _check_predictor(d: _Dir) -> None:
    """PredictorSetupDecode: the codecs with a predictor (LZW, deflate,
    LZMA) refuse what they cannot undo."""
    if d.compression not in _PREDICTED or d.predictor == 1:
        return
    if d.predictor == 2:
        if d.bps not in (8, 16, 32, 64):
            raise TiffError("horizontal differencing of this sample size")
    elif d.predictor == 3:
        if d.sampleformat != 3 or d.bps not in (16, 24, 32, 64):
            raise TiffError("floating point predictor of this format")
        if d.bps != 32:
            raise _unported("the floating point predictor at "
                            f"{d.bps} bits")
    else:
        raise TiffError(f"predictor {d.predictor} is not supported")


def _post_decode(buf: bytes, d: _Dir, rowsize: int, order: str) -> np.ndarray:
    """The predictor's accumulation per row, and the swab of 16 / 32-bit
    samples to the host's (little-endian) order: (rows, rowsize) uint8."""
    rows = np.frombuffer(buf, np.uint8).reshape(-1, rowsize)
    stride = d.spp if d.planar == 1 else 1
    pred = d.predictor if d.compression in _PREDICTED else 1
    nb = d.bps // 8 if d.bps in (16, 24, 32, 64) else 1
    if pred == 3:
        return _fp_acc(rows, nb, stride)
    if nb > 1 and order == ">":
        if d.bps == 24:
            rows = rows.reshape(rows.shape[0], -1, 3)[..., ::-1].reshape(
                rows.shape[0], -1)
        else:
            dt = {2: "u2", 4: "u4", 8: "u8"}[nb]
            rows = rows.view(">" + dt).astype("<" + dt).view(np.uint8)
    if pred == 2:
        if (rowsize % (nb * stride)) != 0:
            raise TiffError("(cc%stride)!=0")
        dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[nb]
        v = rows.view("<" + np.dtype(dt).str[1:]).reshape(rows.shape[0], -1,
                                                          stride)
        v = np.cumsum(v, axis=1, dtype=dt)
        rows = v.reshape(rows.shape[0], -1).view(np.uint8)
    return rows


def _fp_acc(rows: np.ndarray, nb: int, stride: int) -> np.ndarray:
    """fpAcc: byte-wise accumulation over the row, then the byte planes
    (most significant first) gathered back into little-endian samples."""
    h, cc = rows.shape
    if cc % (nb * stride) != 0:
        raise TiffError("cc%(bps*stride))!=0")
    wc = cc // nb
    v = rows.reshape(h, -1, stride)
    v = np.cumsum(v, axis=1, dtype=np.uint8).reshape(h, cc)
    planes = v.reshape(h, nb, wc)[:, ::-1, :]        # least significant first
    return np.ascontiguousarray(planes.transpose(0, 2, 1)).reshape(h, cc)


def _plane_unpack(rows, mode, band, bps, w, out):
    """A planar layer's band unpacker: 8-bit samples, or the high byte of
    native 16-bit ones, written into `band` (LA / PA keep their second
    plane in a band that convert never reads)."""
    if bps == 16:
        v = rows[:, :2 * w].reshape(-1, w, 2)[..., 1]
    elif bps == 8:
        v = rows[:, :w]
    else:
        raise TiffError(f"no planar unpacker for {bps}-bit {mode}")
    out = out.copy()
    if mode in ("LA", "PA"):
        if band == 0:
            out[..., 0] = v
        return out
    out[..., band] = v
    return out


def _load_libtiff(data: bytes, im: _Image) -> np.ndarray:
    d = _Dir(im.ifd, data)
    if (d.width, d.length) != im.tile_size:
        raise TiffError("libtiff's size differs")
    if d.compression == 6:
        return _load_ojpeg(data, im, d)
    if d.photometric == 6 and not (d.compression == 7 and d.planar == 1):
        return _load_ycbcr(data, im, d)
    _check_predictor(d)
    mode, rawmode = im.mode, im.rawmode
    order = ">" if im.ifd.prefix == MM else "<"
    xsize, ysize = im.tile_size
    bits = raster.raw_bits(mode, rawmode)
    # TiffDecode.c reads a separate-plane file as one plane per band of
    # the image mode
    planes = raster.BANDS[mode] if d.planar == 2 else 1
    img = raster.new(mode, xsize, ysize)
    state: dict = {}
    if d.compression == 7:
        _jpeg_setup(data, d, state)

    def put(rows, y, x, n, plane):
        region = img[y:y + rows.shape[0], x:x + n]
        if planes == 1:
            img[y:y + rows.shape[0], x:x + n] = raster.unpack(
                rows, rawmode, mode, n, region)
        else:
            img[y:y + rows.shape[0], x:x + n] = _plane_unpack(
                rows, mode, plane, d.bps, n, region)

    if d.tiled:
        rowsize = d.row_size(d.tw)
        tilesize = rowsize * d.th
        if rowsize == 0 or tilesize > ((d.th * bits // planes + 7) // 8) * d.tw:
            raise TiffError("tile size")
        for y in range(0, ysize, d.th):
            for plane in range(planes):
                for x in range(0, xsize, d.tw):
                    i = (y // d.th) * d.across + x // d.tw + \
                        plane * d.per_plane
                    raw = _read_segment(data, d, i, tilesize, state)
                    rows = _post_decode(_decode_segment(raw, d, tilesize,
                                                        state, (d.tw, d.th)),
                                        d, rowsize, order)
                    n = min(d.tw, xsize - x)
                    m = min(d.th, ysize - y)
                    put(rows[:m], y, x, n, plane)
    else:
        rps = d.rps if d.rps < 2 ** 32 - 1 else ysize
        rowsize = d.row_size(xsize)
        if rowsize < (xsize * bits // planes + 7) // 8:
            raise TiffError("unpacker row size")
        if rps >= 2 ** 31:
            # TiffDecode.c sizes its strip buffer from RowsPerStrip in a
            # signed int: from 2^31 it fails (IMAGING_CODEC_MEMORY or
            # _BROKEN)
            raise TiffError("decoder error -9")
        stripsize = rowsize * min(rps, ysize)
        for y in range(0, ysize, rps):
            for plane in range(planes):
                i = y // rps + plane * d.per_plane
                nrows = min(rps, ysize - y)
                raw = _read_segment(data, d, i, stripsize, state)
                rows = _post_decode(_decode_segment(raw, d, nrows * rowsize,
                                                    state, (xsize, nrows)),
                                    d, rowsize, order)
                put(rows, y, 0, xsize, plane)
    if planes > 3 and mode == "RGBA":
        extra = d.extra if d.extra else (0,) * (d.spp - 3)
        if extra and extra[0] in (0, 1):
            img = raster.unpremultiply(img)
    return img


def _sof(stream: bytes):
    """The first frame header of a JPEG stream: (width, height, precision,
    [(id, h, v)]), or None where a scan or the end comes first."""
    i = 2
    while i + 4 <= len(stream):
        if stream[i] != 0xFF:
            i += 1
            continue
        m = stream[i + 1]
        if m in (0xFF, 0x00) or 0xD0 <= m <= 0xD8 or m == 0x01:
            i += 1 if m == 0xFF else 2
            continue
        if m in (0xD9, 0xDA):
            return None
        n = (stream[i + 2] << 8) | stream[i + 3]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            f = stream[i + 4:i + 2 + n]
            if len(f) < 6:
                return None
            nc = f[5]
            comps = [(f[6 + 3 * k], f[7 + 3 * k] >> 4, f[7 + 3 * k] & 15)
                     for k in range(nc) if 8 + 3 * k < len(f)]
            return ((f[3] << 8) | f[4], (f[1] << 8) | f[2], f[0], comps)
        i += 2 + n
    return None


def _table_slots(stream: bytes) -> dict:
    """The DQT and DHT tables of a JPEG stream before its first scan, each
    as a segment of its own, by slot (marker, table id): a later table
    replaces an earlier one in its slot, as in libjpeg. Only a stream that
    libjpeg has read is split, so its segments hold whole tables."""
    out, i = {}, 2
    while i + 4 <= len(stream) and stream[i] == 0xFF:
        m = stream[i + 1]
        if m == 0xDA or 0xD0 <= m <= 0xD9:
            break
        n = (stream[i + 2] << 8) | stream[i + 3]
        body, pos = stream[i + 4:i + 2 + n], 0
        while m in (0xDB, 0xC4) and pos < len(body):
            if m == 0xDB:       # precision (any but 0: 16 bits), table id
                size = 1 + 64 * (2 if body[pos] >> 4 else 1)
                slot = body[pos] & 15
            else:               # class and table id
                size = 17 + sum(body[pos + 1:pos + 17])
                slot = body[pos]
            if pos + size > len(body):
                raise _unported("a JPEG table segment libjpeg may split "
                                "otherwise")
            out[(m, slot)] = bytes((0xFF, m)) + \
                (size + 2).to_bytes(2, "big") + body[pos:pos + size]
            pos += size
        i += 2 + n
    return out


def _jpeg_setup(data: bytes, d: _Dir, state: dict) -> None:
    """JPEGPreDecode's fixed part: the JPEGTables stream, the colour mode
    (YCbCr is converted to RGB, anything else kept as coded) and the
    sampling of component 0 (the YCbCrSubSampling tag; without one,
    JPEGFixupTags reads it from the first strip or tile)."""
    tables = b""
    if 347 in d.ifd:
        typ, tables = d.ifd.raw[347]
        if typ != _TYPES_UNDEFINED or not tables.startswith(b"\xff\xd8") \
                or not tables.endswith(b"\xff\xd9"):
            raise _unported("a JPEGTables tag libjpeg may not read")
    if d.bps != 8:
        raise _unported(f"{d.bps}-bit JPEG")
    ycc = d.photometric == 6
    hs = vs = 1
    if ycc and 530 in d.ifd:
        # a YCbCrSubSampling tag is taken as it is
        hs, vs = d.entry(530)
    elif ycc:
        first = _read_segment(data, d, 0, 0)
        sof = _sof(first)
        if sof is None or len(sof[3]) != 3 or sof[3][0][1] not in (1, 2, 4) \
                or sof[3][0][2] not in (1, 2, 4) or \
                any(c[1:] != (1, 1) for c in sof[3][1:]):
            raise _unported("JPEG subsampling libtiff does not fix up")
        hs, vs = sof[3][0][1], sof[3][0][2]
    state["jpeg"] = (tables, 1 if ycc else 2, hs, vs)


def _decode_jpeg_segment(raw, d, occ, state, seg):
    """JPEGDecode: the strip or tile as a JPEG stream after the tables,
    decoded by libjpeg into rows of the scanline size libtiff expects."""
    from .jpeg import JpegError, decode_jpeg_stream

    tables, color, hs, vs = state["jpeg"]
    seg_w, seg_h = seg
    if not raw.startswith(b"\xff\xd8"):
        raise TiffError("JPEG strip or tile without SOI")
    # libtiff keeps one decompressor for the image: the tables of the
    # JPEGTables stream and of every strip or tile decoded before this one
    # stay defined (the last table in each slot)
    carried = state.setdefault("carried", {})
    stream = raw[:2] + tables[2:-2] + b"".join(carried.values()) + \
        raw[2:] + b"\xff\xd9"
    sof = _sof(stream)
    if sof is None:
        raise TiffError("JPEG strip or tile without a frame header")
    jw, jh, prec, comps = sof
    ncomp = d.spp if d.planar == 1 else 1
    if (jw, jh) != (seg_w, seg_h):
        if jw > seg_w or jh > seg_h:
            if not (jw == seg_w and not d.tiled):
                raise TiffError("JPEG strip or tile larger than expected")
        raise _unported("a JPEG strip or tile of another size")
    if len(comps) != ncomp or ncomp not in (1, 3):
        raise TiffError("improper JPEG component count")
    if prec != d.bps:
        raise TiffError("improper JPEG data precision")
    if d.planar == 1:
        if comps[0][1:] != (hs, vs) or any(c[1:] != (1, 1)
                                           for c in comps[1:]):
            raise TiffError("improper JPEG sampling factors")
    try:
        px = decode_jpeg_stream(stream, color)
    except JpegError as e:
        raise TiffError(f"JPEG: {e}") from e
    carried.update(_table_slots(raw))
    out = px[..., :ncomp].tobytes()
    if len(out) != occ:
        raise _unported("a JPEG strip whose rows differ from the scanline")
    return out


# ----------------------------------------------------------------------------
# old-style JPEG (tif_ojpeg.c)
# ----------------------------------------------------------------------------

class _OjpegSource:
    """OJPEGReadBufferFill's bytes: the JPEGInterchangeFormat block, then
    each strip with a file offset, as one stream read a byte at a time; a
    skip stops at the end of its block."""

    def __init__(self, blocks):
        self.blocks, self.k, self.pos = blocks, 0, 0

    def _next(self):
        while self.k < len(self.blocks) and \
                self.pos >= len(self.blocks[self.k][1]):
            self.k, self.pos = self.k + 1, 0
        return self.k < len(self.blocks)

    def peek(self):
        if not self._next():
            raise TiffError("old-style JPEG: premature end of data")
        return self.blocks[self.k][1][self.pos]

    def byte(self):
        v = self.peek()
        self.pos += 1
        return v

    def word(self):
        return (self.byte() << 8) | self.byte()

    def block(self, n):
        return bytes(self.byte() for _ in range(n))

    def skip(self, n):
        if self._next():
            self.pos += min(n, len(self.blocks[self.k][1]) - self.pos)

    def rest(self):
        """The compressed data after the scan header, with OJPEG's RSTn
        between strips and EOI after the last."""
        out, rst = bytearray(), 0
        self._next()
        for k in range(self.k, len(self.blocks)):
            kind, b = self.blocks[k]
            out += b[self.pos:] if k == self.k else b
            if kind == "strip" and k + 1 < len(self.blocks):
                out += bytes((0xFF, 0xD0 + rst))
                rst = (rst + 1) % 8
        return bytes(out) + b"\xff\xd9"


def _ojpeg_blocks(data: bytes, d: _Dir, strips: int) -> list:
    """OJPEGReadBufferFill's sources: the JPEGInterchangeFormat block (its
    length cut to the file), then each strip's bytes (to the file's end
    where its count is 0). A strip libtiff skips (offset 0 or past the
    file) changes where it writes RSTn and EOI: not modelled."""
    size = len(data)
    blocks = []
    jif, jifl = d.scalar(513, 0), d.scalar(514, 0)
    if jif and jif < size:
        if jifl == 0 or jif + jifl > size:
            jifl = size - jif
        blocks.append(("jif", data[jif:jif + jifl]))
    for i in range(strips):
        pos, count = d.offsets[i], d.counts[i]
        if pos == 0 or pos >= size:
            raise _unported("an old-style JPEG strip libtiff skips")
        togo = size - pos if count == 0 else min(count, size - pos)
        blocks.append(("strip", data[pos:pos + togo]))
    return blocks


def _ojpeg_sof_sampling(blocks, hor, ver):
    """OJPEGSubsamplingCorrect's pass over the markers: the first frame
    header's sampling of component 0, and whether libjpeg must upsample
    (a factor libtiff's subsampling cannot hold)."""
    src = _OjpegSource(blocks)
    try:
        while src.peek() == 0xFF:
            src.byte()
            m = src.byte()
            while m == 0xFF:
                m = src.byte()
            if m == 0xD8:
                continue
            if m in (0xC4, 0xDB, 0xDD, 0xFE) or 0xE0 <= m <= 0xEF:
                n = src.word()
                if n < 2 or (m in (0xC4, 0xDB) and n <= 2):
                    return hor, ver, False
                if m == 0xDD:
                    if n != 4:
                        return hor, ver, False
                    src.word()
                else:
                    src.skip(n - 2)
                continue
            if m in (0xC0, 0xC1, 0xC3):
                n = src.word()
                if n < 11 or (n - 8) % 3 or src.byte() != 8:
                    return hor, ver, False
                src.skip(4)
                k = (n - 8) // 3
                if src.byte() != k:
                    return hor, ver, False
                force = False
                for q in range(k):
                    src.byte()
                    o = src.byte()
                    if q == 0:
                        hor, ver = o >> 4, o & 15
                        force |= hor not in (1, 2, 4) or ver not in (1, 2, 4)
                    elif o != 0x11:
                        force = True
                    src.byte()
                return hor, ver, force
            return hor, ver, False
    except TiffError:
        pass
    return hor, ver, False


def _ojpeg_stream(data, d, blocks, spp, hor, ver, restart):
    """OJPEGReadHeaderInfoSec and OJPEGWriteStream: the JPEG stream libjpeg
    reads, from the markers of the data or from the tables tags."""
    err = TiffError
    src = _OjpegSource(blocks)
    qt, dc, ac = {}, {}, {}
    sof = sos = None
    while src.peek() == 0xFF:
        src.byte()
        m = src.byte()
        while m == 0xFF:
            m = src.byte()
        if m == 0xD8:
            continue
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            n = src.word()
            if n < 2:
                raise err("old-style JPEG: corrupt JPEG data")
            if n > 2:
                src.skip(n - 2)
        elif m == 0xDD:
            if src.word() != 4:
                raise err("old-style JPEG: corrupt DRI marker")
            restart = src.word()
        elif m == 0xDB:
            n = src.word()
            if n <= 2:
                raise err("old-style JPEG: corrupt DQT marker")
            n -= 2
            while n > 0:
                if n < 65:
                    raise err("old-style JPEG: corrupt DQT marker")
                body = src.block(65)
                if body[0] & 15 > 3:
                    raise err("old-style JPEG: corrupt DQT marker")
                if body[0] >> 4:
                    raise _unported("an old-style JPEG 16-bit table")
                qt[body[0] & 15] = b"\xff\xdb\x00\x43" + body
                n -= 65
        elif m == 0xC4:
            n = src.word()
            if n <= 2:
                raise err("old-style JPEG: corrupt DHT marker")
            body = src.block(n - 2)
            o = body[0] if body else 0
            table = b"\xff\xc4" + n.to_bytes(2, "big") + body
            if o & 0xF0 == 0 and o <= 3:
                dc[o] = table
            elif o & 0xF0 == 16 and o & 15 <= 3:
                ac[o & 15] = table
            else:
                raise err("old-style JPEG: corrupt DHT marker")
        elif m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise err("old-style JPEG: corrupt JPEG data")
            n = src.word()
            if n < 11 or (n - 8) % 3:
                raise err("old-style JPEG: corrupt SOF marker")
            k = (n - 8) // 3
            if k != spp:
                raise err("old-style JPEG: unexpected number of samples")
            if src.byte() != 8:
                raise err("old-style JPEG: unexpected bits per sample")
            y, x = src.word(), src.word()
            if y < d.length:
                raise err("old-style JPEG: unexpected height")
            if x < d.width:
                raise err("old-style JPEG: unexpected width")
            if x > d.width:
                raise err("old-style JPEG: width exceeds the image's")
            if src.byte() != k:
                raise err("old-style JPEG: corrupt SOF marker")
            comps = []
            for q in range(k):
                c, hv, tq = src.byte(), src.byte(), src.byte()
                if q == 0 and (hv >> 4, hv & 15) != (hor, ver):
                    raise err("old-style JPEG: unexpected sampling factor")
                if q and hv != 0x11:
                    raise err("old-style JPEG: unexpected sampling factor")
                comps.append((c, hv, tq))
            sof = (m, y, x, comps)
        elif m == 0xDA:
            if sof is None:
                raise err("old-style JPEG: corrupt SOS marker")
            if src.word() != 6 + 2 * spp or src.byte() != spp:
                raise err("old-style JPEG: corrupt SOS marker")
            sos = [(src.byte(), src.byte()) for _ in range(spp)]
            src.skip(3)
            break
        else:
            raise err(f"old-style JPEG: unknown marker {m:#x}")
    if sof is None:
        sof, sos = _ojpeg_tables(data, d, spp, hor, ver, qt, dc, ac)
    elif sos is None:
        raise err("old-style JPEG: no scan header")
    if sof[0] == 0xC3:
        raise _unported("a lossless old-style JPEG")
    marker, y, x, comps = sof
    out = bytearray(b"\xff\xd8")
    for t in (qt, dc, ac):
        for k in range(4):
            out += t.get(k, b"")
    if restart:
        out += bytes((0xFF, 0xDD, 0, 4, restart >> 8 & 255, restart & 255))
    out += bytes((0xFF, marker, 0, 8 + 3 * spp, 8, y >> 8 & 255, y & 255,
                  x >> 8 & 255, x & 255, spp))
    for c in comps:
        out += bytes(c)
    out += bytes((0xFF, 0xDA, 0, 6 + 2 * spp, spp))
    for c in sos:
        out += bytes(c)
    out += b"\x00\x3f\x00"
    return bytes(out) + src.rest()


def _ojpeg_tables(data, d, spp, hor, ver, qt, dc, ac):
    """OJPEGReadHeaderInfoSecTables*: DQT and DHT segments built from the
    JPEGQTables, JPEGDCTables and JPEGACTables offsets, and the frame and
    scan headers libtiff writes for them."""
    def offsets(tag):
        v = tuple(d.entry(tag)) if tag in d.ifd else ()
        if len(v) > 3:
            raise _unported(f"tag {tag} with {len(v)} values")
        return v + (0,) * (spp - len(v)) if len(v) < spp else v

    def read(off, n):
        if off + n > len(data):
            raise TiffError("old-style JPEG: table past the file's end")
        return data[off:off + n]

    q_off, dc_off, ac_off = offsets(519), offsets(520), offsets(521)
    if not q_off or not q_off[0] or not dc_off or not dc_off[0] or \
            not ac_off or not ac_off[0]:
        raise TiffError("old-style JPEG: missing JPEG tables")
    tq, tda = [0] * spp, [0] * spp
    for m in range(spp):
        if q_off[m] and (m == 0 or q_off[m] != q_off[m - 1]):
            if any(q_off[m] == q_off[n] for n in range(m - 1)):
                raise TiffError("old-style JPEG: corrupt JPEGQTables")
            qt[m] = b"\xff\xdb\x00\x43" + bytes((m,)) + read(q_off[m], 64)
            tq[m] = m
        else:
            tq[m] = tq[m - 1]
    for tables, offs, cls in ((dc, dc_off, 0), (ac, ac_off, 1)):
        for m in range(spp):
            if offs[m] and (m == 0 or offs[m] != offs[m - 1]):
                if any(offs[m] == offs[n] for n in range(m - 1)):
                    raise TiffError("old-style JPEG: corrupt Huffman tables")
                counts = read(offs[m], 16)
                q = sum(counts)
                syms = read(offs[m] + 16, q)
                tables[m] = b"\xff\xc4" + (19 + q).to_bytes(2, "big") + \
                    bytes((cls << 4 | m,)) + counts + syms
                tda[m] = (m << 4) if cls == 0 else tda[m] | m
            elif cls == 0:
                tda[m] = tda[m - 1]
            else:
                tda[m] = tda[m] | (tda[m - 1] & 15)
    comps = [(o, (hor << 4 | ver) if o == 0 else 0x11, tq[o])
             for o in range(spp)]
    sos = [(o, tda[o]) for o in range(spp)]
    return (0xC0, d.length, d.width, comps), sos


def _load_ojpeg(data: bytes, im: _Image, d: _Dir) -> np.ndarray:
    """Old-style JPEG as libtiff's tif_ojpeg.c decodes it under PIL: the
    JPEG stream OJPEG writes for libjpeg (the JPEGInterchangeFormat block
    and the strips, or tables from the JPEGQTables / DCTables / ACTables
    tags; RSTn between strips), its sampling corrected from the frame
    header, and libjpeg's raw output (no upsampling, no colour conversion)
    packed in YCbCr blocks for TIFFRGBAImage (`_load_ycbcr`), or grey rows
    as they are. Errors before the first strip's data whiten the texture;
    a YCbCr strip that fails later leaves TIFFRGBAImage a zeroed buffer,
    which is not modelled (NotImplementedError)."""
    from .jpeg import JpegError, decode_jpeg_planes, jpeg_frame

    ifd = d.ifd
    # TIFFReadDirectory's OJPEG fixups
    if d.photometric is None or d.photometric == 2:
        d.photometric = 6
    if 258 not in ifd:
        d.bps = 8
    if 277 not in ifd:
        d.spp = 3 if d.photometric == 6 else 1 if d.photometric in (0, 1) \
            else d.spp
    if d.tiled or d.planar != 1:
        raise _unported("tiled or separate-plane old-style JPEG")
    spp = d.spp
    ycc = d.photometric == 6
    if not ycc and spp != 1:
        raise TiffError("PIL's unpacker row is longer than libtiff's")
    if spp not in (1, 3):
        raise TiffError("old-style JPEG: unsupported SamplesPerPixel")
    hor = ver = 1
    blocks = _ojpeg_blocks(data, d, d.per_plane)
    if spp == 3:
        # OJPEGSubsamplingCorrect: the tag's values (2, 2 without one),
        # then the first frame header's
        sub = d.entry(530) if 530 in ifd else (2, 2)
        if len(sub) != 2:
            raise _unported("a YCbCrSubSampling of other than two values")
        hor, ver, force = _ojpeg_sof_sampling(blocks, *sub)
        if force:
            raise _unported("old-style JPEG that libjpeg upsamples")
    rps = d.rps if d.rps < 2 ** 32 - 1 else d.length
    restart = d.scalar(515, 0)
    if rps < d.length:
        if hor not in (1, 2, 4) or ver not in (1, 2, 4):
            raise TiffError("old-style JPEG: invalid subsampling")
        if rps % (ver * 8):
            raise TiffError("old-style JPEG: strip length and subsampling")
        restart = -(-d.width // (hor * 8)) * (rps // (ver * 8))
    stream = _ojpeg_stream(data, d, blocks, spp, hor, ver, restart & 0xFFFF)
    try:
        frame = jpeg_frame(stream)
    except JpegError as e:
        raise TiffError(f"old-style JPEG: {e}") from e
    if frame["width"] != d.width or (frame["hmax"], frame["vmax"]) != \
            (hor, ver):
        raise TiffError("old-style JPEG: libjpeg's frame differs")
    try:
        planes = decode_jpeg_planes(stream)
    except JpegError as e:
        if ycc:
            raise _unported("old-style JPEG data that fails in a strip "
                            "TIFFRGBAImage then reads zeroed") from e
        raise TiffError(f"old-style JPEG: {e}") from e
    if not ycc:
        # OJPEGDecodeScanlines: grey rows, unpacked as "L"
        img = raster.new(im.mode, d.width, d.length)
        img[...] = planes[0][:d.length, :d.width].reshape(img.shape)
        return img
    # OJPEGDecodeRaw: lines of subsampling blocks (hor x ver Y, Cb, Cr)
    lineout = -(-d.width // hor)
    y, cb, cr = planes
    imcu = -(-frame["height"] // (8 * ver))
    nlines = imcu * 8
    r, st = np.arange(nlines) // 8, np.arange(nlines) % 8
    yrows = (r * 8 * ver + st * ver)[:, None] + np.arange(ver)[None]
    ys = y[yrows][:, :, :lineout * hor]                 # (lines, ver, W)
    ys = ys.reshape(nlines, ver, lineout, hor).transpose(0, 2, 1, 3)
    ys = ys.reshape(nlines, lineout, hor * ver)
    crow = r * 8 + st
    lines = np.concatenate([ys, cb[crow][:, :lineout, None],
                            cr[crow][:, :lineout, None]], -1)
    lines = lines.reshape(nlines, -1)
    bpl = lines.shape[1]
    cursor = [0]

    def decode(i, size):
        if size % bpl:
            raise _unported("old-style JPEG strips of a fractional line, "
                            "which TIFFRGBAImage then reads zeroed")
        n = size // bpl
        k = cursor[0]
        if k + n > nlines:
            raise _unported("old-style JPEG data shorter than its image")
        cursor[0] += n
        return lines[k:k + n].tobytes()

    # the subsampling TIFFRGBAImage reads is OJPEG's, tag or not
    return _load_ycbcr(data, im, d, sub=(hor, ver), decode=decode)


# tif_color.c's defaults: Rec. 601 luma and the YCbCr ReferenceBlackWhite
_LUMA = (0.299, 0.587, 0.114)
_RBW = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


def _ycbcr_tables(luma, rbw):
    """TIFFYCbCrToRGBInit in float32 and int32, as libtiff computes it."""
    f = np.float32
    lr, lg, lb = (f(v) for v in luma)
    rbw = [f(v) for v in rbw]

    def fix(x):
        return int(np.float64(f(x) * f(65536)) + 0.5)

    def clamp(x, lo, hi):
        return lo if x < lo else hi if x > hi else x

    f1 = f(f(2) - f(2) * lr)
    d1 = fix(clamp(f1, f(0), f(2)))
    f2 = f(f(lr * f1) / lg)
    d2 = -fix(clamp(f2, f(0), f(2)))
    f3 = f(f(2) - f(2) * lb)
    d3 = fix(clamp(f3, f(0), f(2)))
    f4 = f(f(lb * f3) / lg)
    d4 = -fix(clamp(f4, f(0), f(2)))

    def code2v(c, rb, rw, cr):
        den = f(rw - rb)
        den = den if den != 0 else f(1)
        return f(f(f(c - int(rb)) * f(cr)) / den)

    def clampw(v):
        lo, hi = f(-128.0 * 32), f(128.0 * 32)
        return int(lo if v < lo else hi if v > hi else v)

    cr_r, cb_b, cr_g, cb_g, y_tab = ([0] * 256 for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, f(rbw[4] - f(128)), f(rbw[5] - f(128)), 127))
        cb = clampw(code2v(x, f(rbw[2] - f(128)), f(rbw[3] - f(128)), 127))
        cr_r[i] = (d1 * cr + 32768) >> 16
        cb_b[i] = (d3 * cb + 32768) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + 32768
        y_tab[i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255))
    return tuple(np.array(t, np.int64) for t in (y_tab, cr_r, cb_b, cr_g,
                                                 cb_g))


def _ycbcr_to_rgb(y, cb, cr, tables):
    """TIFFYCbCrtoRGB of uint8 planes: (..., 3) uint8."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[y]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _rational_field(d: _Dir, tag: int, n: int, default):
    if tag not in d.ifd:
        return default
    typ, raw = d.ifd.raw[tag]
    if typ != 5 or len(raw) != 8 * n:
        raise _unported(f"tag {tag} in a form libtiff may read otherwise")
    v = d.ifd.unpack(f"{2 * n}L", raw)
    return tuple(np.float32(a / b) if b else np.float32("nan")
                 for a, b in zip(v[::2], v[1::2]))


def _load_ycbcr(data: bytes, im: _Image, d: _Dir, sub=None,
                decode=None) -> np.ndarray:
    """_decodeAsRGBA: libtiff's TIFFRGBAImage over blocks of strips or
    tiles, 8-bit YCbCr with its subsampling converted by tif_color.c (PIL
    reads the raster top-left first whatever the Orientation, and unpacks
    it as RGBX)."""
    if d.compression == 7:
        raise _unported("separate-plane JPEG YCbCr")
    if d.bps not in (1, 2, 4, 8, 16) or d.sampleformat == 3:
        raise TiffError("TIFFRGBAImageOK refuses the sample format")
    if sub is None:
        sub = (2, 2)
        if 530 in d.ifd:
            sub = d.entry(530)
            if len(sub) != 2:
                raise _unported("a YCbCrSubSampling of other than two "
                                "values")
    hs, vs = sub
    if d.bps != 8 or d.spp != 3 or (d.planar == 1 and (hs << 4 | vs) not in (
            0x11, 0x12, 0x21, 0x22, 0x41, 0x42, 0x44)) or \
            (d.planar == 2 and (hs, vs) != (1, 1)):
        raise TiffError("TIFFRGBAImageBegin: can not handle the format")
    luma = _rational_field(d, 529, 3, tuple(np.float32(v) for v in _LUMA))
    rbw = _rational_field(d, 532, 6, tuple(np.float32(v) for v in _RBW))
    if any(np.isnan(v) for v in luma) or abs(luma[1]) < 1e-5 or \
            any(not (-2.0 ** 31 < v < 2.0 ** 31) for v in rbw):
        raise TiffError("invalid YCbCrCoefficients or ReferenceBlackWhite")
    tables = _ycbcr_tables(luma, rbw)
    xsize, ysize = im.tile_size
    state: dict = {}

    def blocks(buf, w, rows):
        """Subsampled blocks (hs x vs Y, then Cb, Cr) of `rows` rows of
        width w -> (rows, w, 3) RGB."""
        bw, bh = -(-w // hs), -(-rows // vs)
        n = hs * vs + 2
        v = np.frombuffer(buf, np.uint8, count=bw * bh * n).reshape(bh, bw, n)
        ys = v[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3)
        ys = ys.reshape(bh * vs, bw * hs)[:rows, :w]
        cb = np.repeat(np.repeat(v[..., -2], vs, 0), hs, 1)[:rows, :w]
        cr = np.repeat(np.repeat(v[..., -1], vs, 0), hs, 1)[:rows, :w]
        return _ycbcr_to_rgb(ys, cb, cr, tables)

    def segment(i, size):
        if decode is not None:
            return decode(i, size)
        try:
            raw = _read_segment(data, d, i, size, state)
            return _decode_segment(raw, d, size, state, (d.width, 0))
        except TiffError as e:
            # stoponerr is 0: libtiff goes on with the buffer it has
            raise _unported(f"a YCbCr strip that libtiff reads past an "
                            f"error ({e})") from e

    blockrow = (-(-xsize // hs)) * (hs * vs + 2)
    if d.planar == 1 and blockrow % vs:
        raise _unported("a YCbCr scanline size that libtiff truncates")
    img = np.zeros((ysize, xsize, 3), np.uint8)
    per_block = d.th if d.tiled else min(d.rps, ysize)
    for y0 in range(0, ysize, per_block):
        rows = min(per_block, ysize - y0)
        if d.tiled:
            if d.planar != 1:
                raise _unported("separate-plane YCbCr tiles")
            tile_blocks = (-(-d.tw // hs)) * (-(-d.th // vs)) * (hs * vs + 2)
            part = np.zeros((rows, xsize, 3), np.uint8)
            for x0 in range(0, xsize, d.tw):
                i = (y0 // d.th) * d.across + x0 // d.tw
                buf = segment(i, tile_blocks)
                rgb = blocks(buf, d.tw, d.th)
                n = min(d.tw, xsize - x0)
                part[:, x0:x0 + n] = rgb[:rows, :n]
        elif d.planar == 1:
            if rows % vs and y0 + rows < ysize:
                raise _unported("YCbCr strips that split a sampling block")
            size = -(-rows // vs) * blockrow
            part = blocks(segment(y0 // d.rps, size), xsize, rows)
        else:
            planes = [np.frombuffer(segment(y0 // d.rps + k * d.per_plane,
                                            rows * xsize), np.uint8)
                      .reshape(rows, xsize) for k in range(3)]
            part = _ycbcr_to_rgb(*planes, tables)
        img[y0:y0 + rows] = part
    return img


# ----------------------------------------------------------------------------
# load_end and the entry point
# ----------------------------------------------------------------------------

_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')


def _orientation(ifd: _Ifd):
    """getexif()'s Orientation: the tag, else an XMP packet's."""
    if 274 in ifd:
        return ifd[274]
    xmp = ifd.get(700)
    if isinstance(xmp, tuple) and len(xmp) == 1:
        xmp = xmp[0]
    if xmp:
        if not isinstance(xmp, bytes):
            raise _unported("an XMP packet that is not bytes")
        m = _XMP_ORIENTATION.search(xmp)
        if m:
            return int(m[2])
    return 1


def _transpose(px: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose's transposition of (H, W, ...) pixels."""
    try:
        method = {2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8}.get(orientation)
    except TypeError as e:
        raise TiffError("unhashable Orientation") from e
    if method == 2:
        px = px[:, ::-1]
    elif method == 3:
        px = px[::-1, ::-1]
    elif method == 4:
        px = px[::-1]
    elif method == 5:
        px = px.swapaxes(0, 1)
    elif method == 6:
        px = np.rot90(px, -1)
    elif method == 7:
        px = px.swapaxes(0, 1)[::-1, ::-1]
    elif method == 8:
        px = np.rot90(px, 1)
    return np.ascontiguousarray(px)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`.
    Raises `identify.Refused` where `TiffImageFile._open` refuses them."""
    data = bytes(data)
    with opening("TIFF"):
        im = _open(data)
    check_pixels(*im.size)
    if im.compression in ("tiff_sgilog", "tiff_sgilog24"):
        # LogLuvSetupDecode takes only the LogL and LogLuv photometrics,
        # which PIL's OPEN_INFO lacks: every file PIL opens fails to load
        raise TiffError("SGILog needs a LogL or LogLuv photometric")
    check_pixels(*im.tile_size)
    pal = raster.planar_palette(im.palette) if im.palette is not None \
        else None
    px = _load_libtiff(data, im) if im.libtiff else _load_raw(data, im)
    px = _transpose(px, _orientation(im.ifd))
    return raster.to_rgba(im.mode, px, pal)


# ----------------------------------------------------------------------------
# the writer (the TIFF-textured city's maps)
# ----------------------------------------------------------------------------

def _compress(raw: bytes, compression: int, rows: int = 0, width: int = 0,
              t4options: int = 0) -> bytes:
    """One strip or tile of `rows` rows of `width` samples, raw as the
    codec gets them, compressed."""
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 50000:
        cap = len(raw) + len(raw) // 64 + 256
        out = np.empty(cap, np.uint8)
        wlog = max(10, min(27, (max(len(raw), 1) - 1).bit_length()))
        n = zstd_library().kt_zstd_encode(raw, len(raw), out.ctypes.data, cap,
                                         wlog, 1)
        if n < 0:
            raise ValueError("zstd output larger than its buffer")
        return out[:n].tobytes()
    lib = library()
    if compression in _FAX:
        rowbytes = len(raw) // rows
        cap = rows * (width * 3 + 64) + 64
        out = np.empty(cap, np.uint8)
        n = lib.kt_tiff_fax_encode(raw, width, rows, rowbytes, compression,
                                   t4options, out.ctypes.data, cap)
        if n < 0:
            raise ValueError("CCITT output larger than its buffer")
        return out[:n].tobytes()
    if compression == 32809:
        px = np.frombuffer(raw, np.uint8).reshape(rows, -1)
        px = np.stack([px >> 4, px & 15], -1).reshape(rows, -1)[:, :width]
        px = np.ascontiguousarray(px)
        out = np.empty(rows * (width + 1), np.uint8)
        n = lib.kt_tiff_thunder_encode(px.tobytes(), width, rows,
                                       out.ctypes.data)
        return out[:n].tobytes()
    if compression == 5:
        cap = len(raw) * 2 + 64
        out = np.empty(cap, np.uint8)
        n = lib.kt_tiff_lzw_encode(raw, len(raw), out.ctypes.data, cap)
        if n < 0:
            raise ValueError("LZW output larger than its buffer")
        return out[:n].tobytes()
    if compression == 32773:
        out = np.empty(2 * len(raw) + 2, np.uint8)
        n = lib.kt_tiff_packbits_encode(raw, len(raw), out.ctypes.data)
        return out[:n].tobytes()
    raise ValueError(f"the writer has no compression {compression}")


def _pack_rows(blk: np.ndarray, bits: int, dt: np.dtype) -> np.ndarray:
    """(rows, width, S) samples -> (rows, bytes) as a strip stores them:
    MSB-first packed below 8 bits, else in the file's byte order."""
    if bits < 8:
        v = blk.reshape(blk.shape[0], -1).astype(np.uint8)
        planes = [(v >> (bits - 1 - b)) & 1 for b in range(bits)]
        bitrows = np.stack(planes, -1).reshape(v.shape[0], -1)
        return np.packbits(bitrows, axis=1)
    return blk.reshape(blk.shape[0], -1).astype(dt)


def write_tiff(samples: np.ndarray, *, photometric: int = 2,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               tile: tuple | None = None, rows_per_strip: int | None = None,
               order: str = "<", orientation: int | None = None,
               bits: int | None = None, fillorder: int = 1,
               t4options: int | None = None) -> bytes:
    """A baseline TIFF of (H, W, S) samples: uint8 or uint16 (8 or 16
    bits), or `bits` 1 or 4 (values below 2 ** bits), in strips or (tw, th)
    tiles, contiguous or planar (2), raw (1), LZW (5), deflate (8),
    PackBits (32773), zstd (50000, a checksummed frame a strip), CCITT RLE
    (2), RLEW (32771), Group 3 (3, `t4options` its T4Options), Group 4 (4)
    or ThunderScan (32809), horizontal differencing (predictor 2), FillOrder
    1 or 2 (the codec's bytes bit-reversed) and either byte order;
    `orientation` is written as the Orientation tag (the samples are stored
    as given)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    bps = bits or (16 if samples.dtype == np.uint16 else 8)
    dt = np.dtype(order + ("u2" if bps == 16 else "u1"))
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 \
        else [samples]
    blocks = []
    for pl in planes:
        if tile:
            tw, th = tile
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    blk = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                    part = pl[y0:y0 + th, x0:x0 + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    blocks.append(blk)
        else:
            rps = rows_per_strip or h
            blocks += [pl[y0:y0 + rps] for y0 in range(0, h, rps)]
    blobs = []
    for blk in blocks:
        v = _pack_rows(blk, bps, dt.newbyteorder("="))
        if predictor == 2:
            stride = blk.shape[2]
            v = v.copy()
            v[:, stride:] = v[:, stride:] - v[:, :-stride]
        raw = v.astype(dt).tobytes() if bps >= 8 else v.tobytes()
        blob = _compress(raw, compression, blk.shape[0], blk.shape[1],
                         t4options or 0)
        if fillorder == 2:
            blob = raster.REVERSE[np.frombuffer(blob, np.uint8)].tobytes()
        blobs.append(blob)
    head = 8
    body = bytearray()
    offsets = []
    for b in blobs:
        offsets.append(head + len(body))
        body += b + b"\0" * (len(b) % 2)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                     324: (4, offsets), 325: (4, [len(b) for b in blobs])})
    else:
        tags.update({273: (4, offsets), 278: (4, [rows_per_strip or h]),
                     279: (4, [len(b) for b in blobs])})
    if predictor != 1:
        tags[317] = (3, [predictor])
    if orientation is not None:
        tags[274] = (3, [orientation])
    if fillorder != 1:
        tags[266] = (3, [fillorder])
    if t4options is not None:
        tags[292] = (4, [t4options])
    ifd_off = head + len(body)
    ext_off = ifd_off + 2 + 12 * len(tags) + 4
    entries, ext = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        data = struct.pack(order + ("H" if typ == 3 else "L") * len(vals),
                           *vals)
        if len(data) <= 4:
            field = data.ljust(4, b"\0")
        else:
            field = struct.pack(order + "L", ext_off + len(ext))
            ext += data + b"\0" * (len(data) % 2)
        entries += struct.pack(order + "HHL", tag, typ, len(vals)) + field
    magic = (b"II" if order == "<" else b"MM") + struct.pack(order + "HL", 42,
                                                            ifd_off)
    return bytes(magic + body + struct.pack(order + "H", len(tags)) + entries
                 + struct.pack(order + "L", 0) + ext)

