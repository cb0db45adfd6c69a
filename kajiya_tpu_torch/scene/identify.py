"""Names the image format of a texture source as PIL 12.1.0's `Image.open`
would try it, without PIL.

The JAX package's bake opens every source with PIL and bakes a white
texture only when PIL raises. The port decodes most formats itself;
for any other bytes it must know whether PIL would have decoded them, so
that a format it cannot decode raises NotImplementedError instead of
passing as a white texture. `identify` walks PIL's plugin order (the five
plugins `Image.preinit` loads, then every registered one, `Image.ID`) and
applies each plugin's `_accept` rule to the first 16 bytes, as
`Image.open` does. The plugins that have no `_accept` (IM, IMT, IPTC, PCD,
SPIDER, TGA) are matched by the header checks their `_open` makes first
(IM's whole header of `Key: value` lines, so a binary file with a line
feed and a colon in its first bytes is no IM candidate); those are
necessary conditions only, so a source that fails them cannot be opened
by that plugin.

When a plugin's `_open` refuses the bytes (it raises SyntaxError,
IndexError, TypeError, KeyError, EOFError or struct.error, or leaves no
mode or an empty size), `Image.open` tries the next plugin that accepts
them. The port's decoders signal that with `Refused` (through `opening`),
and `textures._decode_image` walks `candidates` the same way. Any other
error propagates, and the bake turns the source white, as the JAX
package's does.

Where PIL's order puts a plugin the port does not decode before one it
does, the port raises NotImplementedError for the first, even when PIL's
`_open` of that plugin would refuse the bytes and the next would decode
them (the port cannot tell without that plugin's reader). The two such
cases the header sweeps found (a TGA with a 28-byte id field and a colour
map, which IPTC's check accepts; an ICO of no entries that passes GBR's)
went with IPTC and GBR's decoders; none is known now.

The port decodes every plugin named here but AVIF, EPS, the stub
plugins (BUFR, GRIB, HDF5, WMF: PIL identifies them and loads them
only through a handler an application registers) and MPEG (PIL opens it
and cannot load it): for those `textures._decode_image` raises
NotImplementedError. For AVIF it does so only where PIL's open succeeds:
`avif.py` mirrors libavif's parse, so the files PIL refuses or fails to
open pass on or turn white as in the JAX bake.

`check_pixels` mirrors `Image.MAX_IMAGE_PIXELS`: PIL refuses an image of
more than twice that many pixels (`DecompressionBombError`), and the JAX
bake turns it white.
"""
from __future__ import annotations

import re
import struct
from contextlib import contextmanager

MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3
# what `ImageFile.__init__` and `Image.open` take as "this plugin's `_open`
# refuses the bytes"
OPEN_ERRORS = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
               struct.error)


class Refused(ValueError):
    """The plugin's `_open` refuses the bytes: `Image.open` goes on to the
    next plugin that accepts them (a ValueError, so a refusal that reaches
    the bake turns the source white)."""


@contextmanager
def opening(fmt: str):
    """Run a decoder's `_open` part: the errors PIL takes as a refusal
    become `Refused`; every other error passes unchanged."""
    try:
        yield
    except OPEN_ERRORS as e:
        raise Refused(f"{fmt}: {e!r}") from e


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _avif(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                               b"msf1")


def _pcx(p):
    return len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)


def _fli(p):
    return len(p) >= 16 and _i16(p, 4) in (0xAF11, 0xAF12) and \
        _i16(p, 14) in (0, 3)


def _gbr(p):
    if len(p) < 8:
        return False
    size, version = struct.unpack_from(">II", p)
    return size >= 20 and version in (1, 2)


_TIFF = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
         b"MM\x00\x2b", b"II\x2b\x00")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")


def _im(data: bytes) -> bool:
    """ImImagePlugin: a line feed within 100 bytes, then header lines (up
    to a NUL, a ^Z or the end) that are each `Key: value` of at most 100
    bytes, one of them a key of the IM format's."""
    if b"\n" not in data[:100]:
        return False
    pos, tags = 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return False
        s = s[:-2] if s.endswith(b"\r\n") else \
            s[:-1] if s.endswith(b"\n") else s
        m = _IM_LINE.match(s)
        if m is None:
            return False
        tags += m.group(1).decode("latin-1", "replace") in _IM_TAGS
    return tags > 0


def _imt(data: bytes) -> bool:
    """ImtImagePlugin: a line feed within 100 bytes, and its only mode,
    `pixel n8`, named in the header."""
    return b"\n" in data[:100] and b"pixel n8" in data


def _iptc(data: bytes) -> bool:
    s = data[:5]
    return len(s) == 5 and bool(s.strip(b"\x00")) and s[0] == 0x1C and \
        s[1] in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _pcd(data: bytes) -> bool:
    return data[2048:2052] == b"PCD_"


def spider_header_length(t) -> int:
    """SpiderImagePlugin.isSpiderHeader on the header's floats: the
    header's length in bytes, or 0 where they are no SPIDER header."""
    h = (99,) + tuple(t)

    def is_int(x):
        try:
            return x - int(x) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def _spider(data: bytes) -> bool:
    """SpiderImagePlugin: 27 floats that pass isSpiderHeader, big-endian
    tried first, and a 2D image (iform 1)."""
    f = data[:108]
    if len(f) < 108:
        return False
    for order in (">", "<"):
        t = struct.unpack(order + "27f", f)
        if spider_header_length(t):
            return int(t[4]) == 1
    return False


def _tga(data: bytes) -> bool:
    s = data[:18]
    if len(s) < 18:
        return False
    return (s[1] in (0, 1) and _i16(s, 12) > 0 and _i16(s, 14) > 0
            and s[16] in (1, 8, 16, 24, 32) and s[2] in (1, 2, 3, 9, 10, 11))


# (name, test of the 16-byte prefix), in PIL's `Image.ID` order
_ACCEPT = (
    ("AVIF", _avif),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2"))),
    ("BMP", lambda p: p.startswith(b"BM")),
    ("DIB", lambda p: len(p) >= 4 and _i32(p) in (12, 40, 52, 56, 64, 108,
                                                  124)),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0")),
    ("PCX", _pcx),
    ("DCX", lambda p: len(p) >= 4 and _i32(p) == 0x3ADE68B1),
    ("DDS", lambda p: p.startswith(b"DDS ")),
    ("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and
                                                _i32(p) == 0xC6D3D0C5)),
    ("FITS", lambda p: p.startswith(b"SIMPLE")),
    ("FLI", _fli),
    ("FTEX", lambda p: p.startswith(b"FTEX")),
    ("GBR", _gbr),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a"))),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n")),
    ("PNG", lambda p: p.startswith(b"\x89PNG\r\n\x1a\n")),
    ("JPEG2000", lambda p: p.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", lambda p: p.startswith(b"icns")),
    ("ICO", lambda p: p.startswith(b"\0\0\1\0")),
    ("IM", None),
    ("IMT", None),
    ("IPTC", None),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff")),
    ("MCIDAS", lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04")),
    ("MPEG", lambda p: p.startswith(b"\x00\x00\x01\xb3")),
    ("TIFF", lambda p: p.startswith(_TIFF)),
    ("MSP", lambda p: p.startswith((b"DanM", b"LinS"))),
    ("PCD", None),
    ("PIXAR", lambda p: p.startswith(b"\200\350\000\000")),
    ("PPM", lambda p: len(p) >= 2 and p.startswith(b"P") and
     p[1] in b"0123456fy"),
    ("PSD", lambda p: p.startswith(b"8BPS")),
    ("QOI", lambda p: p.startswith(b"qoif")),
    ("SGI", lambda p: len(p) >= 2 and struct.unpack_from(">H", p)[0] == 474),
    ("SPIDER", None),
    ("SUN", lambda p: len(p) >= 4 and struct.unpack_from(">I", p)[0]
     == 0x59A66A95),
    ("TGA", None),
    ("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP" and
     p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                    b"\x01\x00\x00\x00"))),
    ("XBM", lambda p: p.lstrip().startswith(b"#define")),
    ("XPM", lambda p: p.startswith(b"/* XPM */")),
    ("XVTHUMB", lambda p: p.startswith(b"P7 332")),
)
_HEADER = {"IM": _im, "IMT": _imt, "IPTC": _iptc, "PCD": _pcd,
           "SPIDER": _spider, "TGA": _tga}
# the plugins `Image.preinit` loads, tried before the rest
_PREINIT = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG")

# every format `identify` can name, for the error messages and the docs
FORMATS = tuple(name for name, _ in _ACCEPT)


def _matches(name: str, test, data: bytes) -> bool:
    if test is None:
        return _HEADER[name](data)
    return bool(test(data[:16]))


def candidates(data: bytes) -> list:
    """Every plugin (by PIL's `Image.ID` name) that `Image.open` would hand
    `data` to, in the order it tries them: when one plugin's `_open`
    refuses the bytes, PIL goes on to the next (a TGA file, for instance,
    also passes CUR's rule)."""
    table = dict(_ACCEPT)
    order = list(_PREINIT) + [n for n, _ in _ACCEPT if n not in _PREINIT]
    return [name for name in order if _matches(name, table[name], data)]


def identify(data: bytes) -> str | None:
    """The first plugin `Image.open` would hand `data` to, or None when no
    plugin accepts it."""
    found = candidates(data)
    return found[0] if found else None


def check_pixels(width: int, height: int) -> None:
    """Raise ValueError where PIL raises DecompressionBombError."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"image of {pixels} pixels exceeds PIL's limit of "
                         f"{2 * MAX_IMAGE_PIXELS} (decompression bomb)")
