"""JPEG 2000 texture decoding (J2K codestreams and JP2 files), as PIL
12.1.0's `Image.open(f).convert("RGBA")` gives it over OpenJPEG 2.5.4,
byte for byte.

Three layers, each as its original does it:
- PIL's `Jpeg2KImagePlugin._open` (`_pil_open`): the signature, the
  codestream's SIZ or the JP2 header boxes (`ihdr`, `colr`, `pclr`, `res `)
  give the mode and the size; its errors refuse the bytes (`identify`).
- OpenJPEG's reader (`_jp2_procedure`, `_Codestream`): the JP2 boxes it reads
  before the codestream (and after it, at `opj_end_decompress`), the main
  header's marker segments with OpenJPEG's checks, and the tile-parts in
  the order `opj_read_tile_header` walks them (strict mode: a tile-part
  longer than the file fails). Each complete tile then decodes in
  `csrc/j2k_decoder.cpp` (tier 2, tier 1, dequantisation, the inverse
  DWT, the MCT, the DC level shift).
- PIL's `Jpeg2KDecode.c`: the checks on the decoded header, the unpacker
  its (mode, colour space, components) picks, and where each tile lands;
  then `convert("RGBA")` through `raster`.

An OpenJPEG or PIL failure raises `raster.DecodeError` (white in both
bakes). What the port does not model (an HTJ2K code-block, Part 2 markers,
tile-part orders OpenJPEG corrects, a palette PIL's `ImagePalette` would
garble) raises NotImplementedError naming it.

`encode_j2k` writes the lossless codestreams and JP2 files of the city
assets and reports the texels they decode to.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading

import numpy as np

from .. import hostlib
from . import raster
from .identify import check_pixels, opening
from .raster import DecodeError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "j2k_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
# no fused multiply-adds (the 9/7 path rounds each float32 operation as
# OpenJPEG does) and wrapping int32 sums
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-ffp-contract=off", "-fwrapv")
THREADS = max(1, min(8, os.cpu_count() or 1))

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostlib.load(SOURCE, "j2k_decoder", CXX, CXX_FLAGS, BUILD_DIR,
                           "the JPEG 2000 decoder")
        p, i64, c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.kt_j2k_decode_tile.argtypes = [p, p, ctypes.c_char_p, i64,
                                           ctypes.c_char_p, i64, p, p, c_int,
                                           p, i64, ctypes.c_char_p, c_int]
        lib.kt_j2k_decode_tile.restype = c_int
        if hasattr(lib, "kt_j2k_encode"):
            lib.kt_j2k_encode.argtypes = [p, c_int, c_int, c_int, c_int,
                                          c_int, c_int, c_int, c_int, p, i64]
            lib.kt_j2k_encode.restype = i64
        _lib = lib
        return lib


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"JPEG 2000: {what} is not modelled "
                               "(ROADMAP.md section 1)")


# ----------------------------------------------------------------------------
# PIL's Jpeg2KImagePlugin._open
# ----------------------------------------------------------------------------

class _Box:
    """PIL's BoxReader over bytes."""

    def __init__(self, data: bytes, pos: int = 0, length: int = -1):
        self.data, self.pos = data, pos
        self.has_length, self.length = length >= 0, length
        self.remaining = -1

    def _can_read(self, n):
        if self.has_length and self.pos + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def read_bytes(self, n):
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        if len(out) < n:
            raise DecodeError(f"Expected to read {n} bytes but only got "
                              f"{len(out)}.")
        if self.remaining > 0:
            self.remaining -= n
        return out

    def fields(self, fmt):
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def read_boxes(self):
        size = self.remaining
        return _Box(self.read_bytes(size), 0, size)

    def has_next(self):
        return self.pos + self.remaining < self.length if self.has_length \
            else True

    def next_type(self):
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _mode_of_siz(siz: bytes):
    lsiz, rsiz, xsiz, ysiz, xo, yo, *_ , csiz = struct.unpack_from(
        ">HHIIIIIIIIH", siz)
    size = (xsiz - xo, ysiz - yo)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 \
            > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = ("LA", "RGB", "RGBA")[csiz - 2]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _pil_open(data: bytes):
    """(codec, size, mode, palette rows or None), as `_open` sets them."""
    if data[:4] == J2K_SIGNATURE:
        hdr = data[4:6]
        lsiz = struct.unpack(">H", hdr)[0]
        # fp.read(n) of a negative n reads to the end
        siz = hdr + (data[6:6 + lsiz - 2] if lsiz >= 2 else data[6:])
        size, mode = _mode_of_siz(siz)
        _parse_comment(data, 4 + lsiz)
        return "j2k", size, mode, None
    if data[:12] != JP2_SIGNATURE:
        raise SyntaxError("not a JPEG 2000 file")
    reader = _Box(data, 12)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise DecodeError("no jp2h box (an AssertionError in PIL)")
    size = mode = None
    nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc == 1:
                mode = "L"
            elif nc in (2, 3, 4):
                mode = ("LA", "RGB", "RGBA")[nc - 2]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _pclr_palette(header, ne, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    pos = reader.pos
    tail = data[pos:pos + 12]
    if tail.endswith(b"jp2c\xff\x4f\xff\x51"):
        hdr = data[pos + 12:pos + 14]
        length = struct.unpack(">H", hdr)[0]
        _parse_comment(data, pos + 14 + length - 2)
    return "jp2", size, mode, palette


def _pclr_palette(header: _Box, ne: int, npc: int):
    """The palette `ImagePalette.getcolor` builds from the entries: each
    new colour appended, a repeated one given its first index."""
    if npc != 3:
        raise _unported(f"a pclr box of {npc} columns (PIL's palette "
                        "indexing)")
    colors, rows = {}, []
    for _ in range(ne):
        color = header.fields(">BBB")
        if color not in colors:
            if len(rows) >= 256:
                raise DecodeError("cannot allocate more than 256 colors")
            colors[color] = len(rows)
            rows.append(color)
    return rows


def _parse_comment(data: bytes, pos: int) -> None:
    """`_parse_comment`: the markers after SIZ, up to SOT or EOC (only its
    errors matter)."""
    while True:
        marker = data[pos:pos + 2]
        pos += len(marker)
        if not marker:
            return
        typ = marker[1]
        if typ in (0x90, 0xD9):
            return
        hdr = data[pos:pos + 2]
        pos += len(hdr)
        length = struct.unpack(">H", hdr)[0]
        if typ == 0x64:
            return
        pos = max(0, pos + length - 2)


# ----------------------------------------------------------------------------
# OpenJPEG's JP2 reader
# ----------------------------------------------------------------------------

# OpenJPEG's colour spaces
CS_UNKNOWN, CS_UNSPECIFIED, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK = \
    -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: CS_SRGB, 17: CS_GRAY, 18: CS_SYCC, 24: CS_EYCC, 12: CS_CMYK}
_JP2_TOP = (b"jP  ", b"ftyp", b"jp2h")
_JP2_IMG = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


class _Jp2:
    """The state `opj_jp2_read_header_procedure` builds."""

    def __init__(self):
        self.state = set()
        self.ihdr = None          # (h, w, nc, bpc)
        self.has_colr = False
        self.meth = 0
        self.enumcs = 0
        self.pclr = None          # nr_channels
        self.cmap = False
        self.cdef = False


def _box_header(data: bytes, pos: int):
    """opj_jp2_read_boxhdr: (length, type, header bytes) or None when 8
    bytes cannot be read."""
    if len(data) - pos < 8:
        return None
    length, typ = struct.unpack_from(">I4s", data, pos)
    n = 8
    if length == 0:
        left = len(data) - pos - 8
        if left > 0xFFFFFFFF - 8:
            raise DecodeError("Cannot handle box sizes higher than 2^32")
        return left + 8, typ, 8
    if length == 1:
        if len(data) - pos < 16:
            return None
        xl_hi, length = struct.unpack_from(">II", data, pos + 8)
        if xl_hi != 0:
            raise DecodeError("Cannot handle box sizes higher than 2^32")
        n = 16
    return length, typ, n


def _jp2_img_box(jp2: _Jp2, typ: bytes, body: bytes) -> None:
    """The handlers of the boxes inside jp2h."""
    n = len(body)
    if typ == b"ihdr":
        if jp2.ihdr is not None:
            return
        if n != 14:
            raise DecodeError("Bad image header box (bad size)")
        h, w, nc, bpc = struct.unpack_from(">IIHB", body)
        if not 1 <= nc <= 16384:
            raise DecodeError("Invalid number of components (ihdr)")
        jp2.ihdr = (h, w, nc, bpc)
    elif typ == b"colr":
        if n < 3:
            raise DecodeError("Bad COLR header box (bad size)")
        if jp2.has_colr:
            return
        jp2.meth = body[0]
        if jp2.meth == 1:
            if n < 7:
                raise DecodeError("Bad COLR header box (bad size)")
            jp2.enumcs = struct.unpack_from(">I", body, 3)[0]
            jp2.has_colr = True
        elif jp2.meth == 2:
            jp2.has_colr = True
    elif typ == b"bpcc":
        nc = jp2.ihdr[2] if jp2.ihdr else 0
        if n != nc:
            raise DecodeError("Bad BPCC header box (bad size)")
    elif typ == b"pclr":
        if jp2.pclr is not None or n < 3:
            raise DecodeError("bad pclr box")
        ne, npc = struct.unpack_from(">HB", body)
        if ne == 0 or ne > 1024 or npc == 0 or n < 3 + npc:
            raise DecodeError("Invalid PCLR box")
        size = 3 + npc + ne * sum(min(4, ((b & 0x7F) + 1 + 7) >> 3)
                                  for b in body[3:3 + npc])
        if n < size:
            raise DecodeError("Invalid PCLR box")
        jp2.pclr = npc
    elif typ == b"cmap":
        if jp2.pclr is None:
            raise DecodeError("Need to read a PCLR box before the CMAP box.")
        if jp2.cmap:
            raise DecodeError("Only one CMAP box is allowed.")
        if n < 4 * jp2.pclr:
            raise DecodeError("Insufficient data for CMAP box.")
        jp2.cmap = True
    elif typ == b"cdef":
        if jp2.cdef:
            raise DecodeError("Only one CDEF box is allowed.")
        if n < 2:
            raise DecodeError("Insufficient data for CDEF box.")
        count = struct.unpack_from(">H", body)[0]
        if count == 0:
            raise DecodeError("Number of channel description is equal to "
                              "zero in CDEF box.")
        if n < 2 + 6 * count:
            raise DecodeError("Insufficient data for CDEF box.")
        jp2.cdef = True


def _jp2h(jp2: _Jp2, body: bytes) -> None:
    if "ftyp" not in jp2.state:
        raise DecodeError("The  box must be the first box in the file.")
    pos, has_ihdr = 0, False
    while pos < len(body):
        left = len(body) - pos
        if left < 8:
            raise DecodeError("Cannot handle box of less than 8 bytes")
        length, typ = struct.unpack_from(">I4s", body, pos)
        n = 8
        if length == 1:
            if left < 16:
                raise DecodeError("Cannot handle XL box of less than 16 "
                                  "bytes")
            hi, length = struct.unpack_from(">II", body, pos + 8)
            if hi != 0:
                raise DecodeError("Cannot handle box sizes higher than 2^32")
            n = 16
            if length == 0:
                raise DecodeError("Cannot handle box of undefined sizes")
        elif length == 0:
            raise DecodeError("Cannot handle box of undefined sizes")
        if length < n:
            raise DecodeError("Box length is inconsistent.")
        if length > left:
            raise DecodeError("Stream error while reading JP2 Header box: "
                              "box length is inconsistent.")
        if typ in _JP2_IMG:
            _jp2_img_box(jp2, typ, body[pos + n:pos + length])
        has_ihdr |= typ == b"ihdr"
        pos += length
    if not has_ihdr:
        raise DecodeError("no 'ihdr' box")
    jp2.state.add("header")


def _jp2_top_box(jp2: _Jp2, typ: bytes, body: bytes) -> None:
    if typ == b"jP  ":
        if jp2.state:
            raise DecodeError("The signature box must be the first box in "
                              "the file.")
        if len(body) != 4 or body != b"\x0d\x0a\x87\x0a":
            raise DecodeError("Error with JP signature")
        jp2.state.add("signature")
    elif typ == b"ftyp":
        if jp2.state != {"signature"}:
            raise DecodeError("The ftyp box must be the second box in the "
                              "file.")
        if len(body) < 8 or (len(body) - 8) % 4:
            raise DecodeError("Error with FTYP signature Box size")
        jp2.state.add("ftyp")
    else:
        _jp2h(jp2, body)


def _jp2_procedure(jp2: _Jp2, data: bytes, pos: int, after: bool):
    """opj_jp2_read_header_procedure from `pos`: returns the position after
    the jp2c box header (or None at the end of the file, `after`)."""
    while True:
        box = _box_header(data, pos)
        if box is None:
            if after:
                return None
            raise DecodeError("JP2 header ended before the codestream")
        length, typ, n = box
        if typ == b"jp2c":
            if "header" in jp2.state:
                jp2.state.add("codestream")
                return pos + n
            raise DecodeError("bad placed jpeg codestream")
        if length < n:
            raise DecodeError(f"invalid box size {length}")
        size = length - n
        top = typ in _JP2_TOP
        img = typ in _JP2_IMG
        if top or img:
            if not top and "header" not in jp2.state:
                # a misplaced box before jp2h is skipped
                if pos + n + size > len(data):
                    raise DecodeError("Problem with skipping JPEG2000 box")
                pos += n + size
                continue
            if size > len(data) - pos - n:
                raise DecodeError(f"Invalid box size {size} for box {typ!r}")
            body = data[pos + n:pos + n + size]
            if top:
                _jp2_top_box(jp2, typ, body)
            else:
                _jp2_img_box(jp2, typ, body)
        else:
            if "signature" not in jp2.state:
                raise DecodeError("Malformed JP2 file format: first box "
                                  "must be JPEG 2000 signature box")
            if "ftyp" not in jp2.state:
                raise DecodeError("Malformed JP2 file format: second box "
                                  "must be file type box")
            if pos + n + size > len(data):
                if "codestream" in jp2.state:
                    return None
                raise DecodeError("Problem with skipping JPEG2000 box, "
                                  "stream error")
        pos += n + size


# ----------------------------------------------------------------------------
# OpenJPEG's codestream reader
# ----------------------------------------------------------------------------

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, RGN, QCD, QCC, POC = (0xFF51, 0xFF52, 0xFF53, 0xFF5E, 0xFF5C,
                                     0xFF5D, 0xFF5F)
TLM, PLM, PLT, PPM, PPT, SOP, CRG, COM = (0xFF55, 0xFF57, 0xFF58, 0xFF60,
                                          0xFF61, 0xFF91, 0xFF63, 0xFF64)
MCT, CBD, CAP, CPF, MCC, MCO = 0xFF74, 0xFF78, 0xFF50, 0xFF59, 0xFF75, 0xFF77
# decoder states
S_MHSIZ, S_MH, S_TPHSOT, S_TPH, S_NEOC, S_DATA, S_EOC = (0x2, 0x4, 0x8, 0x10,
                                                        0x40, 0x80, 0x100)
_STATES = {SOT: S_MH | S_TPHSOT, COD: S_MH | S_TPH, COC: S_MH | S_TPH,
           RGN: S_MH | S_TPH, QCD: S_MH | S_TPH, QCC: S_MH | S_TPH,
           POC: S_MH | S_TPH, SIZ: S_MHSIZ, TLM: S_MH, PLM: S_MH, PLT: S_TPH,
           PPM: S_MH, PPT: S_TPH, SOP: 0, CRG: S_MH, COM: S_MH | S_TPH,
           MCT: S_MH | S_TPH, CBD: S_MH, CAP: S_MH, CPF: S_MH,
           MCC: S_MH | S_TPH, MCO: S_MH | S_TPH}
_UNK_STATES = S_MH | S_TPH
_PART2 = {MCT: "MCT", CBD: "CBD", CAP: "CAP", CPF: "CPF", MCC: "MCC",
          MCO: "MCO"}
MAXRLVLS, MAXBANDS = 33, 97
# the largest tile the port decodes (its int32 planes): larger ones raise
MAX_TILE_SAMPLES = 1 << 27

# the C++ side's layout (csrc/j2k_decoder.cpp, P_* and T_*)
_P_PRCW, _P_EXPN = 12, 12 + 66
_P_STRIDE = 12 + 66 + 2 * MAXBANDS


class _Tccp:
    __slots__ = ("csty", "numres", "cblkw", "cblkh", "cblksty", "qmfbid",
                 "prcw", "prch", "qntsty", "numgbits", "expn", "mant",
                 "roishift")

    def __init__(self):
        self.csty = self.numres = self.cblkw = self.cblkh = 0
        self.cblksty = self.qmfbid = self.qntsty = self.numgbits = 0
        self.roishift = 0
        self.prcw = [0] * MAXRLVLS
        self.prch = [0] * MAXRLVLS
        self.expn = [0] * MAXBANDS
        self.mant = [0] * MAXBANDS

    def copy(self):
        t = _Tccp()
        for k in self.__slots__:
            v = getattr(self, k)
            setattr(t, k, list(v) if isinstance(v, list) else v)
        return t


class _Tcp:
    def __init__(self, ncomp):
        self.csty = self.prg = self.numlayers = self.mct = 0
        self.cod = False
        self.tccps = [_Tccp() for _ in range(ncomp)]
        self.pocs = []
        self.ppt = {}
        self.tile_part = -1
        self.nb_parts = 0
        self.data = None

    def for_tile(self):
        t = _Tcp(0)
        t.csty, t.prg, t.numlayers, t.mct = (self.csty, self.prg,
                                             self.numlayers, self.mct)
        t.tccps = [c.copy() for c in self.tccps]
        t.pocs = list(self.pocs)
        return t


class _Stream:
    """OpenJPEG's stream over the whole file (its length is the file's)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def left(self):
        return len(self.data) - self.pos

    def read(self, n):
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def read2(self):
        b = self.read(2)
        if len(b) != 2:
            raise DecodeError("Stream too short")
        return struct.unpack(">H", b)[0]


class _Codestream:
    """The main header and tile-parts as opj_j2k_read_header and
    opj_j2k_read_tile_header read them."""

    def __init__(self, data: bytes, pos: int, ihdr=None):
        self.s = _Stream(data, pos)
        self.ihdr = ihdr
        self.state = S_MHSIZ
        self.ppm = None
        self.ppm_pos = 0
        self.read_main_header()

    # -- marker segments ----------------------------------------------------
    def comp_room(self):
        return 1 if self.ncomp <= 256 else 2

    def tcp_now(self):
        return self.tcps[self.tile] if self.state == S_TPH else self.default

    def read_siz(self, b):
        if len(b) < 36:
            raise DecodeError("Error with SIZ marker size")
        n, rem = divmod(len(b) - 36, 3)
        if rem or n == 0:
            raise DecodeError("Error with SIZ marker size")
        (self.rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
         ncomp) = struct.unpack_from(">HIIIIIIIIH", b)
        if ncomp >= 16385 or ncomp != n:
            raise DecodeError("Error with SIZ marker: number of components")
        if x0 >= x1 or y0 >= y1:
            raise DecodeError("Error with SIZ marker: negative or zero "
                              "image size")
        if tdx == 0 or tdy == 0:
            raise DecodeError("Error with SIZ marker: invalid tile size")
        if tx0 > x0 or ty0 > y0 or min(tx0 + tdx, 0xFFFFFFFF) <= x0 or \
                min(ty0 + tdy, 0xFFFFFFFF) <= y0:
            raise DecodeError("Error with SIZ marker: illegal tile offset")
        if self.ihdr and self.ihdr[0] > 0 and self.ihdr[1] > 0 and \
                (self.ihdr[1] != x1 - x0 or self.ihdr[0] != y1 - y0):
            raise DecodeError("Error with SIZ marker: IHDR w/h vs. SIZ w/h")
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.tdx, self.tdy, self.tx0, self.ty0 = tdx, tdy, tx0, ty0
        self.ncomp = ncomp
        self.comps = []
        for i in range(ncomp):
            ssiz, dx, dy = b[36 + 3 * i:39 + 3 * i]
            prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
            if not 1 <= dx <= 255 or not 1 <= dy <= 255:
                raise DecodeError("Invalid values for comp dx / dy")
            if prec > 31:
                raise DecodeError("Invalid values for comp prec")
            self.comps.append((prec, sgnd, dx, dy))
        self.tw = -(-(x1 - tx0) // tdx)
        self.th = -(-(y1 - ty0) // tdy)
        if self.tw == 0 or self.th == 0 or self.tw > 65535 // self.th:
            raise DecodeError("Invalid number of tiles")
        self.default = _Tcp(ncomp)
        self.tcps = None
        self.state = S_MH

    def read_spcod(self, tccp: _Tccp, b: bytes, pos: int) -> int:
        if len(b) - pos < 5:
            raise DecodeError("Error reading SPCod SPCoc element")
        numres = b[pos] + 1
        if numres > MAXRLVLS:
            raise DecodeError("Invalid value for numresolutions")
        cblkw, cblkh = b[pos + 1] + 2, b[pos + 2] + 2
        if cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12:
            raise DecodeError("Invalid cblkw/cblkh combination")
        cblksty = b[pos + 3]
        if cblksty & 0x80:
            raise DecodeError("Unsupported Mixed HT code-block style found")
        qmfbid = b[pos + 4]
        if qmfbid > 1:
            raise DecodeError("Invalid transformation found")
        tccp.numres, tccp.cblkw, tccp.cblkh = numres, cblkw, cblkh
        tccp.cblksty, tccp.qmfbid = cblksty, qmfbid
        pos += 5
        if tccp.csty & 1:
            if len(b) - pos < numres:
                raise DecodeError("Error reading SPCod SPCoc element")
            for i in range(numres):
                v = b[pos + i]
                if i and (v & 0xF == 0 or v >> 4 == 0):
                    raise DecodeError("Invalid precinct size")
                tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
            pos += numres
        else:
            for i in range(numres):
                tccp.prcw[i] = tccp.prch[i] = 15
        return pos

    def read_cod(self, b):
        tcp = self.tcp_now()
        if tcp.cod:
            raise DecodeError("COD marker already read")
        tcp.cod = True
        if len(b) < 5:
            raise DecodeError("Error reading COD marker")
        tcp.csty = b[0]
        if tcp.csty & ~0x7:
            raise DecodeError("Unknown Scod value in COD marker")
        tcp.prg = b[1] if b[1] <= 4 else -1
        tcp.numlayers = struct.unpack_from(">H", b, 2)[0]
        if tcp.numlayers < 1:
            raise DecodeError("Invalid number of layers in COD marker")
        tcp.mct = b[4]
        if tcp.mct > 1:
            raise DecodeError("Invalid multiple component transformation")
        for t in tcp.tccps:
            t.csty = tcp.csty & 1
        first = tcp.tccps[0]
        if self.read_spcod(first, b, 5) != len(b):
            raise DecodeError("Error reading COD marker")
        for t in tcp.tccps[1:]:
            t.numres, t.cblkw, t.cblkh = first.numres, first.cblkw, \
                first.cblkh
            t.cblksty, t.qmfbid = first.cblksty, first.qmfbid
            t.prcw, t.prch = list(first.prcw), list(first.prch)

    def read_coc(self, b):
        tcp, room = self.tcp_now(), self.comp_room()
        if len(b) < room + 1:
            raise DecodeError("Error reading COC marker")
        c = b[0] if room == 1 else struct.unpack_from(">H", b)[0]
        if c >= self.ncomp:
            raise DecodeError("Error reading COC marker (bad number of "
                              "components)")
        tccp = tcp.tccps[c]
        tccp.csty = b[room]
        if self.read_spcod(tccp, b, room + 1) != len(b):
            raise DecodeError("Error reading COC marker")

    def read_sqcd(self, tccp: _Tccp, b: bytes, pos: int) -> None:
        if len(b) - pos < 1:
            raise DecodeError("Error reading SQcd or SQcc element")
        v = b[pos]
        pos += 1
        size = len(b) - pos
        tccp.qntsty, tccp.numgbits = v & 0x1F, v >> 5
        if tccp.qntsty == 1:
            nbands = 1
        else:
            nbands = size if tccp.qntsty == 0 else size // 2
        if tccp.qntsty == 0:
            for i in range(nbands):
                if i < MAXBANDS:
                    tccp.expn[i], tccp.mant[i] = b[pos + i] >> 3, 0
            used = nbands
        else:
            if pos + 2 * nbands > len(b):
                raise DecodeError("Error reading SQcd or SQcc element")
            for i in range(nbands):
                w = struct.unpack_from(">H", b, pos + 2 * i)[0]
                if i < MAXBANDS:
                    tccp.expn[i], tccp.mant[i] = w >> 11, w & 0x7FF
            used = 2 * nbands
        if tccp.qntsty == 1:
            for i in range(1, MAXBANDS):
                tccp.expn[i] = max(tccp.expn[0] - (i - 1) // 3, 0)
                tccp.mant[i] = tccp.mant[0]
        if used != size:
            raise DecodeError("Error reading QCD / QCC marker")

    def read_qcd(self, b):
        tcp = self.tcp_now()
        first = tcp.tccps[0]
        self.read_sqcd(first, b, 0)
        for t in tcp.tccps[1:]:
            t.qntsty, t.numgbits = first.qntsty, first.numgbits
            t.expn, t.mant = list(first.expn), list(first.mant)

    def read_qcc(self, b):
        tcp, room = self.tcp_now(), (1 if self.ncomp <= 256 else 2)
        if len(b) < room:
            raise DecodeError("Error reading QCC marker")
        c = b[0] if room == 1 else struct.unpack_from(">H", b)[0]
        if c >= self.ncomp:
            raise DecodeError("Invalid component number in QCC")
        self.read_sqcd(tcp.tccps[c], b, room)

    def read_rgn(self, b):
        room = self.comp_room()
        if len(b) != 2 + room:
            raise DecodeError("Error reading RGN marker")
        tcp = self.tcp_now()
        c = b[0] if room == 1 else struct.unpack_from(">H", b)[0]
        if c >= self.ncomp:
            raise DecodeError("bad component number in RGN")
        tcp.tccps[c].roishift = b[room + 1]

    def read_poc(self, b):
        room = self.comp_room()
        chunk = 5 + 2 * room
        n, rem = divmod(len(b), chunk)
        if n <= 0 or rem:
            raise DecodeError("Error reading POC marker")
        tcp = self.tcp_now()
        if len(tcp.pocs) + n >= 32:
            raise DecodeError("Too many POCs")
        for i in range(n):
            q = b[i * chunk:(i + 1) * chunk]
            if room == 1:
                res0, comp0, lay1, res1, comp1, prg = struct.unpack(
                    ">BBHBBB", q)
            else:
                res0, comp0, lay1, res1, comp1, prg = struct.unpack(
                    ">BHHBHB", q)
            tcp.pocs.append((res0, comp0, lay1, res1, min(comp1, self.ncomp),
                             prg))

    def read_tlm(self, b):
        if len(b) < 2:
            raise DecodeError("Error reading TLM marker")
        st, sp = (b[1] >> 4) & 3, (b[1] >> 6) & 1
        if st == 3:
            raise _unported("a TLM marker with ST = 3")
        if (len(b) - 2) % ((sp + 1) * 2 + st):
            raise DecodeError("Error reading TLM marker")

    def read_plt(self, b):
        if len(b) < 1:
            raise DecodeError("Error reading PLT marker")
        length = 0
        for v in b[1:]:
            length |= v & 0x7F
            length = length << 7 if v & 0x80 else 0
        if length:
            raise DecodeError("Error reading PLT marker")

    def read_ppm(self, b):
        if len(b) < 2:
            raise DecodeError("Error reading PPM marker")
        if self.ppm is None:
            self.ppm = {}
        if b[0] in self.ppm:
            raise DecodeError("Zppm already read")
        self.ppm[b[0]] = b[1:]

    def read_ppt(self, b):
        if len(b) < 2:
            raise DecodeError("Error reading PPT marker")
        if self.ppm is not None:
            raise DecodeError("PPT marker after a PPM marker")
        tcp = self.tcps[self.tile]
        if b[0] in tcp.ppt:
            raise DecodeError("Zppt already read")
        tcp.ppt[b[0]] = b[1:]

    def handle(self, marker, b):
        if marker in _PART2:
            raise _unported(f"the {_PART2[marker]} marker (Parts 2 and 15)")
        {SIZ: self.read_siz, COD: self.read_cod, COC: self.read_coc,
         QCD: self.read_qcd, QCC: self.read_qcc, RGN: self.read_rgn,
         POC: self.read_poc, TLM: self.read_tlm, PLT: self.read_plt,
         PPM: self.read_ppm, PPT: self.read_ppt, SOT: self.read_sot,
         CRG: self.read_crg, PLM: self.read_plm,
         COM: lambda b: None}[marker](b)

    def read_crg(self, b):
        if len(b) != 4 * self.ncomp:
            raise DecodeError("Error reading CRG marker")

    def read_plm(self, b):
        if len(b) < 1:
            raise DecodeError("Error reading PLM marker")

    def read_unk(self) -> int:
        """opj_j2k_read_unk: steps two bytes at a time to the next known
        marker."""
        while True:
            b = self.s.read(2)
            if len(b) != 2:
                raise DecodeError("Stream too short")
            m = struct.unpack(">H", b)[0]
            if m < 0xFF00:
                continue
            states = _STATES.get(m, _UNK_STATES)
            if not self.state & states:
                raise DecodeError("Marker is not compliant with its position")
            if m in _STATES:
                return m

    # -- the main header --------------------------------------------------
    def read_main_header(self):
        s = self.s
        if s.read(2) != b"\xff\x4f":
            raise DecodeError("Expected a SOC marker")
        marker = s.read2()
        has = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise DecodeError("A marker ID was expected")
            if marker not in _STATES:
                marker = self.read_unk()
                if marker == SOT:
                    break
            has.add(marker)
            if not self.state & _STATES[marker]:
                raise DecodeError("Marker is not compliant with its position")
            size = s.read2()
            if size < 2:
                raise DecodeError("Invalid marker size")
            b = s.read(size - 2)
            if len(b) != size - 2:
                raise DecodeError("Stream too short")
            self.handle(marker, b)
            marker = s.read2()
        for m, name in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
            if m not in has:
                raise DecodeError(f"required {name} marker not found in "
                                  "main header")
        if self.ppm is not None:
            self.ppm = self.merge_ppm()
        self.tcps = [self.default.for_tile() for _ in range(self.tw *
                                                             self.th)]
        self.state = S_TPHSOT
        self.tile = 0
        self.can_decode = False
        self.last_part = False
        self.sot_length = 0
        self.correction_checked = False

    def merge_ppm(self) -> bytes:
        out, remaining = [], 0
        for z in sorted(self.ppm):
            d = self.ppm[z]
            if remaining >= len(d):
                remaining -= len(d)
                continue
            d, remaining = d[remaining:], 0
            while d:
                if len(d) < 4:
                    raise DecodeError("Not enough bytes to read Nppm")
                n = struct.unpack_from(">I", d)[0]
                d = d[4:]
                out.append(d[:n])
                if len(d) >= n:
                    d = d[n:]
                else:
                    remaining = n - len(d)
                    d = b""
        if remaining:
            raise DecodeError("Corrupted PPM markers")
        return b"".join(out)

    # -- tile-parts ---------------------------------------------------------
    def read_sot(self, b):
        if len(b) != 8:
            raise DecodeError("Error reading SOT marker")
        tile, psot, part, nparts = struct.unpack(">HIBB", b)
        if tile >= self.tw * self.th:
            raise DecodeError("Invalid tile number")
        self.tile = tile
        tcp = self.tcps[tile]
        if tcp.tile_part + 1 != part:
            raise DecodeError("Invalid tile part index")
        tcp.tile_part += 1
        if psot != 0 and psot < 14:
            if psot != 12:
                raise DecodeError("Psot value is not correct")
        self.last_part = psot == 0
        if tcp.nb_parts and part >= tcp.nb_parts:
            raise DecodeError("In SOT marker, TPSot is not valid")
        if nparts:
            if tcp.nb_parts and part >= tcp.nb_parts:
                raise DecodeError("In SOT marker, TPSot is not valid")
            if part >= nparts:
                raise DecodeError("In SOT marker, TPSot is not valid")
            tcp.nb_parts = nparts
        if tcp.nb_parts and tcp.nb_parts == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_part else psot - 12
        self.state = S_TPH

    def read_sod(self):
        s = self.s
        tcp = self.tcps[self.tile]
        if self.last_part:
            self.sot_length = (s.left() - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        n = self.sot_length
        if n > 0:
            if n > s.left():
                raise DecodeError("Tile part length size inconsistent with "
                                  "stream length")
            chunk = s.read(n)
            tcp.data = (tcp.data or b"") + chunk
        else:
            chunk = b""
        self.state = S_NEOC if len(chunk) != n else S_TPHSOT

    def needs_correction(self) -> bool:
        """opj_j2k_need_nb_tile_parts_correction: the next tile-part of this
        tile, if the following SOTs reach one, has TPsot == TNsot."""
        s = _Stream(self.s.data, self.s.pos)
        while True:
            b = s.read(2)
            if len(b) != 2 or struct.unpack(">H", b)[0] != SOT:
                return False
            b = s.read(2)
            if len(b) != 2:
                raise DecodeError("Stream too short")
            if struct.unpack(">H", b)[0] != 10:
                raise DecodeError("Inconsistent marker size")
            b = s.read(8)
            if len(b) != 8:
                raise DecodeError("Stream too short")
            tile, psot, part, nparts = struct.unpack(">HIBB", b)
            if tile == self.tile:
                return part == nparts
            if psot < 14:
                return False
            if psot - 12 > s.left():
                return False
            s.pos += psot - 12

    def read_tile_header(self):
        """The next tile to decode (its index), or None at the end."""
        s = self.s
        ntiles = self.tw * self.th
        if self.state == S_EOC:
            marker = EOC
        elif self.state != S_TPHSOT:
            raise DecodeError("opj_read_tile_header: no SOT expected")
        else:
            marker = SOT
        while not self.can_decode and marker != EOC:
            while marker != SOD:
                if s.left() == 0:
                    self.state = S_NEOC
                    break
                size = s.read2()
                if size < 2:
                    raise DecodeError("Inconsistent marker size")
                if marker == 0x8080 and s.left() == 0:
                    self.state = S_NEOC
                    break
                if self.state & S_TPH and self.sot_length != 0:
                    if self.sot_length < size + 2:
                        raise DecodeError("Sot length is less than marker "
                                          "size + marker ID")
                    self.sot_length -= size + 2
                states = _STATES.get(marker, _UNK_STATES)
                if not self.state & states:
                    raise DecodeError("Marker is not compliant with its "
                                      "position")
                if size - 2 > 1000 and size - 2 > s.left():
                    raise DecodeError("Marker size inconsistent with stream "
                                      "length")
                b = s.read(size - 2)
                if len(b) != size - 2:
                    raise DecodeError("Stream too short")
                if marker not in _STATES or marker == SOP:
                    raise DecodeError("Not sure how that happened.")
                self.handle(marker, b)
                marker = s.read2()
            if s.left() == 0 and self.state == S_NEOC:
                break
            self.read_sod()
            if self.can_decode and not self.correction_checked:
                self.correction_checked = True
                if self.needs_correction():
                    raise _unported("a tile-part count OpenJPEG corrects "
                                    "(TPsot == TNsot)")
            if not self.can_decode:
                b = s.read(2)
                if len(b) != 2:
                    if self.tile + 1 == ntiles:
                        for i, t in enumerate(self.tcps):
                            if t.tile_part == 0 and t.nb_parts == 0:
                                raise _unported("a tile with TPsot == 0 and "
                                                "TNsot == 0, EOC missing")
                    raise DecodeError("Stream too short")
                marker = struct.unpack(">H", b)[0]
        if marker == EOC and self.state != S_EOC:
            self.tile = 0
            self.state = S_EOC
        if not self.can_decode:
            while self.tile < ntiles and self.tcps[self.tile].data is None:
                self.tile += 1
            if self.tile == ntiles:
                return None
        self.state |= S_DATA
        return self.tile

    def after_tile(self):
        """The end of opj_j2k_decode_tile: the marker after the tile."""
        s = self.s
        self.tcps[self.tile].data = None
        self.can_decode = False
        self.state &= ~S_DATA
        if s.left() == 0 and self.state == S_NEOC:
            return
        if self.state != S_EOC:
            b = s.read(2)
            if len(b) != 2:
                raise DecodeError("Stream too short")
            m = struct.unpack(">H", b)[0]
            if m == EOC:
                self.tile = 0
                self.state = S_EOC
            elif m != SOT:
                if s.left() == 0:
                    self.state = S_NEOC
                    return
                raise DecodeError("Stream too short, expected SOT")

    # -- one tile -------------------------------------------------------------
    def tile_rect(self, t):
        p, q = t % self.tw, t // self.tw
        x0 = max(self.tx0 + p * self.tdx, self.x0)
        y0 = max(self.ty0 + q * self.tdy, self.y0)
        x1 = min(self.tx0 + (p + 1) * self.tdx, self.x1)
        y1 = min(self.ty0 + (q + 1) * self.tdy, self.y1)
        return x0, y0, x1, y1

    def decode_tile(self, t: int, spans=None):
        """One tile -> [(x0, y0, w, h, int32 samples)] per component."""
        tcp = self.tcps[t]
        x0, y0, x1, y1 = rect = self.tile_rect(t)
        comps = []
        cp = np.zeros((self.ncomp, _P_STRIDE), np.int32)
        for c, (tccp, (prec, sgnd, dx, dy)) in enumerate(zip(tcp.tccps,
                                                              self.comps)):
            if tccp.cblksty & 0x40:
                raise _unported("an HTJ2K code-block (the Part 15 style bit "
                                "0x40)")
            row = [dx, dy, prec, sgnd, tccp.numres, tccp.cblkw, tccp.cblkh,
                   tccp.cblksty, tccp.qmfbid, tccp.qntsty, tccp.numgbits,
                   tccp.roishift]
            cp[c, :12] = row
            cp[c, _P_PRCW:_P_PRCW + MAXRLVLS] = tccp.prcw
            cp[c, _P_PRCW + MAXRLVLS:_P_EXPN] = tccp.prch
            cp[c, _P_EXPN:_P_EXPN + MAXBANDS] = tccp.expn
            cp[c, _P_EXPN + MAXBANDS:] = tccp.mant
            cx0, cy0 = -(-x0 // dx), -(-y0 // dy)
            cx1, cy1 = -(-x1 // dx), -(-y1 // dy)
            comps.append((cx0, cy0, cx1 - cx0, cy1 - cy0))
        if tcp.ppt and self.ppm is not None:
            raise DecodeError("PPT and PPM")
        pocs = [v for q in tcp.pocs for v in q]
        tp = np.array([*rect, self.ncomp, tcp.numlayers, tcp.prg, tcp.csty,
                       tcp.mct, 0, len(tcp.pocs), *pocs], np.int32)
        hdr, pos = None, ctypes.c_longlong(0)
        if self.ppm is not None:
            hdr, pos.value = self.ppm, self.ppm_pos
        elif tcp.ppt:
            hdr = b"".join(tcp.ppt[z] for z in sorted(tcp.ppt))
        n = sum(w * h for _, _, w, h in comps)
        if n > MAX_TILE_SAMPLES:
            raise _unported(f"a tile of {n} samples")
        out = np.empty(max(n, 1), np.int32)
        data = tcp.data or b""
        msg = ctypes.create_string_buffer(256)
        sp, nsp = (None, 0) if spans is None else (spans.ctypes.data,
                                                   len(spans) // 3)
        # a thread per 64K samples, at most THREADS: starting threads costs
        # more than a small tile's decode
        threads = max(1, min(THREADS, n >> 16))
        st = library().kt_j2k_decode_tile(
            tp.ctypes.data, cp.ctypes.data, data, len(data), hdr,
            len(hdr) if hdr is not None else 0, ctypes.addressof(pos),
            out.ctypes.data, threads, sp, nsp, msg, len(msg))
        text = msg.value.decode(errors="replace")
        if st == 1:
            raise DecodeError(f"JPEG 2000: {text}")
        if st:
            raise _unported(text)
        if self.ppm is not None:
            self.ppm_pos = pos.value
        planes, o = [], 0
        for cx0, cy0, w, h in comps:
            planes.append((cx0, cy0, w, h, out[o:o + w * h].reshape(h, w)))
            o += w * h
        return planes


# ----------------------------------------------------------------------------
# PIL's Jpeg2KDecode.c
# ----------------------------------------------------------------------------

# (mode, colour space, components) -> unpacker
_UNPACKERS = {
    ("L", CS_GRAY, 1): "gray_l", ("P", CS_SRGB, 1): "gray_l",
    ("PA", CS_SRGB, 2): "graya_la", ("I;16", CS_GRAY, 1): "gray_i",
    ("LA", CS_GRAY, 2): "graya_la", ("RGB", CS_GRAY, 1): "gray_rgb",
    ("RGB", CS_GRAY, 2): "gray_rgb", ("RGB", CS_SRGB, 3): "srgb_rgb",
    ("RGB", CS_SYCC, 3): "sycc_rgb", ("RGB", CS_SRGB, 4): "srgb_rgb",
    ("RGB", CS_SYCC, 4): "sycc_rgb", ("RGBA", CS_GRAY, 1): "gray_rgb",
    ("RGBA", CS_GRAY, 2): "graya_la", ("RGBA", CS_SRGB, 3): "srgb_rgb",
    ("RGBA", CS_SYCC, 3): "sycc_rgb", ("RGBA", CS_SRGB, 4): "srgba_rgba",
    ("RGBA", CS_SYCC, 4): "sycca_rgba", ("RGBA", CS_GRAY, 4): "srgba_rgba",
    ("CMYK", CS_CMYK, 4): "srgba_rgba",
}
_SUBSAMPLED = ("srgb_rgb", "sycc_rgb", "srgba_rgba", "sycca_rgba")


def _csiz(prec: int) -> int:
    """Bytes a sample of the tile buffer takes (3 rounds up to 4)."""
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _tile_buffer(cs: _Codestream, planes) -> np.ndarray:
    """The buffer `opj_decode_tile_data` fills: each component's samples,
    `_csiz` bytes each (the int's low bytes), one component after
    another."""
    parts = []
    for (prec, _, _, _), plane in zip(cs.comps, planes):
        n = _csiz(prec)
        v = plane[4].astype(np.int64) & ((1 << (8 * n)) - 1)
        parts.append(v.astype(f"<u{n}").tobytes())
    return np.frombuffer(b"".join(parts), np.uint8)


def _word(buf: np.ndarray, off: np.ndarray, n: int) -> np.ndarray:
    """Unsigned little-endian words of n bytes at the byte offsets."""
    if off.size and int(off.max()) + n > buf.size:
        raise _unported("a tile PIL unpacks past the decoded samples (a "
                        "subsampled component)")
    v = np.zeros(off.shape, np.int64)
    for i in range(n):
        v |= buf[off + i].astype(np.int64) << (8 * i)
    return v


def _shifted(word: np.ndarray, prec: int, sgnd: int, bits: int):
    """j2ku_shift(offset + word, bits - prec) stored into `bits` bits."""
    out = np.uint16 if bits == 16 else np.uint8
    if prec == bits and not sgnd:
        return (word & ((1 << bits) - 1)).astype(out)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (word + offset) & 0xFFFFFFFF
    v = v >> -shift if shift < 0 else (v << shift) & 0xFFFFFFFF
    return (v & ((1 << bits) - 1)).astype(np.uint16 if bits == 16
                                          else np.uint8)


def _unpack(kind: str, cs: _Codestream, planes, img: np.ndarray, ox: int,
            oy: int, w: int, h: int) -> None:
    """One tile through PIL's unpacker, at (ox, oy) of the image: each
    component read from the tile buffer at PIL's offsets."""
    comps = cs.comps
    dst = img[oy:oy + h, ox:ox + w]
    reads = {"gray_l": 1, "gray_rgb": 1, "gray_i": 1, "graya_la": 2,
             "srgba_rgba": 4, "sycca_rgba": 4}.get(kind, 3)
    if all(p[4].shape == (h, w) for p in planes[:reads]):
        _unpack_planes(kind, comps, [p[4] for p in planes[:reads]], dst)
        return
    buf = _tile_buffer(cs, planes)
    y, x = np.mgrid[:h, :w].astype(np.int64)
    n0 = _csiz(comps[0][0])
    if kind in ("gray_l", "gray_rgb", "gray_i"):
        v = _shifted(_word(buf, n0 * (y * w + x), n0), *comps[0][:2],
                     16 if kind == "gray_i" else 8)
        if img.ndim == 2:
            dst[...] = v
        else:
            dst[..., :3] = v[..., None]
            dst[..., 3] = 255
        return
    if kind == "graya_la":
        n1 = _csiz(comps[1][0])
        v = _shifted(_word(buf, n0 * (y * w + x), n0), *comps[0][:2], 8)
        a = _shifted(_word(buf, n0 * w * h + n1 * (y * w + x), n1),
                     *comps[1][:2], 8)
        dst[..., :3] = v[..., None]
        dst[..., 3] = a
        return
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    out = np.full((h, w, 4), 255, np.uint8)
    start = 0
    for c in range(n):
        prec, sgnd, dx, dy = comps[c]
        k = _csiz(prec)
        off = start + k * ((y // dy) * (w // dx) + x // dx)
        out[..., c] = _shifted(_word(buf, off, k), prec, sgnd, 8)
        start += k * (w // dx) * (h // dy)
    if kind.startswith("sycc"):
        alpha = out[..., 3].copy()
        out = raster.ycbcr_to_rgba(out[..., :3])
        out[..., 3] = alpha
    dst[...] = out


def _unpack_planes(kind: str, comps, planes, dst: np.ndarray) -> None:
    """`_unpack` where every component PIL reads has the tile's size:
    PIL's offsets then read each plane in order."""
    def word(c):
        return planes[c].astype(np.int64) & ((1 << (8 * _csiz(comps[c][0])))
                                             - 1)
    if kind in ("gray_l", "gray_rgb", "gray_i"):
        v = _shifted(word(0), *comps[0][:2], 16 if kind == "gray_i" else 8)
        if dst.ndim == 2:
            dst[...] = v
        else:
            dst[..., :3] = v[..., None]
            dst[..., 3] = 255
        return
    if kind == "graya_la":
        dst[..., :3] = _shifted(word(0), *comps[0][:2], 8)[..., None]
        dst[..., 3] = _shifted(word(1), *comps[1][:2], 8)
        return
    out = np.full(dst.shape, 255, np.uint8)
    for c in range(len(planes)):
        out[..., c] = _shifted(word(c), *comps[c][:2], 8)
    if kind.startswith("sycc"):
        alpha = out[..., 3].copy()
        out = raster.ycbcr_to_rgba(out[..., :3])
        out[..., 3] = alpha
    dst[...] = out


def _decode(data: bytes, codec: str, size, mode: str, palette):
    """OpenJPEG under Jpeg2KDecode.c: the image in PIL's mode layout."""
    jp2 = None
    if codec == "jp2":
        jp2 = _Jp2()
        start = _jp2_procedure(jp2, data, 0, False)
        if "header" not in jp2.state:
            raise DecodeError("JP2H box missing (required)")
        cs = _Codestream(data, start, jp2.ihdr)
        space = _ENUMCS.get(jp2.enumcs, CS_UNKNOWN)
    else:
        cs = _Codestream(data, 0)
        space = CS_UNSPECIFIED
    n = cs.ncomp
    if n < 1 or n > 4:
        raise DecodeError("broken data stream: components")
    if space in (CS_UNSPECIFIED, CS_UNKNOWN):
        space = CS_GRAY if n <= 2 else CS_SRGB
        # an unstated colour space with subsampled chroma is taken as YCC
        if n >= 3 and any((dx, dy) != (1, 1)
                          for _, _, dx, dy in cs.comps[1:3]):
            space = CS_SYCC
    kind = _UNPACKERS.get((mode, space, n))
    if kind is None or (kind not in _SUBSAMPLED and
                        cs.comps[0][2:] != (1, 1)):
        raise DecodeError("broken data stream: no unpacker")
    w, h = size
    img = np.zeros((h, w) if mode in ("L", "P", "I;16") else (h, w, 4),
                   np.uint16 if mode == "I;16" else np.uint8)
    width = sum(_csiz(p) for p, _, _, _ in cs.comps)
    while True:
        t = cs.read_tile_header()
        if t is None:
            break
        x0, y0, x1, y1 = cs.tile_rect(t)
        if x0 >= x1 or y0 >= y1 or x0 < cs.x0 or y0 < cs.y0 or \
                x1 - cs.x0 > w or y1 - cs.y0 > h:
            raise DecodeError("broken data stream: tile outside the image")
        tw, th = x1 - x0, y1 - y0
        if tw * th * width > 0xFFFFFFFF:
            raise DecodeError("broken data stream: tile too large")
        planes = cs.decode_tile(t)
        if sum(_csiz(c[0]) * p[2] * p[3] for c, p in zip(cs.comps, planes)) \
                > tw * th * width:
            raise DecodeError("broken data stream: the tile exceeds PIL's "
                              "buffer")
        _unpack(kind, cs, planes, img, x0 - cs.x0, y0 - cs.y0, tw, th)
        cs.after_tile()
    if jp2 is not None:
        _jp2_procedure(jp2, data, cs.s.pos, True)
    return img


def _to_rgba(mode: str, img: np.ndarray, palette) -> np.ndarray:
    if mode == "L":
        return raster.to_rgba("L", img)
    if mode == "I;16":
        return raster.to_rgba("I;16", img)
    if mode in ("P", "PA"):
        pal = raster.palette("RGB", bytes(v for c in palette for v in c))
        idx = img if mode == "P" else img[..., 0]
        out = pal[idx]
        if mode == "PA":
            out[..., 3] = img[..., 3]
        return out
    if mode == "LA":
        return img.copy()
    if mode == "RGB":
        out = img.copy()
        out[..., 3] = 255
        return out
    if mode == "CMYK":
        return raster.cmyk_to_rgba(img)
    return img


def decode_j2k(data: bytes) -> np.ndarray:
    """JPEG 2000 bytes -> (H, W, 4) uint8 RGBA, as PIL's
    `convert("RGBA")`."""
    data = bytes(data)
    with opening("JPEG2000"):
        codec, size, mode, palette = _pil_open(data)
        if size[0] <= 0 or size[1] <= 0:
            raise SyntaxError("no mode or size (PIL: not identified)")
    check_pixels(*size)
    img = _decode(data, codec, size, mode, palette)
    return _to_rgba(mode, img, palette)


# ----------------------------------------------------------------------------
# the writer
# ----------------------------------------------------------------------------

_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def _jp2_wrap(codestream: bytes, width: int, height: int,
              ncomp: int) -> bytes:
    """A JP2 file around a codestream of 8-bit components: sRGB, or grey
    for one component."""
    hdr = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, ncomp, 7, 7,
                                    0, 0))
    hdr += _box(b"colr", struct.pack(">BBBI", 1, 0, 0,
                                     17 if ncomp == 1 else 16))
    return (JP2_SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ") +
            _box(b"jp2h", hdr) + _box(b"jp2c", codestream))


def encode_j2k(img: np.ndarray, mode: str = "RGB", *, jp2: bool = False,
               levels: int = 5, cblk: int = 32, progression: str = "LRCP",
               precinct: int | None = None):
    """A lossless JPEG 2000 file of an (H, W, 3 or 4) uint8 image in `mode`
    ("L" takes the first channel): the reversible 5/3 transform with
    `levels` decomposition levels, the RCT for three or four components,
    cblk x cblk code-blocks, one layer, one tile, `progression`, precincts
    of precinct x precinct (None: the maximal default), as a codestream or
    (jp2) a JP2 file. Returns (bytes, the (H, W, 4) texels it decodes
    to)."""
    nc = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    px = np.ascontiguousarray(img[..., :nc], np.uint8)
    h, w = px.shape[:2]
    exp = cblk.bit_length() - 1
    prec = 15 if precinct is None else precinct.bit_length() - 1
    if cblk != 1 << exp or not 2 <= exp <= 6 or (precinct is not None and
                                                 precinct != 1 << prec):
        raise ValueError("code-block and precinct sizes are powers of two")
    lib = library()
    args = (px.ctypes.data, w, h, nc, levels, exp,
            _PROGRESSIONS.index(progression), prec, THREADS)
    cap = 2 * px.size + 4096
    out = ctypes.create_string_buffer(cap)
    n = lib.kt_j2k_encode(*args, out, cap)
    if n < 0:
        raise ValueError("JPEG 2000 writer: a code-block exceeds its "
                         "bit-planes")
    if n > cap:
        out = ctypes.create_string_buffer(n)
        lib.kt_j2k_encode(*args, out, n)
    data = out.raw[:n]
    if jp2:
        data = _jp2_wrap(data, w, h, nc)
    texels = raster.to_rgba(mode, px[..., 0] if nc == 1 else px)
    return data, texels
