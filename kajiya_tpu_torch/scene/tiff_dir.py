"""libtiff 4.7.1's directory reader, as PIL 12.1.0's `TiffDecode.c` drives
it: `TIFFClientOpen(..., "rC", ...)` reads the first image file directory
with `TIFFReadDirectory`, and `TIFFSetSubDirectory` reads it again at the
offset PIL parsed. `read_directory` gives the fields that reader leaves
(`Directory`), or raises `TiffError` where it fails (PIL then raises
OSError, which the bake turns white).

The entries come from the file's bytes, as `TIFFFetchDirectory` reads
them, not from PIL's view of the directory (`tiff._Ifd`, in which the last
of a repeated tag wins and entries of an unknown type are dropped). Each
rule below was settled by probing the libtiff of PIL's wheel through
ctypes (`TIFFOpen(path, "rC")`, `TIFFGetField`, `TIFFNumberOfStrips`) on
files whose entries were retyped, recounted, repeated, reordered or left
out; `tests/test_torch_tiff_dir.py` holds every field to libtiff's on
every entry mutant of five seeds. In libtiff's terms:

- `TIFFFetchDirectory`: 1 to 4096 entries, all inside the file; each
  entry's value field is kept as its 4 (8 in BigTIFF) bytes.
- Duplicates: every later entry of a tag already seen is ignored (the
  first wins; PIL keeps the last). Entries out of order read on.
- SamplesPerPixel, then Compression are read first (Compression also as
  one value per sample); then a first pass reads ImageWidth, ImageLength,
  ImageDepth, TileWidth, TileLength, TileDepth, PlanarConfiguration,
  RowsPerStrip and ExtraSamples (any failure fails the directory) and
  ignores the tags of another codec; a second pass reads the rest, where
  a bad value is ignored with a warning, except BitsPerSample,
  SampleFormat, DataType, Min/MaxSampleValue and SMin/SMaxSampleValue,
  whose failures fail the directory.
- Type conversion (`TIFFReadDirEntry*`): an integer field takes any
  integer type whose value fits (a negative signed value, or one above the
  field's range, is an error), and no IFD or IFD8; a float field also
  takes the rationals and floats; an 8-byte value of a classic file is
  read at its offset. Arrays of a count other than the strips' are cut or
  padded with zeros (`TIFFFetchStripThing`).
- A missing StripByteCounts is estimated for one strip (or one strip per
  plane), and fails the directory otherwise (`MissingRequired`); so is a
  one-strip count of zero, or one that cannot hold an uncompressed strip
  (`ByteCountLooksBad`; `EstimateStripByteCounts`).
- Then the structure checks: a zero number of strips or tiles, a zero
  scanline, strip or tile size, a palette image without a Colormap below
  8 bits, an invalid YCbCr subsampling where the sizes use it (for
  old-style JPEG, once corrected from the data: `tiff._load_ojpeg`).

- Uncompressed files (which PIL decodes with its own raw decoder, not
  libtiff) also get libtiff's two recoveries of theirs: a single strip
  re-cut into strips of about 8 KiB (`ChopUpSingleUncompressedStrip`),
  and StripByteCounts re-estimated where the first two counts differ.

No directory raises NotImplementedError: the decoders that read the
fields do where libtiff's outcome is not modelled.
"""
from __future__ import annotations

import struct

import numpy as np

from .raster import DecodeError


class TiffError(DecodeError):
    """PIL raises while it opens or loads the TIFF: the bake turns the
    source white."""


# TIFFDataWidth: bytes per value of each type (0: a type libtiff does not
# know; NOTYPE counts 1)
_WIDTH = {0: 1, 1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
# struct codes of the integer types
_INT = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 16: "Q", 17: "q"}
_SIGNED = (6, 8, 9, 17)
# the types the TIFFReadDirEntry* readers take: the integer ones (Short,
# Long, Long8 and their arrays) every integer type but IFD and IFD8,
# ByteArray ASCII and UNDEFINED too, the float ones the rationals and floats
_INTS = tuple(_INT)
_TO_BYTE_ARRAY = (2, 7) + _INTS
_TO_FLOAT = _INTS + (5, 10, 11, 12)
# codecs that register the Predictor tag (LZW, deflate, LZMA, zstd)
PREDICTED = (5, 8, 32946, 34925, 50000)
# tags of the first pass, read with failures fatal (TIFFFetchNormalTag
# without recovery)
_FIRST_PASS = (256, 257, 32997, 322, 323, 32998, 284, 278, 338)
# the codec-specific tags read here and the compressions that take them
# (_TIFFCheckFieldIsValidForCodec: another codec's tag is ignored)
_CODEC_TAGS = {317: PREDICTED, 347: (7,), 513: (6,), 514: (6,), 515: (6,),
               519: (6,), 520: (6,), 521: (6,), 292: (3,)}
# _TIFFGetMaxColorChannels
_COLOR_CHANNELS = {3: 1, 0: 1, 1: 1, 6: 3, 2: 3, 8: 3, 32844: 3, 32845: 3,
                   9: 3, 10: 3, 5: 4, 4: 4}
# the tags of the second pass whose data sizes libtiff sums
_SIZED = (280, 281, 258, 32996, 339, 340, 341, 273, 324, 279, 325, 320, 301)
STRIP_SIZE_DEFAULT = 8192
_U64 = 2 ** 64 - 1


class _Err(Exception):
    """A TIFFReadDirEntryErr: "count", "type", "io", "range", "psdif" or
    "sizesan"."""


class Entry:
    """One directory entry as TIFFFetchDirectory keeps it."""

    __slots__ = ("tag", "typ", "count", "field", "ignore")

    def __init__(self, tag, typ, count, field):
        self.tag, self.typ, self.count, self.field = tag, typ, count, field
        self.ignore = False


def _howmany(x: int, y: int) -> int:
    """TIFFhowmany_32 (0 where x + y - 1 would overflow 32 bits)."""
    return (x + y - 1) // y if x < 0xFFFFFFFF - (y - 1) else 0


def _mul32(a: int, b: int) -> int:
    """_TIFFMultiply32: 0 on overflow."""
    return a * b if a * b <= 0xFFFFFFFF else 0


def _mul64(a: int, b: int) -> int:
    """_TIFFMultiply64: 0 on overflow."""
    return a * b if a * b <= _U64 else 0


class _Reader:
    """The TIFFReadDirEntry* family over the file's bytes (PIL's libtiff
    maps the whole buffer)."""

    def __init__(self, data: bytes, endian: str, big: bool):
        self.data, self.endian, self.big = data, endian, big
        self.inline = 8 if big else 4

    def _at(self, offset: int, size: int) -> bytes:
        """TIFFReadDirEntryData on a mapped file."""
        if offset + size > len(self.data):
            raise _Err("io")
        return self.data[offset:offset + size]

    def _offset(self, e: Entry) -> int:
        return struct.unpack(self.endian + ("Q" if self.big else "L"),
                             e.field[:self.inline])[0]

    def _decode(self, typ: int, raw: bytes, n: int) -> list:
        """n values of a type: ints, (numerator, denominator) pairs,
        floats, or bytes (ASCII, UNDEFINED)."""
        if typ in (5, 10):
            code = "L" if typ == 5 else "l"
            v = struct.unpack(f"{self.endian}{2 * n}{code}", raw)
            return list(zip(v[::2], v[1::2]))
        code = _INT.get(typ) or {11: "f", 12: "d"}.get(typ)
        if code:
            return list(struct.unpack(f"{self.endian}{n}{code}", raw))
        return list(raw)

    def scalar(self, e: Entry, accept) -> object:
        """One value (count 1), inline or, for an 8-byte type of a classic
        file, at its offset (TIFFReadDirEntryChecked*)."""
        if e.count != 1:
            raise _Err("count")
        if e.typ not in accept:
            raise _Err("type")
        w = _WIDTH[e.typ]
        raw = e.field[:w] if w <= self.inline else self._at(self._offset(e),
                                                            w)
        return self._decode(e.typ, raw, 1)[0]

    def array(self, e: Entry, accept, dest: int, maxcount=None) -> list:
        """TIFFReadDirEntryArrayWithLimit: the first min(count, maxcount)
        values, inline only where the whole entry fits its field."""
        if e.typ not in accept:
            raise _Err("type")
        w = _WIDTH[e.typ]
        n = e.count if maxcount is None else min(e.count, maxcount)
        if n == 0:
            return []
        if (2 ** 31 - 1) // w < n or (2 ** 31 - 1) // dest < n:
            raise _Err("sizesan")
        size = n * w
        if size > len(self.data):
            raise _Err("io")
        if min(e.count, 10) * w <= self.inline and size <= self.inline:
            raw = e.field[:size]
        else:
            raw = self._at(self._offset(e), size)
        return self._decode(e.typ, raw, n)


def _check(vals: list, typ: int, hi: int) -> list:
    """The range checks of an integer reader: a negative signed value, or
    one above `hi`, is an error."""
    for v in vals:
        if v < 0 and typ in _SIGNED or v > hi:
            raise _Err("range")
    return vals


def _to_float32(vals: list, typ: int) -> tuple:
    """TIFFReadDirEntryFloatArray: float32, a rational as float32(num) /
    float32(den), 0 for a zero denominator (probed with
    YCbCrCoefficients: 299 / 0 reads 0, 16777217 / 3 reads 5592405.5)."""
    f = np.float32
    if typ in (5, 10):
        return tuple(f(0) if den == 0 else f(num) / f(den)
                     for num, den in vals)
    return tuple(f(v) for v in vals)


class Directory:
    """The fields libtiff's TIFFReadDirectory leaves (`td_*`), as PIL's
    decoder reads them:
    width, length, bps, spp, compression, photometric (None where unset),
    planar, fillorder, sampleformat, predictor (1 unless the codec takes
    the tag), extra (ExtraSamples after the colour-channel fixup), tiled,
    tw / th (tile size), rps (RowsPerStrip; 2^32 - 1 where unset), nstrips
    (strips or tiles), per_plane (strips or tiles per image plane), across
    (tiles across), offsets / counts (StripOffsets / ByteCounts or the tile
    arrays, nstrips each), subsampling (YCbCrSubSampling) and
    subsampling_tag (whether the tag was read), colormap (whether one was
    kept), and the codecs' tags: jpegtables (bytes or None), t4options,
    ojpeg_if / ojpeg_if_len / ojpeg_restart, ojpeg_tables {519, 520, 521:
    offsets}, ycbcr_coefficients and reference_bw (float32 triples /
    sextuples, or None)."""

    def row_size(self, width: int) -> int:
        """TIFFScanlineSize / TIFFTileRowSize of `width` pixels (no YCbCr
        blocks)."""
        s = self.spp if self.planar == 1 else 1
        return (width * self.bps * s + 7) // 8


def _fetch_entries(data: bytes, offset: int, endian: str, big: bool) -> list:
    """TIFFFetchDirectory: the entries at `offset`, or TiffError."""
    size = len(data)
    head = 8 if big else 2
    if offset + head > size:
        raise TiffError("libtiff: can not read TIFF directory count")
    n = struct.unpack_from(endian + ("Q" if big else "H"), data, offset)[0]
    if n > 4096:
        raise TiffError("libtiff: sanity check on directory count failed")
    if n == 0:
        raise TiffError("libtiff: zero tag directories not supported")
    esize = 20 if big else 12
    start = offset + head
    if start + n * esize > size:
        raise TiffError("libtiff: can not read TIFF directory")
    fmt = endian + ("HHQ8s" if big else "HHL4s")
    return [Entry(*struct.unpack_from(fmt, data, start + k * esize))
            for k in range(n)]


def read_directory(data: bytes, offset: int) -> Directory:
    """TIFFClientOpen's header checks, then TIFFReadDirectory of the
    directory at `offset`: the Directory, or TiffError."""
    endian = ">" if data[:2] == b"MM" else "<"
    version = struct.unpack_from(endian + "H", data, 2)[0]
    if data[:2] not in (b"II", b"MM") or version not in (42, 43) or (
            version == 43 and struct.unpack_from(endian + "HH", data, 4)
            != (8, 0)):
        raise TiffError("libtiff: not a TIFF file (bad version)")
    big = version == 43
    entries = _fetch_entries(data, offset, endian, big)
    return _ReadDirectory(data, entries, endian, big).run()


class _ReadDirectory:
    """TIFFReadDirectory, step by step."""

    def __init__(self, data, entries, endian, big):
        self.data, self.entries = data, entries
        self.r = _Reader(data, endian, big)
        self.big = big
        d = self.d = Directory()
        # TIFFDefaultDirectory
        d.width = d.length = 0
        d.bps, d.spp, d.compression = 1, 1, 1
        d.photometric = None
        d.planar, d.fillorder, d.sampleformat = 1, 1, 1
        d.rps, d.tw, d.th = 2 ** 32 - 1, 0, 0
        d.imagedepth, d.tiledepth = 1, 1
        d.extra = ()
        d.subsampling, d.subsampling_tag = (2, 2), False
        d.colormap = False
        d.predictor = 1
        d.jpegtables = None
        d.t4options = 0
        d.ojpeg_if = d.ojpeg_if_len = d.ojpeg_restart = 0
        d.ojpeg_tables = {}
        d.ycbcr_coefficients = d.reference_bw = None
        self.set = set()            # the fields set (TIFFFieldSet)
        self.strip_entry = self.count_entry = None

    def first(self, tag):
        """TIFFReadDirectoryFindEntry: the first entry of `tag`."""
        for e in self.entries:
            if e.tag == tag:
                return e
        return None

    def short(self, e):
        return _check([self.r.scalar(e, _INTS)], e.typ, 0xFFFF)[0]

    def long(self, e):
        return _check([self.r.scalar(e, _INTS)], e.typ, 0xFFFFFFFF)[0]

    def long8(self, e):
        return _check([self.r.scalar(e, _INTS)], e.typ, _U64)[0]

    def shorts(self, e, maxcount=None):
        return _check(self.r.array(e, _INTS, 2, maxcount), e.typ, 0xFFFF)

    def long8s(self, e, maxcount=None):
        return _check(self.r.array(e, _INTS, 8, maxcount), e.typ, _U64)

    def per_sample_short(self, e):
        """TIFFReadDirEntryShort, then on a count error
        TIFFReadDirEntryPersampleShort: at least SamplesPerPixel values,
        the first SamplesPerPixel of them equal."""
        try:
            return self.short(e)
        except _Err as err:
            if str(err) != "count":
                raise
        if e.count < self.d.spp:
            raise _Err("count")
        vals = self.shorts(e)
        if not vals:
            raise _Err("count")
        if any(v != vals[0] for v in vals[1:self.d.spp]):
            raise _Err("psdif")
        return vals[0]

    # ---------------------------------------------------------------- fields

    def set_field(self, tag, v) -> bool:
        """_TIFFVSetField's checks of the fields read here: False where it
        refuses the value ("Bad value")."""
        d = self.d
        if tag == 256:
            d.width = v
        elif tag == 257:
            d.length = v
        elif tag == 277:
            if v == 0:
                return False
            d.spp = v
        elif tag == 278:
            if v == 0:
                return False
            d.rps = v
            if "tiledims" not in self.set:
                # a tile dimension read later keeps the other one from here
                d.tw, d.th = d.width, v
        elif tag == 284:
            if v not in (1, 2):
                return False
            d.planar = v
        elif tag == 266:
            if v not in (1, 2):
                return False
            d.fillorder = v
        elif tag in (322, 323):
            if tag == 322:
                d.tw = v
            else:
                d.th = v
            self.set.add("tiledims")
            return True
        elif tag == 32997:
            d.imagedepth = v
        elif tag == 32998:
            if v == 0:
                return False
            d.tiledepth = v
        elif tag == 258:
            d.bps = v
        elif tag == 339:
            if not 1 <= v <= 6:
                return False
            d.sampleformat = v
        elif tag == 32996:
            if v not in (0, 1, 2, 3):
                return False
            d.sampleformat = {0: 4, 1: 2, 2: 1, 3: 3}[v]
        elif tag == 262:
            d.photometric = v
        elif tag == 317:
            d.predictor = v
        elif tag == 292:
            d.t4options = v
        self.set.add(tag)
        return True

    def normal(self, e, recover: bool) -> bool:
        """TIFFFetchNormalTag of the tags the decoders read: False where
        the tag is not set (an error without recovery fails the
        directory)."""
        d, tag = self.d, e.tag
        try:
            if tag in (256, 257, 278, 322, 323, 32997, 32998, 292):
                return self.set_field(tag, self.long(e)) or self.fail(recover)
            if tag in (284, 266, 262, 317):
                return self.set_field(tag, self.short(e)) or self.fail(recover)
            if tag == 338:
                # ExtraSamples (setExtraSamples): at most SamplesPerPixel
                # values, each 0, 1 or 2 (Corel's 999 read as 2)
                if e.count > 0xFFFF:
                    raise _Err("count")
                vals = self.shorts(e)
                if e.count & 0xFFFF > d.spp or any(
                        v > 2 and v != 999 for v in vals):
                    return self.fail(recover)
                d.extra = tuple(2 if v == 999 else v for v in vals)
                self.set.add(338)
                return True
            if tag == 32995:
                # Matteing: one associated alpha
                v = self.short(e)
                d.extra = (1,) if v else ()
                self.set.add(338)
                return True
            if tag == 530:
                if e.count != 2:
                    return False
                v = tuple(self.shorts(e))
                if d.compression == 6:
                    v = tuple(x & 255 for x in v)
                d.subsampling, d.subsampling_tag = v, True
                return True
            if tag in (529, 532):
                n = 3 if tag == 529 else 6
                if e.count != n:
                    return False
                v = _to_float32(self.r.array(e, _TO_FLOAT, 4), e.typ)
                if tag == 529:
                    d.ycbcr_coefficients = v
                else:
                    d.reference_bw = v
                return True
            if tag == 347:
                vals = _check(self.r.array(e, _TO_BYTE_ARRAY, 1), e.typ, 255)
                if not vals:
                    return False        # JPEGVSetField refuses a count of 0
                d.jpegtables = bytes(vals)
                return True
            if tag in (513, 514):
                v = self.long8(e)
                if tag == 513:
                    d.ojpeg_if = v
                else:
                    d.ojpeg_if_len = v
                return True
            if tag == 515:
                d.ojpeg_restart = self.short(e)
                return True
            if tag in (519, 520, 521):
                v = self.long8s(e)
                if len(v) > 3:
                    return False        # OJPEGVSetField: "incorrect count"
                if v:
                    d.ojpeg_tables[tag] = tuple(v)
                return True
        except _Err:
            return self.fail(recover)
        return True

    @staticmethod
    def fail(recover: bool) -> bool:
        if not recover:
            raise TiffError("libtiff: directory entry of a bad type, count "
                            "or value")
        return False

    # ------------------------------------------------------------------ run

    def run(self) -> Directory:
        d, entries = self.d, self.entries
        seen = set()
        for e in entries:
            e.ignore = e.tag in seen
            seen.add(e.tag)
        e = self.first(277)
        if e is not None:
            try:
                spp = self.short(e)
            except _Err as err:
                raise TiffError("libtiff: bad SamplesPerPixel") from err
            if not self.set_field(277, spp):
                raise TiffError("libtiff: SamplesPerPixel of 0")
            e.ignore = True
        e = self.first(259)
        if e is not None:
            try:
                d.compression = self.per_sample_short(e)
            except _Err as err:
                raise TiffError("libtiff: bad Compression tag") from err
            e.ignore = True
        # the first pass
        for e in entries:
            if e.ignore:
                continue
            if e.tag in (273, 279, 324, 325):
                self.set.add("offsets" if e.tag in (273, 324) else "counts")
            elif e.tag in _FIRST_PASS:
                self.normal(e, recover=False)
                e.ignore = True
            elif e.tag in _CODEC_TAGS and \
                    d.compression not in _CODEC_TAGS[e.tag]:
                e.ignore = True
        if d.compression == 6 and d.planar == 2:
            # old-style JPEG: one strip offset and one byte count mean
            # contiguous samples, whatever the tag says
            offsets, counts = self.first(273), self.first(279)
            if offsets is not None and offsets.count == 1 and \
                    counts is not None and counts.count == 1:
                d.planar = 1
        if 256 not in self.set and 257 not in self.set:
            raise TiffError("libtiff: MissingRequired ImageLength")
        bps_read = False
        datasize = 0
        # the second pass
        for e in entries:
            if e.ignore:
                continue
            tag = e.tag
            if tag in _SIZED:
                # EvaluateIFDdatasizeReading: the sum of these entries' data
                # sizes past their fields must fit 64 bits
                n = _WIDTH.get(e.typ, 0) * e.count
                if n > _U64 or (n > (8 if self.big else 4) and
                                datasize + n > _U64):
                    raise TiffError("libtiff: too large IFD data size")
                if n > (8 if self.big else 4):
                    datasize += n
            if tag in (280, 281, 258, 32996, 339):
                try:
                    v = self.per_sample_short(e)
                except _Err as err:
                    raise TiffError(f"libtiff: bad tag {tag}") from err
                if not self.set_field(tag, v):
                    raise TiffError(f"libtiff: bad value of tag {tag}")
                bps_read |= tag == 258
            elif tag in (340, 341):
                try:
                    if e.count != d.spp:
                        raise _Err("count")
                    self.r.array(e, _TO_FLOAT, 8)
                except _Err as err:
                    raise TiffError(f"libtiff: bad tag {tag}") from err
            elif tag in (273, 324):
                self.strip_entry = e
            elif tag in (279, 325):
                self.count_entry = e
            elif tag in (320, 301):
                if tag == 320 and bps_read and d.bps <= 24:
                    try:
                        if e.count != 3 << d.bps:
                            raise _Err("count")
                        self.shorts(e)
                        d.colormap = True
                    except _Err:
                        pass
            else:
                self.normal(e, recover=True)
        if d.compression == 6:
            # the OJPEG hacks: YCbCr where Photometric is missing or RGB,
            # 8 bits, 3 or 1 samples
            if d.photometric is None or d.photometric == 2:
                d.photometric = 6
            if 258 not in self.set:
                d.bps = 8
            if 277 not in self.set and d.photometric == 6:
                d.spp = 3
            elif 277 not in self.set and d.photometric in (0, 1):
                d.spp = 1
        self.structure()
        return d

    def structure(self):
        d = self.d
        d.tiled = "tiledims" in self.set
        if d.tiled:
            tw, th, tz = d.tw, d.th, d.tiledepth
            n = 0 if 0 in (tw, th, tz) else _mul32(_mul32(
                _howmany(d.width, tw), _howmany(d.length, th)),
                _howmany(d.imagedepth, tz))
            d.across = _howmany(d.width, tw) if tw else 0
        else:
            n = 1 if d.rps == 2 ** 32 - 1 else _howmany(d.length, d.rps)
        if d.planar == 2:
            n = _mul32(n, d.spp)
        if n == 0:
            raise TiffError("libtiff: cannot handle zero number of strips "
                            "or tiles")
        d.nstrips = n
        d.per_plane = n // d.spp if d.planar == 2 else n
        if "offsets" not in self.set and not (
                d.compression == 6 and not d.tiled and n == 1):
            raise TiffError("libtiff: MissingRequired StripOffsets")
        # an old-style JPEG strip without an offset or a byte count reads
        # them as 0
        d.offsets = self.strip_array(self.strip_entry, n) \
            if self.strip_entry is not None else (0,) * n
        d.counts = self.strip_array(self.count_entry, n) \
            if self.count_entry is not None else None
        # every sample past the photometric's colour channels is an extra
        # sample (unspecified)
        colors = _COLOR_CHANNELS.get(d.photometric or 0, 0)
        if colors and d.spp - len(d.extra) > colors:
            d.extra = d.extra + (0,) * (d.spp - colors - len(d.extra))
        if (d.photometric or 0) == 3 and not d.colormap:
            if d.bps >= 8 and d.spp == 3:
                d.photometric = 2
            elif d.bps >= 8:
                d.photometric = 1
            else:
                raise TiffError("libtiff: MissingRequired Colormap")
        if d.compression != 6:
            self.byte_counts()
        elif d.counts is None:
            d.counts = (0,) * n
        if d.planar == 1 and d.nstrips == 1 and d.compression == 1 and \
                not d.tiled:
            self.chop()
        if self.scanline_size() == 0:
            raise TiffError("libtiff: cannot handle zero scanline size")
        if d.tiled:
            if self.tile_size() == 0:
                raise TiffError("libtiff: cannot handle zero tile size")
        elif self.strip_size(min(d.rps, d.length)) == 0:
            raise TiffError("libtiff: cannot handle zero strip size")

    def strip_array(self, e, n):
        """TIFFFetchStripThing: n values, cut or padded with zeros."""
        try:
            vals = self.long8s(e, n)
        except _Err as err:
            raise TiffError("libtiff: bad strip or tile array") from err
        if e.count < n:
            if n > 1000000:
                raise TiffError("libtiff: strip array too large to pad")
            vals = vals + [0] * (n - len(vals))
        return tuple(vals)

    def byte_counts(self):
        """The recoveries of a missing or bogus StripByteCounts."""
        d = self.d
        if d.counts is None:
            if (d.planar == 1 and d.nstrips > 1) or \
                    (d.planar == 2 and d.nstrips != d.spp):
                raise TiffError("libtiff: MissingRequired StripByteCounts")
            self.estimate()
        elif d.nstrips == 1 and not d.tiled and self.count_looks_bad():
            self.estimate()
        elif d.planar == 1 and d.nstrips > 2 and d.compression == 1 and \
                d.counts[0] != d.counts[1] and d.counts[0] and d.counts[1]:
            self.estimate()

    def count_looks_bad(self) -> bool:
        d = self.d
        count, offset = d.counts[0], d.offsets[0]
        if offset == 0:
            return False
        if count == 0:
            return True
        if d.compression != 1:
            return False
        size = len(self.data)
        if offset <= size and count > size - offset:
            return True
        line = self.scanline_size()
        if d.length > 0 and line > _U64 // d.length:
            return True
        return count < line * d.length

    def estimate(self):
        """EstimateStripByteCounts."""
        d = self.d
        size = len(self.data)
        if d.compression != 1:
            space = (16 + 8 + len(self.entries) * 20 + 8) if self.big else \
                (8 + 2 + len(self.entries) * 12 + 4)
            for e in self.entries:
                w = _WIDTH.get(e.typ, 0)
                if w == 0:
                    raise TiffError("libtiff: cannot determine the size of "
                                    "an unknown tag type")
                n = w * e.count
                space += n if n > (8 if self.big else 4) else 0
            space = size - space if size >= space else size
            if d.planar == 2:
                space //= d.spp
            counts = [space] * d.nstrips
            last = d.offsets[-1]
            if last + counts[-1] > size:
                counts[-1] = 0 if last >= size else size - last
        elif d.tiled:
            counts = [self.tile_size()] * d.nstrips
        else:
            line = self.scanline_size()
            rows = d.length // (d.nstrips // d.spp if d.planar == 2
                                else d.nstrips)
            counts = [line * rows] * d.nstrips
        d.counts = tuple(counts)
        if 278 not in self.set:
            d.rps = d.length

    def chop(self):
        """ChopUpSingleUncompressedStrip: one uncompressed strip cut into
        strips of about STRIP_SIZE_DEFAULT bytes."""
        d = self.d
        count, offset = d.counts[0], d.offsets[0]
        rowblock = d.subsampling[1] if d.photometric == 6 else 1
        d.tw, d.th = d.width, d.rps
        rowblockbytes = self.tile_size(rowblock)
        if rowblockbytes > STRIP_SIZE_DEFAULT:
            stripbytes, rps = rowblockbytes, rowblock
        elif rowblockbytes > 0:
            per = STRIP_SIZE_DEFAULT // rowblockbytes
            rps, stripbytes = per * rowblock, per * rowblockbytes
        else:
            return
        if rps >= d.rps:
            return
        n = _howmany(d.length, rps)
        if n == 0:
            return
        if n > 1000000 and (offset >= len(self.data) or stripbytes > (
                len(self.data) - offset) // (n - 1)):
            return
        left = count
        counts, offsets = [], []
        for _ in range(n):
            stripbytes = min(stripbytes, left)
            counts.append(stripbytes)
            offsets.append(offset if stripbytes else 0)
            offset += stripbytes
            left -= stripbytes
        d.nstrips = d.per_plane = n
        d.rps = rps
        d.counts, d.offsets = tuple(counts), tuple(offsets)

    # ---------------------------------------------------------------- sizes

    def ycbcr_blocks(self) -> bool:
        d = self.d
        return d.planar == 1 and d.photometric == 6

    def sampling(self) -> tuple:
        """The YCbCr subsampling the sizes use. Old-style JPEG corrects it
        from the data's frame header first (OJPEGSubsamplingCorrect, which
        `tiff._load_ojpeg` models and checks), so it is not checked here."""
        return (1, 1) if self.d.compression == 6 else self.d.subsampling

    def subsampling_ok(self) -> bool:
        return all(v in (1, 2, 4) for v in self.sampling())

    def scanline_size(self) -> int:
        """TIFFScanlineSize64."""
        d = self.d
        if d.planar == 1:
            if self.ycbcr_blocks() and d.spp == 3:
                if not self.subsampling_ok():
                    return 0
                hs, vs = self.sampling()
                row = _mul64(_howmany(d.width, hs), hs * vs + 2)
                return -(-_mul64(row, d.bps) // 8) // vs
            return -(-_mul64(_mul64(d.width, d.spp), d.bps) // 8)
        return -(-_mul64(d.width, d.bps) // 8)

    def strip_size(self, rows: int) -> int:
        """TIFFVStripSize64."""
        d = self.d
        if self.ycbcr_blocks():
            if d.spp != 3 or not self.subsampling_ok():
                return 0
            hs, vs = self.sampling()
            row = _mul64(_howmany(d.width, hs), hs * vs + 2)
            return _mul64(-(-_mul64(row, d.bps) // 8), _howmany(rows, vs))
        return _mul64(rows, self.scanline_size())

    def tile_size(self, rows=None) -> int:
        """TIFFVTileSize64 of `rows` rows (the tile length by default)."""
        d = self.d
        rows = d.th if rows is None else rows
        if d.th == 0 or d.tw == 0 or d.tiledepth == 0:
            return 0
        if self.ycbcr_blocks() and d.spp == 3:
            if not self.subsampling_ok():
                return 0
            hs, vs = self.sampling()
            row = _mul64(_howmany(d.tw, hs), hs * vs + 2)
            return _mul64(-(-_mul64(row, d.bps) // 8), _howmany(rows, vs))
        rowsize = _mul64(d.bps, d.tw)
        if d.planar == 1:
            rowsize = _mul64(rowsize, d.spp)
        return _mul64(rows, -(-rowsize // 8))
