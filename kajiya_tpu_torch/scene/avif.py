"""AVIF textures: what PIL 12.1.0's `Image.open(f)` does with them, over
libavif 1.3.0, up to the AV1 decode.

PIL's `AvifImagePlugin._open` hands the bytes to libavif's
`avifDecoderParse` (through `_avif.AvifDecoder`; of libavif's strict flags
PIL's decoder keeps only `AVIF_STRICT_ALPHA_ISPE_REQUIRED`, so a missing
`pixi` and an invalid `clap` pass) and maps its failures: an invalid
`ftyp`, a box that does not parse, truncated data and no content raise
SyntaxError,
so `Image.open` goes on to the next plugin (`Refused` here); every other
failure raises RuntimeError or ValueError, which the bake turns white
(`raster.DecodeError` here). This module mirrors that parse statement by
statement:
- the top-level box walk (`ftyp` and its brands, `meta`, `moov`, the early
  stop once the brands' boxes are seen, boxes of size 0 and 1);
- `meta`: `hdlr pict` first, `iloc` (versions 0-2, every field size,
  construction methods 0 and 1), `pitm`, `idat`, `iinf` / `infe` (versions
  2-3), `iref` (`thmb`, `auxl`, `cdsc`, `dimg`, `prem`), `iprp` / `ipco` /
  `ipma` with the essential flag; the properties `ispe`, `auxC`, `colr`,
  `av1C`, `pasp`, `clap`, `irot`, `imir`, `pixi`, `a1op`, `lsel`, `a1lx`,
  `clli`;
- `moov` for `avis` sequences (`tkhd`, `tref`, `mdia` / `mdhd` / `minf` /
  `stbl` with `stsd av01`, `stsc`, `stsz`, `stco` / `co64`, `stss`,
  `stts`), libavif's choice of source (tracks for the `avis` major brand or
  a file with tracks and no `avif` major brand, the primary item otherwise);
- the checks after the walk: each image item's `ispe` and the size limits,
  the primary colour item (`av01` or `grid`), its alpha item, grid payloads
  and their cells, `av1C`, `pixi` against it, `colr` duplicates, Exif and
  XMP items, and without an nclx `colr` the sequence header's search
  through the first cell's payload.

`load` then reads frame 0's samples (`avifDecoderNthImage`): a payload
past the end of the file fails there, and the bake turns it white. A file
that passes both is one PIL hands to dav1d: the port cannot decode AV1
(ROADMAP.md section 1), so it raises NotImplementedError.
"""
from __future__ import annotations

import struct

from .identify import Refused, check_pixels
from .raster import DecodeError

# avifResult values
OK = 0
INVALID_FTYP = 2
NO_CONTENT = 3
BMFF_PARSE_FAILED = 9
MISSING_IMAGE_ITEM = 10
INVALID_EXIF_PAYLOAD = 17
INVALID_IMAGE_GRID = 18
TRUNCATED_DATA = 20
NOT_IMPLEMENTED = 25
# the results PIL's `_avif` raises as SyntaxError
SYNTAX_ERRORS = (INVALID_FTYP, NO_CONTENT, BMFF_PARSE_FAILED, TRUNCATED_DATA)

IMAGE_SIZE_LIMIT = 16384 * 16384
IMAGE_DIMENSION_LIMIT = 32768
IMAGE_COUNT_LIMIT = 30 * 24 * 60 * 60  # libavif's default
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
SUPPORTED_PROPERTIES = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp",
                        b"clap", b"irot", b"imir", b"pixi", b"a1op", b"lsel",
                        b"a1lx", b"clli")


class _Fail(Exception):
    """A libavif parse function returned false (or a result code)."""

    def __init__(self, code=BMFF_PARSE_FAILED):
        super().__init__(code)
        self.code = code


def _check(cond, code=BMFF_PARSE_FAILED):
    if not cond:
        raise _Fail(code)


class _Stream:
    """libavif's avifROStream over a slice of the file."""

    def __init__(self, data: bytes, start: int = 0, end: int | None = None):
        self.data = data
        self.start = start
        self.end = len(data) if end is None else end
        self.pos = start
        self.bit = 0  # bits consumed of data[pos]

    def remaining(self) -> int:
        return self.end - self.pos

    def has(self, n: int) -> bool:
        return n <= self.remaining()

    def read(self, n: int) -> bytes:
        _check(self.bit == 0 and self.has(n))
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def skip(self, n: int):
        _check(self.bit == 0 and self.has(n))
        self.pos += n

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.read(8))[0]

    def ux8(self, factor: int) -> int:
        if factor == 0:
            return 0
        if factor == 1:
            return self.u8()
        if factor == 2:
            return self.u16()
        if factor == 4:
            return self.u32()
        if factor == 8:
            return self.u64()
        raise _Fail()

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            _check(self.pos < self.end)
            b = (self.data[self.pos] >> (7 - self.bit)) & 1
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
            v = (v << 1) | b
        return v

    def version_and_flags(self):
        v = self.u8()
        flags = int.from_bytes(self.read(3), "big")
        return v, flags

    def enforce_version(self, want: int):
        v, flags = self.version_and_flags()
        _check(v == want)
        return flags

    def string(self) -> bytes:
        _check(self.bit == 0)
        i = self.data.find(b"\0", self.pos, self.end)
        _check(i >= 0)
        out = self.data[self.pos:i]
        self.pos = i + 1
        return out

    def box_header_partial(self, top_level: bool):
        """(type, payload size or None for a size-0 box)."""
        start = self.pos
        small = self.u32()
        typ = self.read(4)
        size = small
        if size == 1:
            size = self.u64()
        if typ == b"uuid":
            self.read(16)
        used = self.pos - start
        if size == 0:
            _check(top_level)
            return typ, None
        _check(size >= used)
        return typ, size - used

    def box_header(self):
        typ, size = self.box_header_partial(False)
        _check(size <= self.remaining())
        return typ, size


# ----------------------------------------------------------------------------
# items and properties
# ----------------------------------------------------------------------------

class _Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.extents = []
        self.size = 0
        self.idat_stored = False
        self.properties = []  # (type, parsed) in association order
        self.ipma_seen = False
        self.unsupported_essential = False
        self.thumbnail_for = 0
        self.aux_for = 0
        self.desc_for = 0
        self.dimg_for = 0
        self.dimg_idx = 0
        self.width = 0
        self.height = 0
        self.content_type = b""

    def skipped(self) -> bool:
        """avifDecoderItemShouldBeSkipped."""
        return (not self.size or self.unsupported_essential or
                self.type not in (b"av01", b"grid") or self.thumbnail_for != 0)

    def prop(self, typ: bytes):
        for t, v in self.properties:
            if t == typ:
                return v
        return None


class _Meta:
    def __init__(self):
        self.items = {}  # id -> _Item, in creation order
        self.properties = []
        self.primary = 0
        self.idat = None

    def item(self, item_id: int) -> _Item:
        _check(item_id != 0)
        it = self.items.get(item_id)
        if it is None:
            it = self.items[item_id] = _Item(item_id)
        return it


def _parse_property(typ: bytes, s: _Stream):
    if typ == b"ispe":
        s.enforce_version(0)
        return (s.u32(), s.u32())
    if typ == b"auxC":
        s.enforce_version(0)
        return s.string()
    if typ == b"colr":
        kind = s.read(4)
        if kind in (b"rICC", b"prof"):
            return ("icc", s.remaining())
        if kind == b"nclx":
            cp, tc, mc = s.u16(), s.u16(), s.u16()
            full = s.bits(1)
            _check(s.bits(7) == 0)
            return ("nclx", cp, tc, mc, full)
        return ("other",)
    if typ == b"av1C":
        marker = s.bits(1)
        _check(marker)
        version = s.bits(7)
        _check(version == 1)
        f = [s.bits(n) for n in (3, 5, 1, 1, 1, 1, 1, 1, 2)]
        s.bits(3)
        if s.bits(1):
            s.bits(4)
        else:
            s.bits(4)
        return tuple(f)  # profile, level, tier, high bd, 12 bit, mono, ssx, ssy, csp
    if typ == b"pasp":
        return (s.u32(), s.u32())
    if typ == b"clap":
        return tuple(s.u32() for _ in range(8))
    if typ == b"irot":
        _check(s.bits(6) == 0)
        return s.bits(2)
    if typ == b"imir":
        _check(s.bits(7) == 0)
        return s.bits(1)
    if typ == b"pixi":
        s.enforce_version(0)
        n = s.u8()
        _check(0 < n <= 4, NOT_IMPLEMENTED)
        depths = [s.u8() for _ in range(n)]
        for d in depths[1:]:
            _check(d == depths[0], NOT_IMPLEMENTED)
        return depths
    if typ == b"a1op":
        op = s.u8()
        _check(op <= 31)
        return op
    if typ == b"lsel":
        layer = s.u16()
        _check(layer == 0xFFFF or layer < 4)
        return layer
    if typ == b"a1lx":
        s.bits(7)
        large = s.bits(1)
        return tuple((s.u32() if large else s.u16()) for _ in range(3))
    if typ == b"clli":
        return (s.u16(), s.u16())
    return None


def _parse_ipco(data: bytes, start: int, end: int, props: list):
    s = _Stream(data, start, end)
    while s.has(1):
        typ, size = s.box_header()
        if typ in SUPPORTED_PROPERTIES:
            props.append((typ, _parse_property(typ, _Stream(data, s.pos, s.pos + size))))
        else:
            props.append((typ, None))
        s.skip(size)


def _parse_ipma(meta: _Meta, data: bytes, start: int, end: int) -> int:
    s = _Stream(data, start, end)
    version, flags = s.version_and_flags()
    u15 = flags & 1
    count = s.u32()
    prev = 0
    for _ in range(count):
        item_id = s.u16() if version < 1 else s.u32()
        _check(item_id != 0)
        _check(item_id > prev)
        prev = item_id
        item = meta.item(item_id)
        _check(not item.ipma_seen)
        item.ipma_seen = True
        n = s.u8()
        for _ in range(n):
            essential = s.bits(1)
            index = s.bits(15 if u15 else 7)
            if index == 0:
                _check(not essential)
                continue
            index -= 1
            _check(index < len(meta.properties))
            typ, val = meta.properties[index]
            if typ in SUPPORTED_PROPERTIES:
                # a1lx must not be essential; the transformative and
                # layer-selecting properties must be
                if essential:
                    _check(typ != b"a1lx")
                else:
                    _check(typ not in (b"clap", b"irot", b"imir", b"a1op",
                                       b"lsel"))
                item.properties.append((typ, val))
            elif essential:
                item.unsupported_essential = True
    return (version << 24) | flags


def _parse_iprp(meta: _Meta, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    typ, size = s.box_header()
    _check(typ == b"ipco")
    _parse_ipco(data, s.pos, s.pos + size, meta.properties)
    s.skip(size)
    seen = []
    while s.has(1):
        typ, size = s.box_header()
        _check(typ == b"ipma")
        vf = _parse_ipma(meta, data, s.pos, s.pos + size)
        _check(vf not in seen)
        _check(len(seen) < 32)
        seen.append(vf)
        s.skip(size)


def _parse_iloc(meta: _Meta, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    version, _flags = s.version_and_flags()
    _check(version <= 2)
    offset_size = s.bits(4)
    length_size = s.bits(4)
    base_offset_size = s.bits(4)
    index_size = s.bits(4)
    if version not in (1, 2):
        index_size = 0
    for v in (offset_size, length_size, base_offset_size, index_size):
        _check(v in (0, 4, 8))
    count = s.u16() if version < 2 else s.u32()
    for _ in range(count):
        item_id = s.u16() if version < 2 else s.u32()
        _check(item_id != 0)
        item = meta.item(item_id)
        _check(not item.extents)
        if version in (1, 2):
            _check(s.bits(12) == 0)
            method = s.bits(4)
            _check(method in (0, 1))
            if method == 1:
                item.idat_stored = True
        s.u16()  # data_reference_index
        base = s.ux8(base_offset_size)
        n = s.u16()
        for _ in range(n):
            if index_size:
                s.ux8(index_size)
            off = s.ux8(offset_size)
            length = s.ux8(length_size)
            _check(off <= (1 << 64) - 1 - base)
            item.extents.append((base + off, length))
            item.size += length


def _parse_infe(meta: _Meta, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    version, _flags = s.version_and_flags()
    _check(version in (2, 3))
    item_id = s.u16() if version == 2 else s.u32()
    _check(item_id != 0)
    s.u16()  # item_protection_index
    typ = s.read(4)
    s.string()  # item_name
    content_type = s.string() if typ == b"mime" else b""
    item = meta.item(item_id)
    item.type = typ
    item.content_type = content_type


def _parse_iinf(meta: _Meta, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    version, _flags = s.version_and_flags()
    if version == 0:
        count = s.u16()
    elif version == 1:
        count = s.u32()
    else:
        raise _Fail()
    for _ in range(count):
        typ, size = s.box_header()
        _check(typ == b"infe")
        _parse_infe(meta, data, s.pos, s.pos + size)
        s.skip(size)


def _parse_iref(meta: _Meta, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    version, _flags = s.version_and_flags()
    while s.has(1):
        typ, size = s.box_header()
        if version == 0:
            from_id = s.u16()
        elif version == 1:
            from_id = s.u32()
        else:
            break
        _check(from_id != 0)
        count = s.u16()
        for idx in range(count):
            to_id = s.u16() if version == 0 else s.u32()
            _check(to_id != 0)
            if from_id and to_id:
                item = meta.item(from_id)
                if typ == b"thmb":
                    item.thumbnail_for = to_id
                elif typ == b"auxl":
                    item.aux_for = to_id
                elif typ == b"cdsc":
                    item.desc_for = to_id
                elif typ == b"dimg":
                    dimg = meta.item(to_id)
                    # a to_item_ID occurs at most once in an array
                    _check(dimg.dimg_for != from_id, INVALID_IMAGE_GRID)
                    dimg.dimg_for = from_id
                    dimg.dimg_idx = idx


def _parse_hdlr(data: bytes, start: int, end: int, pict: bool = True) -> bytes:
    """avifParseHandlerBox (a track's handler may be any type)."""
    s = _Stream(data, start, end)
    s.enforce_version(0)
    _check(s.u32() == 0)
    handler = s.read(4)
    _check(not pict or handler == b"pict")
    for _ in range(3):
        s.u32()
    s.string()
    return handler


def _parse_meta(data: bytes, start: int, end: int) -> _Meta:
    meta = _Meta()
    s = _Stream(data, start, end)
    s.enforce_version(0)
    first = True
    seen = set()
    while s.has(1):
        typ, size = s.box_header()
        body = (data, s.pos, s.pos + size)
        if first:
            _check(typ == b"hdlr")
            seen.add(typ)
            _parse_hdlr(*body)
        elif typ in (b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            _check(typ not in seen)
            seen.add(typ)
            if typ == b"iloc":
                _parse_iloc(meta, *body)
            elif typ == b"pitm":
                ps = _Stream(*body)
                version, _flags = ps.version_and_flags()
                meta.primary = ps.u16() if version == 0 else ps.u32()
            elif typ == b"idat":
                _check(size > 0)
                meta.idat = data[s.pos:s.pos + size]
            elif typ == b"iprp":
                _parse_iprp(meta, *body)
            elif typ == b"iinf":
                _parse_iinf(meta, *body)
            else:
                _parse_iref(meta, *body)
        first = False
        s.skip(size)
    _check(not first)
    return meta


# ----------------------------------------------------------------------------
# tracks (avis)
# ----------------------------------------------------------------------------

class _Track:
    def __init__(self):
        self.id = 0
        self.aux_for = 0
        self.width = 0
        self.height = 0
        self.chunks = []      # offsets
        self.sample_to_chunk = []
        self.sample_sizes = []
        self.sample_size_all = 0
        self.sample_count = 0
        self.formats = []     # (format, properties)
        self.has_stbl = False


def _parse_stsd(track: _Track, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    s.enforce_version(0)
    count = s.u32()
    for _ in range(count):
        typ, size = s.box_header()
        props = []
        if typ == b"av01":
            es = _Stream(data, s.pos, s.pos + size)
            es.skip(78)  # VisualSampleEntry
            _parse_ipco(data, es.pos, es.end, props)
        track.formats.append((typ, props))
        s.skip(size)


def _parse_stbl(track: _Track, data: bytes, start: int, end: int):
    _check(not track.has_stbl)
    track.has_stbl = True
    s = _Stream(data, start, end)
    while s.has(1):
        typ, size = s.box_header()
        b = _Stream(data, s.pos, s.pos + size)
        if typ in (b"stco", b"co64"):
            b.enforce_version(0)
            n = b.u32()
            for _ in range(n):
                track.chunks.append(b.u32() if typ == b"stco" else b.u64())
        elif typ == b"stsc":
            b.enforce_version(0)
            n = b.u32()
            prev = 0
            for i in range(n):
                first, per, desc = b.u32(), b.u32(), b.u32()
                _check(first == 1 if i == 0 else first > prev)
                prev = first
                track.sample_to_chunk.append((first, per, desc))
        elif typ == b"stsz":
            b.enforce_version(0)
            all_size = b.u32()
            n = b.u32()
            track.sample_size_all = all_size
            track.sample_count = n
            if not all_size:
                for _ in range(n):
                    track.sample_sizes.append(b.u32())
        elif typ == b"stss":
            b.enforce_version(0)
            n = b.u32()
            for _ in range(n):
                b.u32()
        elif typ == b"stts":
            b.enforce_version(0)
            n = b.u32()
            for _ in range(n):
                b.u32()
                b.u32()
        elif typ == b"stsd":
            _parse_stsd(track, data, s.pos, s.pos + size)
        s.skip(size)


def _parse_trak(data: bytes, start: int, end: int, tracks: list):
    track = _Track()
    tracks.append(track)
    s = _Stream(data, start, end)
    tkhd = edts = False
    while s.has(1):
        typ, size = s.box_header()
        b = _Stream(data, s.pos, s.pos + size)
        if typ == b"tkhd":
            tkhd = True
            version, _flags = b.version_and_flags()
            if version == 1:
                b.u64(); b.u64()
                track.id = b.u32()
                b.u32()
                b.u64()
            elif version == 0:
                b.u32(); b.u32()
                track.id = b.u32()
                b.u32()
                b.u32()
            else:
                raise _Fail()
            b.skip(8 + 2 + 2 + 2 + 2 + 36)
            track.width = b.u32() >> 16
            track.height = b.u32() >> 16
            _check(track.width and track.height)
            _check(track.width * track.height <= IMAGE_SIZE_LIMIT and
                   track.width <= IMAGE_DIMENSION_LIMIT and
                   track.height <= IMAGE_DIMENSION_LIMIT)
        elif typ == b"mdia":
            _parse_mdia(track, data, s.pos, s.pos + size)
        elif typ == b"edts":
            _check(not edts)
            edts = True
            _parse_edts(data, s.pos, s.pos + size)
        elif typ == b"tref":
            while b.has(1):
                rtyp, rsize = b.box_header()
                r = _Stream(data, b.pos, b.pos + rsize)
                if rtyp == b"auxl":
                    track.aux_for = r.u32()
                elif rtyp == b"prem":
                    r.u32()
                b.skip(rsize)
        s.skip(size)
    _check(tkhd)


def _parse_edts(data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    elst = False
    while s.has(1):
        typ, size = s.box_header()
        if typ == b"elst":
            _check(not elst)
            elst = True
            b = _Stream(data, s.pos, s.pos + size)
            version, flags = b.version_and_flags()
            if flags & 1:
                _check(b.u32() == 1)
                if version == 1:
                    duration = b.u64()
                elif version == 0:
                    duration = b.u32()
                else:
                    raise _Fail()
                _check(duration != 0)
        s.skip(size)
    _check(elst)


def _parse_mdia(track: _Track, data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    while s.has(1):
        typ, size = s.box_header()
        b = _Stream(data, s.pos, s.pos + size)
        if typ == b"mdhd":
            version, _flags = b.version_and_flags()
            if version == 1:
                b.u64(); b.u64()
                b.u32()  # timescale
                b.u64()
            elif version == 0:
                b.u32(); b.u32()
                b.u32()  # timescale
                b.u32()
            else:
                raise _Fail()
        elif typ == b"minf":
            m = _Stream(data, s.pos, s.pos + size)
            while m.has(1):
                mt, ms = m.box_header()
                if mt == b"stbl":
                    _parse_stbl(track, data, m.pos, m.pos + ms)
                m.skip(ms)
        elif typ == b"hdlr":
            _parse_hdlr(data, s.pos, s.pos + size, pict=False)
        s.skip(size)


def _parse_moov(data: bytes, start: int, end: int) -> list:
    tracks = []
    s = _Stream(data, start, end)
    while s.has(1):
        typ, size = s.box_header()
        if typ == b"trak":
            _parse_trak(data, s.pos, s.pos + size, tracks)
        s.skip(size)
    _check(tracks)
    return tracks


# ----------------------------------------------------------------------------
# the parse (avifDecoderParse)
# ----------------------------------------------------------------------------

class Parsed:
    """What `avifDecoderParse` leaves: the image size, and the items whose
    samples frame 0 decodes (none for tracks, whose sample reads the
    parse already bounded)."""

    def __init__(self):
        self.width = 0
        self.height = 0
        self.meta = None
        self.tiles = []


def _too_large(w: int, h: int) -> bool:
    return (w * h > IMAGE_SIZE_LIMIT or w > IMAGE_DIMENSION_LIMIT or
            h > IMAGE_DIMENSION_LIMIT)


def _top_level(data: bytes):
    """avifParse: (major brand, meta or None, tracks or None)."""
    n = len(data)
    offset = 0
    ftyp = meta = tracks = None
    needs_meta = needs_moov = False
    while True:
        if offset > n:
            raise _Fail(BMFF_PARSE_FAILED)
        head = data[offset:offset + 32]
        if not head:
            break
        s = _Stream(head)
        typ, size = s.box_header_partial(True)
        offset += s.pos
        is_ftyp, is_meta, is_moov = typ == b"ftyp", typ == b"meta", typ == b"moov"
        _check(ftyp is not None or is_ftyp)
        if is_ftyp or is_meta or is_moov:
            if size is None:
                size = n - offset
            elif offset + size > n:
                raise _Fail(TRUNCATED_DATA)
        elif size is None:
            raise _Fail(BMFF_PARSE_FAILED)
        body = (data, offset, offset + size)
        if is_ftyp:
            _check(ftyp is None)
            fs = _Stream(*body)
            major = fs.read(4)
            fs.u32()
            _check(fs.remaining() % 4 == 0)
            brands = [major] + [fs.read(4) for _ in range(fs.remaining() // 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Fail(INVALID_FTYP)
            ftyp = major
            needs_meta = b"avif" in brands
            needs_moov = b"avis" in brands
        elif is_meta:
            _check(meta is None)
            meta = _parse_meta(*body)
        elif is_moov:
            _check(tracks is None)
            tracks = _parse_moov(*body)
        if ftyp is not None and (not needs_meta or meta is not None) and (
                not needs_moov or tracks is not None):
            break
        offset += size
    if ftyp is None:
        raise _Fail(INVALID_FTYP)
    if (needs_meta and meta is None) or (needs_moov and tracks is None):
        raise _Fail(TRUNCATED_DATA)
    return ftyp, meta, tracks


def _validate_item(meta: _Meta, item: _Item):
    """avifDecoderItemValidateProperties under PIL's strict flags (no
    pixi or clap check)."""
    config = item.prop(b"av1C")
    _check(config is not None)
    if item.type == b"grid":
        for cell in meta.items.values():
            if cell.dimg_for != item.id:
                continue
            c = cell.prop(b"av1C")
            _check(c is not None and c == config)
    pixi = item.prop(b"pixi")
    if pixi is not None:
        depth = 12 if config[4] else (10 if config[3] else 8)
        for d in pixi:
            _check(d == depth)



def _parse(data: bytes) -> Parsed:
    major, meta, tracks = _top_level(data)
    out = Parsed()
    if meta is not None:
        # harvest ispe of the image items
        for item in meta.items.values():
            if item.skipped():
                continue
            ispe = item.prop(b"ispe")
            if ispe is not None:
                item.width, item.height = ispe
                _check(item.width and item.height)
                _check(not _too_large(item.width, item.height))
            else:
                aux = item.prop(b"auxC")
                _check(aux is not None and aux in ALPHA_URNS)
                _check(False)  # alpha without ispe: AVIF_STRICT_ALPHA_ISPE_REQUIRED
    if major == b"avis":
        source = "tracks"
    elif major == b"avif":
        source = "items"
    elif tracks:
        source = "tracks"
    else:
        source = "items"
    if source == "tracks":
        _reset_tracks(tracks or [], out, len(data))
    else:
        _reset_items(meta, data, out)
    return out


def _reset_items(meta: _Meta | None, data: bytes, out: Parsed):
    if meta is None or meta.primary == 0:
        raise _Fail(MISSING_IMAGE_ITEM)
    color = next((it for it in meta.items.values()
                  if not it.skipped() and it.id == meta.primary), None)
    if color is None:
        raise _Fail(MISSING_IMAGE_ITEM)
    alpha = None
    for item in meta.items.values():
        if item.skipped() or item.aux_for != color.id:
            continue
        aux = item.prop(b"auxC")
        if aux is not None and aux in ALPHA_URNS:
            alpha = item
            break
    _find_metadata(meta, data, color.id)
    tiles = []
    for item in (color, alpha):
        if item is None:
            continue
        if item.type == b"grid":
            cells = _read_grid(meta, item, data)
        else:
            cells = [item]
        for cell in cells:
            # avifCodecDecodeInputFillFromDecoderItem: the item's size
            # against the file's
            _check(cell.size <= len(data))
        tiles += cells
        _validate_item(meta, item)
    for cell in tiles:
        _check(cell.size != 0)  # every sample must have some data
    out.width, out.height = color.width, color.height
    cicp = _colr_properties(color.properties)
    if not cicp and tiles:
        _harvest_cicp(meta, tiles[0], data)
    out.meta = meta
    out.tiles = tiles


def _item_read(meta: _Meta, item: _Item, data: bytes, partial: int = 0) -> bytes:
    """avifDecoderItemRead: the first `partial` bytes (0: all) of the item."""
    if not item.extents:
        raise _Fail(TRUNCATED_DATA)
    if item.idat_stored and not meta.idat:
        raise _Fail(NO_CONTENT)
    if item.size > len(data):
        raise _Fail(TRUNCATED_DATA)
    if item.size == 0:
        raise _Fail(TRUNCATED_DATA)
    total = min(partial, item.size) if partial else item.size
    parts, remaining = [], total
    for off, length in item.extents:
        n = min(length, remaining)
        if item.idat_stored:
            _check(off <= len(meta.idat))
            _check(length <= len(meta.idat) - off)
            parts.append(meta.idat[off:off + n])
        else:
            _check(off <= len(data))
            got = data[off:off + n]
            if len(got) != n:
                raise _Fail(TRUNCATED_DATA)
            parts.append(got)
        remaining -= n
        if remaining == 0:
            break
    if remaining:
        raise _Fail(TRUNCATED_DATA)
    return b"".join(parts)


def _find_metadata(meta: _Meta, data: bytes, color_id: int):
    """avifDecoderFindMetadata: the Exif and XMP items describing the
    colour item are read; an Exif payload without its TIFF header fails."""
    for item in meta.items.values():
        if not item.size or item.unsupported_essential:
            continue
        if item.desc_for != color_id:
            continue
        if item.type == b"Exif":
            payload = _item_read(meta, item, data)
            _check(len(payload) >= 4, INVALID_EXIF_PAYLOAD)
            offset = struct.unpack(">I", payload[:4])[0]
            rest = payload[4:]
            found = next((k for k in range(max(0, len(rest) - 4))
                          if rest[k:k + 4] in (b"MM\0*", b"II*\0")), None)
            _check(found is not None and found == offset, INVALID_EXIF_PAYLOAD)
        elif item.type == b"mime" and item.content_type == b"application/rdf+xml":
            _item_read(meta, item, data)


def _harvest_cicp(meta: _Meta, tile: _Item, data: bytes):
    """avifDecoderReset without an nclx colr: the first tile's sequence
    header is read in chunks of 64 bytes (up to 4096) until it parses."""
    size = 0
    while True:
        size += 64
        size = min(size, tile.size)
        sample = _item_read(meta, tile, data, size)
        if not sample:
            break
        if _sequence_header_parses(sample):
            break
        if size == tile.size or size >= 4096:
            break


class _Bits:
    """libavif's avifBits: reads past the end set `error` and give 0."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.error = data, 0, False

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.pos >= 8 * len(self.data):
                self.error = True
                return 0
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def vlc(self) -> int:
        n = 0
        while not self.read(1):
            n += 1
            if n == 32:
                return 0xFFFFFFFF
        return ((1 << n) - 1) + self.read(n) if n else 0

    def uleb128(self) -> int:
        val, i = 0, 0
        while True:
            v = self.read(8)
            more = v & 0x80
            val |= (v & 0x7F) << i
            i += 7
            if not (more and i < 56):
                break
        if val > 0xFFFFFFFF or more:
            self.error = True
            return 0
        return val


def _sequence_header_parses(sample: bytes) -> bool:
    """avifSequenceHeaderParse: the first sequence header OBU parses."""
    obus = sample
    while obus:
        b = _Bits(obus)
        if b.read(1):
            return False
        obu_type = b.read(4)
        ext = b.read(1)
        has_size = b.read(1)
        b.read(1)
        if ext:
            b.read(8)
        if has_size:
            size = b.uleb128()
        else:
            size = len(obus) - 1 - ext
        if b.error:
            return False
        start = b.pos >> 3
        if size < 0 or size > len(obus) - start:
            return False
        if obu_type == 1:
            return _sequence_header_ok(_Bits(obus[start:start + size]))
        obus = obus[start + size:]
    return False


def _sequence_header_ok(b: _Bits) -> bool:
    profile = b.read(3)
    if profile > 2:
        return False
    still = b.read(1)
    reduced = b.read(1)
    if reduced and not still:
        return False
    if reduced:
        b.read(5)
    else:
        timing = b.read(1)
        model = 0
        delay_len = 0
        if timing:
            b.read(32)
            b.read(32)
            if b.read(1) and b.vlc() == 0xFFFFFFFF:
                return False
            model = b.read(1)
            if model:
                delay_len = b.read(5) + 1
                b.read(32)
                b.read(10)
        initial = b.read(1)
        for _ in range(b.read(5) + 1):
            b.read(12)
            if b.read(5) > 7:
                b.read(1)
            if model and b.read(1):
                b.read(delay_len)
                b.read(delay_len)
                b.read(1)
            if initial and b.read(1):
                b.read(4)
    if b.error:
        return False
    wbits = b.read(4) + 1
    hbits = b.read(4) + 1
    b.read(wbits)
    b.read(hbits)
    if not reduced and b.read(1):
        b.read(7)
    if b.error:
        return False
    b.read(3)
    if not reduced:
        b.read(4)
        order_hint = b.read(1)
        if order_hint:
            b.read(2)
        sct = 2 if b.read(1) else b.read(1)
        if sct > 0 and not b.read(1):
            b.read(1)
        if order_hint:
            b.read(3)
    b.read(3)
    if b.error:
        return False
    high = b.read(1)
    twelve = profile == 2 and high and b.read(1)
    mono = b.read(1) if profile != 1 else 0
    cp, tc, mc = 2, 2, 2
    if b.read(1):
        cp, tc, mc = b.read(8), b.read(8), b.read(8)
    if mono:
        b.read(1)
    elif cp == 1 and tc == 13 and mc == 0:
        pass
    else:
        b.read(1)
        ssx = ssy = 0
        if profile == 0:
            ssx = ssy = 1
        elif profile == 2:
            if twelve:
                ssx = b.read(1)
                ssy = b.read(1) if ssx else 0
            else:
                ssx, ssy = 1, 0
        if ssx and ssy:
            b.read(2)
    if not mono:
        b.read(1)
    b.read(1)
    return not b.error


def _read_grid(meta: _Meta, item: _Item, data: bytes):
    payload = _item_read(meta, item, data)
    s = _Stream(payload)
    try:
        _check(s.u8() == 0)
        flags = s.u8()
        rows = s.u8() + 1
        cols = s.u8() + 1
        if flags & 1:
            w, h = s.u32(), s.u32()
        else:
            w, h = s.u16(), s.u16()
        _check(w and h)
        _check(not _too_large(w, h))
        _check(s.remaining() == 0)
    except _Fail:
        raise _Fail(INVALID_IMAGE_GRID)
    cells = [c for c in meta.items.values() if c.dimg_for == item.id]
    for c in cells:
        if c.type != b"av01" or c.unsupported_essential:
            raise _Fail(INVALID_IMAGE_GRID)
    if len(cells) != rows * cols:
        raise _Fail(INVALID_IMAGE_GRID)
    if item.prop(b"av1C") is None and cells:
        first = min(cells, key=lambda c: c.dimg_idx)
        cfg = first.prop(b"av1C")
        if cfg is None:
            raise _Fail(INVALID_IMAGE_GRID)
        item.properties.append((b"av1C", cfg))
    return sorted(cells, key=lambda c: c.dimg_idx)


def _colr_properties(props) -> bool:
    """avifReadColorProperties: at most one colr of each kind; whether an
    nclx one sets the CICP."""
    icc = nclx = False
    for typ, val in props:
        if typ != b"colr" or val is None:
            continue
        if val[0] == "icc":
            _check(not icc)
            icc = True
        elif val[0] == "nclx":
            _check(not nclx)
            nclx = True
    return nclx


def _samples(track: _Track, size_hint: int) -> list:
    """avifCodecDecodeInputFillFromSampleTable: (offset, size) of each
    sample."""
    out = []
    index = 0
    for chunk, offset in enumerate(track.chunks):
        count = 0
        for first, per, _desc in reversed(track.sample_to_chunk):
            if first <= chunk + 1:
                count = per
                break
        _check(count != 0)
        for _ in range(count):
            size = track.sample_size_all
            if size == 0:
                _check(index < len(track.sample_sizes))
                size = track.sample_sizes[index]
            _check(offset + size <= size_hint)
            out.append((offset, size))
            offset += size
            index += 1
            _check(len(out) <= IMAGE_COUNT_LIMIT)
    return out


def _reset_tracks(tracks: list, out: Parsed, size_hint: int):
    def usable(t):
        return (t.has_stbl and t.id and t.chunks and
                any(f == b"av01" for f, _p in t.formats))

    color = next((t for t in tracks if usable(t) and not t.aux_for), None)
    if color is None:
        raise _Fail(NO_CONTENT)
    props = next(p for f, p in color.formats if f == b"av01")
    alpha = next((t for t in tracks if usable(t) and t.aux_for == color.id), None)
    for t in (color, alpha):
        if t is not None:
            for _off, size in _samples(t, size_hint):
                _check(size != 0)
    out.width, out.height = color.width, color.height
    _check(any(t == b"av1C" for t, _v in props))
    _colr_properties(props)


def parse_result(data: bytes) -> tuple:
    """(avifResult of the parse, Parsed or None)."""
    try:
        return OK, _parse(data)
    except _Fail as e:
        return e.code, None


def decode_avif(data: bytes):
    """PIL's `AvifImageFile._open` on `data`: `Refused` where PIL's walk
    goes on to the next plugin, `DecodeError` where PIL raises (the bake
    turns it white), NotImplementedError where PIL opens the file and
    decodes it with dav1d (AV1 decoding is not in the port)."""
    code, parsed = parse_result(data)
    if code in SYNTAX_ERRORS:
        raise Refused(f"AVIF: avifDecoderParse failed ({code})")
    if code != OK:
        raise DecodeError(f"AVIF: avifDecoderParse failed ({code})")
    check_pixels(parsed.width, parsed.height)
    # avifDecoderNthImage(0) reads each tile's whole sample before dav1d
    # decodes it: a payload past the end of the file fails there (PIL
    # raises in `load`)
    try:
        for tile in parsed.tiles:
            _item_read(parsed.meta, tile, data)
    except _Fail as e:
        raise DecodeError(f"AVIF: reading frame 0 failed ({e.code})") from e
    raise NotImplementedError("AVIF: AV1 decoding (dav1d's intra decode and "
                              "libavif's YUV -> RGB) is not ported "
                              "(ROADMAP.md section 1)")
