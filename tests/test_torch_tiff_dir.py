"""Port parity: libtiff 4.7.1's directory reader (`scene/tiff_dir.py`), held
to the libtiff of PIL 12.1.0's wheel itself through ctypes, and the TIFFs
whose directories it recovers or converts held to PIL.

- The directory oracle: every entry of four small seeds and of
  `tests/data/tiff/bigtiff.tif` retyped to every type (0 to 18), its count
  set to 0, 2, 3, n - 1, n + 1 and 2^32 - 1; and each entry left out,
  repeated, swapped with the next, set to another SHORT or LONG value
  before, after or in place of itself, and absent tags added. Where
  libtiff's `TIFFOpen(path, "rC")` (PIL's mode) succeeds, the port's fields
  equal `TIFFGetField`'s (`TIFFGetFieldDefaulted` where libtiff has a
  default): the size, BitsPerSample, SamplesPerPixel, Compression,
  Photometric, PlanarConfig, FillOrder, Predictor, SampleFormat,
  RowsPerStrip or the tile size, the number of strips or tiles, their
  offsets and byte counts, ExtraSamples, YCbCrSubSampling and whether a
  Colormap was kept; where it fails, the port raises `TiffError`. No
  mutant raises NotImplementedError.
- The TIFF-directory city's maps at 256^2 (`assets.write_city_assets(...,
  formats="tiffdir")`), each equal to PIL's RGBA and to its texels, each a
  file the directory reader of c20954c raised NotImplementedError on (the
  rule it broke is stated).
- Repeated tags that PIL and libtiff keep different copies of: PIL's mode
  with libtiff's strips; and the checks of PIL's TiffDecode.c between the
  two views (a strip's unpacker row must be libtiff's scanline; a tile's
  may be longer, reading into the next rows).
- `tiff.write_tiff`'s defaults give the bytes c20954c's writer gave.

Tolerance: exact everywhere."""
import ctypes
import glob
import hashlib
import os
import struct

import numpy as np
import PIL
import PIL._imaging  # noqa: F401  (loads the wheel's libraries first)
import pytest

from kajiya_tpu_torch.scene import assets, tiff
from kajiya_tpu_torch.scene.tiff_dir import TiffError, read_directory
from test_torch_bmp import pil_rgba, port_rgba
from test_torch_tiff import (_bigtiff_seed, _entries, _entry_seeds,
                             _retyped)

_PREDICTED = (5, 8, 32946, 34925, 50000)
_lib = None


def _libtiff() -> ctypes.CDLL:
    """The wheel's libtiff, its error and warning handlers silenced."""
    global _lib
    if _lib is None:
        libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                            "pillow.libs")
        path = glob.glob(os.path.join(libs, "libtiff-*.so*"))[0]
        lib = ctypes.CDLL(path)
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        for name in ("TIFFClose", "TIFFIsTiled", "TIFFNumberOfStrips",
                     "TIFFNumberOfTiles"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.TIFFNumberOfStrips.restype = ctypes.c_uint32
        lib.TIFFNumberOfTiles.restype = ctypes.c_uint32
        lib.TIFFSetErrorHandler.restype = ctypes.c_void_p
        lib.TIFFSetWarningHandler.restype = ctypes.c_void_p
        lib.TIFFSetErrorHandler(None)
        lib.TIFFSetWarningHandler(None)
        _lib = lib
    return _lib


def libtiff_fields(data: bytes, path: str):
    """libtiff's fields of the file's first directory, or None where
    TIFFOpen fails."""
    lib = _libtiff()
    with open(path, "wb") as f:
        f.write(data)
    tif = lib.TIFFOpen(path.encode(), b"rC")
    if not tif:
        return None
    tif = ctypes.c_void_p(tif)
    u16, u32 = ctypes.c_uint16, ctypes.c_uint32

    def get(tag, *values, defaulted=False):
        fn = lib.TIFFGetFieldDefaulted if defaulted else lib.TIFFGetField
        return fn(tif, ctypes.c_uint32(tag),
                  *[ctypes.byref(v) for v in values])

    def scalar(tag, ctype, defaulted=False):
        v = ctype()
        return v.value if get(tag, v, defaulted=defaulted) else None

    out = dict(width=scalar(256, u32), length=scalar(257, u32),
               bps=scalar(258, u16, True), spp=scalar(277, u16, True),
               compression=scalar(259, u16), photometric=scalar(262, u16),
               planar=scalar(284, u16, True), fillorder=scalar(266, u16, True),
               sampleformat=scalar(339, u16, True),
               rps=scalar(278, u32, True),
               tiled=bool(lib.TIFFIsTiled(tif)))
    if out["tiled"]:
        out.update(tw=scalar(322, u32), th=scalar(323, u32))
    if out["compression"] in _PREDICTED:
        v = scalar(317, u16)
        out["predictor"] = 1 if v is None else v
    n = (lib.TIFFNumberOfTiles if out["tiled"] else
         lib.TIFFNumberOfStrips)(tif)
    out["nstrips"] = n
    for tag, name in ((273, "offsets"), (279, "counts")):
        p = ctypes.POINTER(ctypes.c_uint64)()
        out[name] = tuple(p[i] for i in range(n)) if get(tag, p) and p \
            else None
    count, info = u16(), ctypes.POINTER(ctypes.c_uint16)()
    get(338, count, info, defaulted=True)
    out["extra"] = tuple(info[i] for i in range(count.value))
    hs, vs = u16(), u16()
    get(530, hs, vs, defaulted=True)
    out["subsampling"] = (hs.value, vs.value)
    maps = [ctypes.POINTER(ctypes.c_uint16)() for _ in range(3)]
    out["colormap"] = bool(get(320, *maps))
    lib.TIFFClose(tif)
    return out


def port_fields(data: bytes):
    """The port's fields of the same directory, or None where it raises
    TiffError."""
    bo = ">" if data[:2] == b"MM" else "<"
    big = struct.unpack_from(bo + "H", data, 2)[0] == 43
    offset = struct.unpack_from(bo + ("Q" if big else "L"), data,
                                8 if big else 4)[0]
    try:
        d = read_directory(data, offset)
    except TiffError:
        return None
    out = dict(width=d.width, length=d.length, bps=d.bps, spp=d.spp,
               compression=d.compression, photometric=d.photometric,
               planar=d.planar, fillorder=d.fillorder,
               sampleformat=d.sampleformat, rps=d.rps, tiled=d.tiled)
    if d.tiled:
        out.update(tw=d.tw, th=d.th)
    if d.compression in _PREDICTED:
        out["predictor"] = d.predictor
    out.update(nstrips=d.nstrips, offsets=d.offsets, counts=d.counts,
               extra=d.extra, subsampling=d.subsampling,
               colormap=d.colormap)
    return out


SEEDS = {**_entry_seeds(), "bigtiff": _bigtiff_seed}


def _entry_mutants(base: bytes):
    yield "base", base
    for _pos, tag, typ, count in _entries(base)[1]:
        for t in range(19):
            if t != typ:
                yield f"{tag} type {t}", _retyped(base, tag, typ=t)
        for c in sorted({0, 2, 3, count - 1, count + 1, 2 ** 32 - 1}
                        - {count}):
            if c >= 0:
                yield f"{tag} count {c}", _retyped(base, tag, count=c)


def rebuilt(data: bytes, edit) -> bytes:
    """The file with its first directory rewritten at its end from
    `edit([(tag, type, count, value field)], byte order, bigtiff)`."""
    bo = "<" if data[:2] == b"II" else ">"
    big = struct.unpack_from(bo + "H", data, 2)[0] == 43
    fmt = bo + ("HHQ8s" if big else "HHI4s")
    at = struct.unpack_from(bo + ("Q" if big else "I"), data,
                            8 if big else 4)[0]
    n = struct.unpack_from(bo + ("Q" if big else "H"), data, at)[0]
    size = struct.calcsize(fmt)
    first = at + (8 if big else 2)
    entries = [struct.unpack_from(fmt, data, first + size * k)
               for k in range(n)]
    entries = edit(entries, bo, big)
    out = bytearray(data) + b"\0" * (len(data) % 2)
    where = len(out)
    out += struct.pack(bo + ("Q" if big else "H"), len(entries))
    for e in entries:
        out += struct.pack(fmt, *e)
    out += b"\0" * (8 if big else 4)
    struct.pack_into(bo + ("Q" if big else "I"), out, 8 if big else 4, where)
    return bytes(out)


def field(bo, big, typ, v) -> bytes:
    """A value field holding one SHORT or LONG."""
    return struct.pack(bo + {3: "H", 4: "I"}[typ], v).ljust(8 if big else 4,
                                                            b"\0")


def _family_mutants(base: bytes):
    entries = _entries(base)[1]
    for k, (_pos, tag, _typ, _count) in enumerate(entries):
        yield f"omit {tag}", rebuilt(base, lambda es, bo, big:
                                     es[:k] + es[k + 1:])
        yield f"repeat {tag}", rebuilt(base, lambda es, bo, big:
                                       es[:k + 1] + es[k:])
        if k + 1 < len(entries):
            yield f"swap {tag}", rebuilt(base, lambda es, bo, big: es[:k] + [
                es[k + 1], es[k]] + es[k + 2:])
        for v in (0, 1, 2, 3, 4, 8, 16, 999, 65535):
            for typ in (3, 4):
                for where in ("set", "before", "after"):
                    def edit(es, bo, big):
                        new = (tag, typ, 1, field(bo, big, typ, v))
                        if where == "set":
                            return es[:k] + [new] + es[k + 1:]
                        cut = k if where == "before" else k + 1
                        return es[:cut] + [new] + es[cut:]
                    yield f"{where} {tag} {typ} {v}", rebuilt(base, edit)
    present = {tag for _p, tag, _t, _c in entries}
    for tag in (262, 266, 277, 278, 280, 281, 284, 317, 320, 322, 323, 338,
                339, 530, 32995, 32996, 32997, 32998):
        if tag in present:
            continue
        for v in (0, 1, 2, 3, 4, 8):
            yield f"add {tag} {v}", rebuilt(base, lambda es, bo, big: sorted(
                es + [(tag, 3, 1, field(bo, big, 3, v))]))


def _assert_directories(mutants, path):
    opened = failed = 0
    for what, data in mutants:
        want = libtiff_fields(data, path)
        got = port_fields(data)
        assert got == want, (what, got, want)
        opened += want is not None
        failed += want is None
    return opened, failed


@pytest.mark.parametrize("seed", list(SEEDS))
def test_entry_mutants_match_libtiff(seed, tmp_path):
    """Every entry retyped and recounted: libtiff's fields, or TiffError
    where libtiff fails."""
    opened, failed = _assert_directories(_entry_mutants(SEEDS[seed]()),
                                         str(tmp_path / "t.tif"))
    assert opened > 30 and failed > 30


@pytest.mark.parametrize("seed", list(SEEDS))
def test_directory_edits_match_libtiff(seed, tmp_path):
    """Entries left out, repeated (libtiff keeps the first), out of order,
    set to other values, and tags added: libtiff's fields, or TiffError
    where libtiff fails."""
    opened, failed = _assert_directories(_family_mutants(SEEDS[seed]()),
                                         str(tmp_path / "t.tif"))
    assert opened > 300 and failed > 30


# ----------------------------------------------------------------------------
# the TIFF-directory city
# ----------------------------------------------------------------------------

def _c20954c_rule(data: bytes):
    """The rule on which c20954c's directory reader (`tiff._Dir`) raised
    NotImplementedError for a file PIL decodes, or None: it read its tags
    only as SHORT or LONG, required StripByteCounts, and took ExtraSamples
    only as SHORT."""
    types = {tag: typ for _p, tag, typ, _n in _entries(data)[1]}
    for tag in (256, 257, 277, 258, 259, 262, 284, 266, 317, 339, 278, 273,
                279):
        if tag in types and types[tag] not in (3, 4):
            return f"tag {tag} of type {types[tag]}"
    if 279 not in types:
        return "a directory without tag 279"
    if types.get(338, 3) != 3:
        return "an ExtraSamples tag of another type"
    return None


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcitytiffdir"))
    written = assets.write_city_assets(root, map_size=256, emissive_size=128,
                                       ground_size=(8, 16), formats="tiffdir")
    return root, written


@pytest.mark.parametrize("kind, rule", [
    ("base", "a directory without tag 279"),
    ("normal", "tag 256 of type 8"),
    ("mr", "tag 277 of type 9"),
    ("emissive", "an ExtraSamples tag of another type")])
def test_city_maps_as_pil(city, kind, rule):
    """Each map of the city (base colours: one LZW strip without
    StripByteCounts, which libtiff estimates; normals: deflate strips with
    differencing, SSHORT sizes and RowsPerStrip, SLONG StripOffsets;
    metallic-roughness: PackBits with SLONG Compression and
    SamplesPerPixel; emissive: deflate RGBA with a LONG ExtraSamples)
    decodes to PIL's RGBA and its texels; c20954c's reader raised on each,
    by the rule stated."""
    root, written = city
    names = [n for n in written if n.split("_")[1].startswith(kind)]
    assert names
    for name in names:
        with open(os.path.join(root, "meshes", name), "rb") as f:
            data = f.read()
        want = written[name][1]
        np.testing.assert_array_equal(pil_rgba(data), want, err_msg=name)
        np.testing.assert_array_equal(port_rgba(data), want, err_msg=name)
        assert _c20954c_rule(data) == rule, name


# ----------------------------------------------------------------------------
# repeated tags: PIL's copy and libtiff's
# ----------------------------------------------------------------------------

def _short(bo, big, v):
    return field(bo, big, 3, v)


def _insert(base, before_tag, new_entries):
    """The file with entries inserted before the first entry of
    `before_tag` (new_entries(bo, big) -> entries)."""
    def edit(es, bo, big):
        k = next(i for i, e in enumerate(es) if e[0] == before_tag)
        return es[:k] + new_entries(bo, big) + es[k:]
    return rebuilt(base, edit)


def test_repeated_strip_arrays_keep_libtiffs_first():
    """StripOffsets and StripByteCounts repeated after the originals with
    copies that point at other bytes: PIL's view keeps the last copy,
    libtiff (which decodes the strips) the first, so the pixels are the
    file's."""
    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (12, 9, 3)).astype(np.uint8)
    base = tiff.write_tiff(img, compression=5, rows_per_strip=4)

    def edit(es, bo, big):
        out = []
        for e in es:
            out.append(e)
            if e[0] == 273:         # three offsets read from the data
                out.append((273, 4, 3, struct.pack(bo + "I", 8)))
            if e[0] == 279:
                out.append((279, 3, 1, _short(bo, big, 2)))
        return out
    data = rebuilt(base, edit)
    want = np.concatenate([img, np.full((12, 9, 1), 255, np.uint8)], -1)
    np.testing.assert_array_equal(pil_rgba(data), want)
    np.testing.assert_array_equal(port_rgba(data), want)


def _la_base() -> bytes:
    from test_torch_tiff import _pil_tiff
    return _pil_tiff("LA", 2, compression="packbits")


def cut_view(bps: int, spp: int):
    """An LA PackBits file whose later copies of BitsPerSample and
    SamplesPerPixel, then an entry whose data lies past the file's end,
    stand before ExtraSamples: PIL stops reading its directory there (so
    it sees those copies and no ExtraSamples), libtiff keeps the first
    copies and reads on."""
    return _insert(_la_base(), 338, lambda bo, big: [
        (258, 3, 1, _short(bo, big, bps)), (277, 3, 1, _short(bo, big, spp)),
        (700, 1, 100000, struct.pack(bo + "I", 10))])


def test_pil_mode_with_libtiffs_strips():
    """PIL reads the mode I;16 (one 16-bit sample), libtiff the LA strips
    (two 8-bit samples): the rows are the same size, and PIL unpacks
    libtiff's strips as I;16; the port gives PIL's bytes."""
    data = cut_view(16, 1)
    want = pil_rgba(data)
    assert want is not None
    np.testing.assert_array_equal(port_rgba(data), want)


def test_strip_row_of_another_size_is_white():
    """PIL reads L (one byte a pixel), libtiff LA (two): TiffDecode.c's
    strip loop fails where its unpacker's row is not libtiff's scanline,
    so PIL raises and both bakes turn the file white."""
    data = cut_view(8, 1)
    assert pil_rgba(data) is None
    with pytest.raises(TiffError):
        tiff.decode_tiff(data)


def test_tile_rows_longer_than_libtiffs():
    """A tiled file whose BitsPerSample PIL reads as 16 and libtiff as 8:
    PIL's unpacker reads each tile row twice as long as libtiff's, into
    the rows after it; the last row of a full tile reads past the tile
    buffer, which the port does not model (NotImplementedError), while the
    file's last row of tiles, 2 rows of 16, reads inside it."""
    with open(os.path.join(os.path.dirname(__file__), "data", "tiff",
                           "tiled.tif"), "rb") as f:
        base = f.read()

    def edit(es, bo, big):
        k = [e[0] for e in es].index(258)
        return es[:k] + [(258, 3, 1, _short(bo, big, 8)),
                         (258, 3, 1, _short(bo, big, 16))] + es[k + 1:]
    data = rebuilt(base, edit)
    assert pil_rgba(data) is not None
    with pytest.raises(NotImplementedError, match="tile buffer"):
        tiff.decode_tiff(data)


# ----------------------------------------------------------------------------
# the writer
# ----------------------------------------------------------------------------

# SHA-256 of c20954c's write_tiff output for each case (its defaults)
_WRITER_C20954C = {
    "strips-lzw-pred":
        "ec5beda82b6528a9e2846e7e993fa6ff8477d3398ac2399bef9175df69ca30ea",
    "tiles-deflate-be":
        "61a99d3ef80475836656c81f2c81e9381c06cf458e014018c8290749096d93ed",
    "planar-packbits-16":
        "f8a8496190c1db347408ccf34df05f8a264167f19d909368a5f9ef26b05a41a5",
    "raw-orientation":
        "8a67eaf2ec32d1347ea59f7c0b5e1696af1e611c9192a15dcab19b0848a3fa71",
    "g4-bilevel":
        "41b3db827b1e06de3599baadf1062a7a7d75b791c5f21b99c384f023b40dd229",
    "g3-t4":
        "b1ce723338740afc27960329340421645858048b4ce8dafc001ff5726cd6f286"}


@pytest.mark.parametrize("case", list(_WRITER_C20954C))
def test_writer_defaults_unchanged(case):
    """`write_tiff` without `tag_types`, `omit` or `extra_samples` writes
    the bytes c20954c's writer wrote."""
    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    bilevel = (img[..., 0] > 127).astype(np.uint8)
    data = {
        "strips-lzw-pred": lambda: tiff.write_tiff(
            img, compression=5, predictor=2, rows_per_strip=8),
        "tiles-deflate-be": lambda: tiff.write_tiff(
            img, compression=8, tile=(16, 16), order=">"),
        "planar-packbits-16": lambda: tiff.write_tiff(
            img.astype(np.uint16) * 257, compression=32773, planar=2),
        "raw-orientation": lambda: tiff.write_tiff(img, orientation=6),
        "g4-bilevel": lambda: tiff.write_tiff(
            bilevel, photometric=0, compression=4, bits=1, fillorder=2),
        "g3-t4": lambda: tiff.write_tiff(
            bilevel, photometric=0, compression=3, bits=1, t4options=1)}[
        case]()
    assert hashlib.sha256(data).hexdigest() == _WRITER_C20954C[case]


@pytest.mark.parametrize("order", ["<", ">"])
def test_writer_tag_types_and_omit(order):
    """`tag_types` stores the tags in the types asked (LONG8 out of line),
    `omit` leaves tags out, and both decode as PIL does."""
    rng = np.random.default_rng(29)
    img = rng.integers(0, 256, (10, 6, 3)).astype(np.uint8)
    types = {256: 8, 257: 9, 259: 4, 262: 8, 273: 16, 277: 9, 278: 6}
    data = tiff.write_tiff(img, compression=5, rows_per_strip=10,
                           order=order, tag_types=types, omit=(279, 284))
    got = {tag: typ for _p, tag, typ, _n in _entries(data)[1]}
    assert {t: got[t] for t in types} == types
    assert 279 not in got and 284 not in got
    want = np.concatenate([img, np.full((10, 6, 1), 255, np.uint8)], -1)
    np.testing.assert_array_equal(pil_rgba(data), want)
    np.testing.assert_array_equal(port_rgba(data), want)


# ----------------------------------------------------------------------------
# the YCbCr tags as libtiff converts them
# ----------------------------------------------------------------------------

def _with_array(base: bytes, tag: int, typ: int, vals) -> bytes:
    """`base` (little-endian) with `tag` added: `vals` of type `typ` stored
    after the file's end."""
    code = {3: "H", 5: "I", 11: "f"}[typ]
    count = len(vals) // 2 if typ == 5 else len(vals)
    data = bytearray(rebuilt(base, lambda es, bo, big: sorted(
        es + [(tag, typ, count, bytes(4))])))
    for pos, t, _typ, _n in _entries(bytes(data))[1]:
        if t == tag:
            struct.pack_into("<I", data, pos + 8, len(data))
    return bytes(data) + struct.pack(f"<{len(vals)}{code}", *vals)


@pytest.mark.parametrize("tag, typ, vals", [
    (529, 5, (299, 0, 587, 1000, 114, 1000)),
    (529, 11, (0.25, 0.5, 0.25)),
    (532, 3, (0, 255, 128, 255, 128, 255)),
    (532, 5, (16, 1, 235, 1, 128, 1, 240, 0, 128, 1, 240, 1))])
def test_ycbcr_tags_as_libtiff(tag, typ, vals):
    """YCbCrCoefficients and ReferenceBlackWhite of another type, or a
    rational of denominator 0 (libtiff reads it as 0): LZW YCbCr through
    libtiff's RGBA reader gives PIL's bytes."""
    rng = np.random.default_rng(tag + typ)
    img = rng.integers(0, 256, (8, 10, 3)).astype(np.uint8)
    data = _with_array(tiff.write_tiff(img, compression=5, photometric=6),
                       tag, typ, vals)
    want = pil_rgba(data)
    assert want is not None
    np.testing.assert_array_equal(port_rgba(data), want)
