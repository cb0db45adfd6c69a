"""AVIF: the port's open of an AVIF file against PIL 12.1.0's (libavif
1.3.0's parse), on the CPU.

PIL's `AvifImagePlugin._open` runs libavif's `avifDecoderParse`; a file
that passes it is decoded by dav1d, which the port does not model
(`scene/avif.py` raises NotImplementedError for it). So the cases here
hold every file's outcome in the bake to PIL's: a file PIL opens raises
NotImplementedError naming AVIF, a file whose parse PIL refuses passes on
to the next plugin (white when none takes it), a parse error PIL raises
bakes white. The files are PIL's own (RGB, RGBA, L, each subsampling,
qualities, speeds, tiles, sequences) and files built from PIL's payloads
by the helpers below (grids, alpha items, `idat`, every `iloc` / `ipma`
version, `clap`, `irot` / `imir`, thumbnails, essential properties);
the seeded sweeps cut and flip PIL's files and set the container's
fields, and count each outcome. The parse result itself is held to the
wheel's libavif (`avifDecoderParse` through ctypes, with the strict flags
PIL's decoder uses).
"""
import collections
import ctypes
import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import avif, identify, textures
from test_torch_bmp import port_rgba, sweep_outcome

# PIL registers its plugins in a fixed order (identify.FORMATS mirrors
# `Image.ID`); load them all before this file imports the AVIF plugin
Image.init()

# ----------------------------------------------------------------------------
# building AVIF files from PIL's payloads
# ----------------------------------------------------------------------------


def box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


def boxes(data: bytes, start: int = 0, end: int | None = None):
    """(type, payload start, payload end) of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    while start + 8 <= end:
        size, typ = struct.unpack(">I4s", data[start:start + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", data[start + 8:start + 16])[0]
            head = 16
        if size == 0:
            size = end - start
        yield typ, start + head, start + size
        start += size


def picture(h, w, c, seed=0):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                     ((x + y) * 3) % 256, 255 - (x * y) % 256], -1)[..., :c]
    noise = rs.randint(-24, 25, size=(h, w, c))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def pil_avif(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "AVIF", **kw)
    return buf.getvalue()


def pil_sequence(frames, **kw) -> bytes:
    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "AVIF", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def items_of(data: bytes) -> dict:
    """The items of a file PIL wrote: {id: dict(type, payload, props)},
    props being the raw property boxes in ipma order, and the primary."""
    meta = [(s, e) for t, s, e in boxes(data) if t == b"meta"][0]
    out, props, assoc, locs, primary = {}, [], {}, {}, 0
    for t, s, e in boxes(data, meta[0] + 4, meta[1]):
        if t == b"pitm":
            primary = struct.unpack(">H", data[s + 4:s + 6])[0]
        elif t == b"iloc":
            n = struct.unpack(">H", data[s + 6:s + 8])[0]
            p = s + 8
            for _ in range(n):
                iid, _ref, count = struct.unpack(">HHH", data[p:p + 6])
                p += 6
                ext = []
                for _ in range(count):
                    ext.append(struct.unpack(">II", data[p:p + 8]))
                    p += 8
                locs[iid] = ext
        elif t == b"iinf":
            for _t, s2, _e2 in boxes(data, s + 6, e):
                iid = struct.unpack(">H", data[s2 + 4:s2 + 6])[0]
                out[iid] = dict(type=data[s2 + 8:s2 + 12])
        elif t == b"iprp":
            for t2, s2, e2 in boxes(data, s, e):
                if t2 == b"ipco":
                    props = [data[a - 8:b] for _t3, a, b in boxes(data, s2, e2)]
                elif t2 == b"ipma":
                    n = struct.unpack(">I", data[s2 + 4:s2 + 8])[0]
                    p = s2 + 8
                    for _ in range(n):
                        iid, k = struct.unpack(">HB", data[p:p + 3])
                        p += 3
                        assoc[iid] = [data[p + i] & 0x7F for i in range(k)]
                        p += k
    for iid, item in out.items():
        item["payload"] = b"".join(data[o:o + n] for o, n in locs[iid])
        item["props"] = [props[i - 1] for i in assoc.get(iid, [])]
    return dict(items=out, primary=primary)


def build(items, primary, refs=(), brands=(b"avif", b"avif", b"mif1", b"miaf"),
          iloc_version=0, ipma_version=0, ipma_flags=0, idat=(), essential=(),
          pitm=True):
    """An AVIF file: `items` [(id, type, payload, [property boxes])],
    `refs` [(type, from, [to])], the ids in `idat` stored in an idat box
    (construction method 1, iloc version 1 or 2), the (id, property index
    in the item's list) pairs in `essential` marked essential."""
    ftyp = box(b"ftyp", brands[0] + b"\0\0\0\0" + b"".join(brands[1:]))
    hdlr = full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0")
    ipco, assoc = [], []
    for iid, _t, _p, props in items:
        idx = []
        for k, pb in enumerate(props):
            ipco.append(pb)
            e = 0x8000 if (iid, k) in essential else 0
            idx.append(len(ipco) | (e if ipma_flags & 1 else e >> 8))
        assoc.append((iid, idx))
    ipma = b""
    for iid, idx in assoc:
        ipma += (struct.pack(">H", iid) if ipma_version == 0 else
                 struct.pack(">I", iid)) + bytes([len(idx)])
        for v in idx:
            ipma += struct.pack(">H", v) if ipma_flags & 1 else bytes([v])
    iprp = box(b"iprp", box(b"ipco", b"".join(ipco)) +
               full(b"ipma", ipma_version, ipma_flags,
                    struct.pack(">I", len(assoc)) + ipma))
    iinf = full(b"iinf", 0, 0, struct.pack(">H", len(items)) + b"".join(
        full(b"infe", 2, 0, struct.pack(">HH", iid, 0) + typ + b"\0")
        for iid, typ, _p, _pr in items))
    iref = b""
    if refs:
        iref = full(b"iref", 0, 0, b"".join(
            box(t, struct.pack(">HH", f, len(to)) +
                b"".join(struct.pack(">H", x) for x in to))
            for t, f, to in refs))
    idat_data = b"".join(p for iid, _t, p, _pr in items if iid in idat)

    def iloc(mdat_start):
        out = struct.pack(">BB", 0x44, 0x00)
        out += (struct.pack(">H", len(items)) if iloc_version < 2 else
                struct.pack(">I", len(items)))
        pos, ipos = mdat_start, 0
        for iid, _t, p, _pr in items:
            out += (struct.pack(">H", iid) if iloc_version < 2 else
                    struct.pack(">I", iid))
            if iloc_version:
                out += struct.pack(">H", 1 if iid in idat else 0)
            out += struct.pack(">HH", 0, 1)
            if iid in idat:
                out += struct.pack(">II", ipos, len(p))
                ipos += len(p)
            else:
                out += struct.pack(">II", pos, len(p))
                pos += len(p)
        return full(b"iloc", iloc_version, 0, out)

    def meta(mdat_start):
        body = hdlr
        if pitm:
            body += full(b"pitm", 0, 0, struct.pack(">H", primary))
        body += iloc(mdat_start) + iinf + iref + iprp
        if idat_data:
            body += box(b"idat", idat_data)
        return full(b"meta", 0, 0, body)

    head = ftyp + meta(0)
    head = ftyp + meta(len(head) + 8)
    mdat = box(b"mdat", b"".join(p for iid, _t, p, _pr in items
                                 if iid not in idat))
    return head + mdat


def prop_box(props, typ: bytes) -> bytes:
    return [p for p in props if p[4:8] == typ][0]


def without(props, typ: bytes):
    return [p for p in props if p[4:8] != typ]


def ispe(w, h) -> bytes:
    return full(b"ispe", 0, 0, struct.pack(">II", w, h))


ALPHA_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"


# ----------------------------------------------------------------------------
# PIL and the wheel's libavif
# ----------------------------------------------------------------------------

def pil_open_outcome(data: bytes) -> str:
    """PIL's AVIF plugin alone: "refused" (`Image.open` tries the next
    plugin), "white" (it raises), "pixels"."""
    from PIL import AvifImagePlugin

    try:
        im = AvifImagePlugin.AvifImageFile(io.BytesIO(data))
    except identify.OPEN_ERRORS:
        return "refused"
    except Exception:
        return "white"
    try:
        Image._decompression_bomb_check(im.size)
        im.convert("RGBA")
    except Exception:
        return "white"
    return "pixels"


def port_open_outcome(data: bytes) -> str:
    try:
        avif.decode_avif(data)
    except identify.Refused:
        return "refused"
    except NotImplementedError:
        return "pixels"
    except Exception:
        return "white"
    raise AssertionError("decode_avif returned")


_LIB = None
PIL_STRICT_FLAGS = 4  # of AVIF_STRICT_ENABLED, AVIF_STRICT_ALPHA_ISPE_REQUIRED


def libavif_parse(data: bytes, flags: int = PIL_STRICT_FLAGS,
                  frame0: bool = False):
    """The wheel's `avifDecoderParse` result (strictFlags at offset 40 of
    libavif 1.3.0's avifDecoder); with `frame0`, (that result, the result
    of `avifDecoderNthImage(0)` after a parse that passes, else None)."""
    global _LIB
    if _LIB is None:
        import PIL

        libdir = os.path.join(os.path.dirname(PIL.__file__), "..",
                              "pillow.libs")
        _LIB = ctypes.CDLL(glob.glob(libdir + "/libavif-*.so*")[0])
        _LIB.avifDecoderCreate.restype = ctypes.c_void_p
        _LIB.avifDecoderDestroy.argtypes = [ctypes.c_void_p]
        _LIB.avifDecoderSetIOMemory.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p,
                                                ctypes.c_size_t]
        _LIB.avifDecoderParse.argtypes = [ctypes.c_void_p]
        _LIB.avifDecoderNthImage.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        _LIB.avifVersion.restype = ctypes.c_char_p
        assert _LIB.avifVersion() == b"1.3.0"
    d = _LIB.avifDecoderCreate()
    try:
        ctypes.c_uint32.from_address(d + 40).value = flags
        buf = ctypes.create_string_buffer(data, len(data))
        _LIB.avifDecoderSetIOMemory(d, buf, len(data))
        code = _LIB.avifDecoderParse(d)
        if not frame0:
            return code
        return code, (_LIB.avifDecoderNthImage(d, 0) if code == 0 else None)
    finally:
        _LIB.avifDecoderDestroy(d)


# ----------------------------------------------------------------------------
# the files
# ----------------------------------------------------------------------------

def _rgb(h=24, w=40, seed=0):
    return picture(h, w, 3, seed)


def _rgba(h=24, w=40, seed=0):
    return picture(h, w, 4, seed)


# PIL's writer: each mode, subsampling, range, quality, speed, lossless,
# tiles, premultiplied alpha, aom's options (screen content, palette,
# intrabc, film grain, denoising, quantizer matrices, restoration, aq and
# delta q modes), odd sizes, sequences
PIL_WRITES = {
    "rgb": lambda: pil_avif(_rgb()),
    "rgba": lambda: pil_avif(_rgba()),
    "l": lambda: pil_avif(_rgb(), "L"),
    "s420": lambda: pil_avif(_rgb(), subsampling="4:2:0"),
    "s422": lambda: pil_avif(_rgb(), subsampling="4:2:2"),
    "s444": lambda: pil_avif(_rgb(), subsampling="4:4:4"),
    "s400": lambda: pil_avif(_rgb(), subsampling="4:0:0"),
    "limited": lambda: pil_avif(_rgb(), range="limited"),
    "q10": lambda: pil_avif(_rgb(), quality=10),
    "q100": lambda: pil_avif(_rgb(), quality=100),
    "speed0": lambda: pil_avif(_rgb(16, 16), speed=0),
    "speed10": lambda: pil_avif(_rgb(), speed=10),
    "lossless": lambda: pil_avif(_rgb(), advanced={"lossless": "1"}),
    "tiles": lambda: pil_avif(_rgba(160, 192), tile_rows=1, tile_cols=1),
    "autotiling": lambda: pil_avif(_rgb(160, 192), autotiling=True),
    "premultiplied": lambda: pil_avif(_rgba(), alpha_premultiplied=True),
    "screen": lambda: pil_avif(_rgb(), advanced={"tune-content": "screen"}),
    "palette": lambda: pil_avif(_rgb(), advanced={"enable-palette": "1"}),
    "intrabc": lambda: pil_avif(_rgb(), advanced={"enable-intrabc": "1"}),
    "grain": lambda: pil_avif(_rgb(), advanced={"film-grain-test": "1"}),
    "denoise": lambda: pil_avif(_rgb(),
                                advanced={"denoise-noise-level": "25"}),
    "qm": lambda: pil_avif(_rgb(), advanced={"enable-qm": "1", "qm-min": "4",
                                             "qm-max": "8"}),
    "restoration": lambda: pil_avif(_rgb(),
                                    advanced={"enable-restoration": "1"}),
    "deltaq": lambda: pil_avif(_rgb(), advanced={"aq-mode": "1",
                                                 "deltaq-mode": "3"}),
    "1x1": lambda: pil_avif(_rgb(1, 1)),
    "1x9": lambda: pil_avif(_rgb(1, 9)),
    "9x1": lambda: pil_avif(_rgb(9, 1)),
    "17x33": lambda: pil_avif(_rgb(17, 33)),
    "65x129": lambda: pil_avif(_rgba(65, 129)),
    "sequence": lambda: pil_sequence([_rgb(16, 16, k) for k in range(3)]),
    "sequence_alpha": lambda: pil_sequence([_rgba(16, 16, k)
                                            for k in range(3)]),
}


@pytest.mark.parametrize("name", sorted(PIL_WRITES))
def test_pil_files_open_and_stay_unported(name):
    """Every file PIL writes passes libavif's parse and PIL decodes it; the
    port's parse passes it too, and the bake raises NotImplementedError
    naming AVIF (AV1 decoding is not ported) instead of any pixels."""
    data = PIL_WRITES[name]()
    assert libavif_parse(data) == avif.OK
    assert avif.parse_result(data)[0] == avif.OK
    assert pil_open_outcome(data) == "pixels"
    assert identify.identify(data) == "AVIF"
    with pytest.raises(NotImplementedError, match="AVIF.*ROADMAP"):
        port_rgba(data)


def _parts():
    """Items and property boxes from PIL's files: an RGBA still (colour 1,
    alpha 2), four 64 x 64 grid cells and four 16 x 16 ones, each set of
    the same settings."""
    rgba = items_of(pil_avif(_rgba()))["items"]
    cells = [items_of(pil_avif(_rgb(64, 64, k), quality=50, speed=10))
             ["items"][1] for k in range(4)]
    small = [items_of(pil_avif(_rgb(16, 16, k), quality=50))["items"][1]
             for k in range(4)]
    return rgba, cells, small


def _listed(items):
    return [(k, v["type"], v["payload"], v["props"]) for k, v in items.items()]


def _built():
    """name -> (file, PIL's outcome) for the structures PIL cannot write."""
    rgba, cells, small = _parts()
    color, alpha = rgba[1], rgba[2]
    aux = [(b"auxl", 2, [1])]
    grid = bytes([0, 0, 1, 1]) + struct.pack(">HH", 120, 100)
    cell_items = [(2 + k, b"av01", c["payload"], c["props"])
                  for k, c in enumerate(cells)]
    grid_props = [ispe(120, 100), prop_box(cells[0]["props"], b"pixi"),
                  prop_box(cells[0]["props"], b"colr")]
    small_grid = bytes([0, 0, 1, 1]) + struct.pack(">HH", 30, 28)
    small_items = [(2 + k, b"av01", c["payload"], c["props"])
                   for k, c in enumerate(small)]
    clap = box(b"clap", struct.pack(">8I", 20, 1, 12, 1, 0, 1, 0, 1))
    bad_clap = box(b"clap", struct.pack(">8I", 20, 1, 12, 1, 11, 1, 0, 1))
    irot, imir = box(b"irot", b"\x01"), box(b"imir", b"\x01")
    unknown = box(b"zzzz", b"abc")
    exif = b"\0\0\0\0MM\0*\0\0\0\x08\0\0"
    xmp_infe = (9, b"mime", b"<x:xmpmeta/>", [])
    c1 = (1, b"av01", color["payload"], color["props"])
    a2 = (2, b"av01", alpha["payload"], alpha["props"])
    pixi5 = full(b"pixi", 0, 0, bytes([5]) + b"\x08" * 5)
    pixi10 = full(b"pixi", 0, 0, b"\x03\x0a\x0a\x0a")
    nclx = prop_box(color["props"], b"colr")
    out = {
        "grid": build([(1, b"grid", grid, grid_props)] + cell_items, 1,
                      refs=[(b"dimg", 1, [2, 3, 4, 5])]),
        "grid_no_colr": build([(1, b"grid", grid, grid_props[:2])] +
                              cell_items, 1,
                              refs=[(b"dimg", 1, [2, 3, 4, 5])]),
        "grid_small_cells": build([(1, b"grid", small_grid,
                                    [ispe(30, 28)] + grid_props[1:])] +
                                  small_items, 1,
                                  refs=[(b"dimg", 1, [2, 3, 4, 5])]),
        "grid_3_cells": build([(1, b"grid", grid, grid_props)] +
                              cell_items[:3], 1,
                              refs=[(b"dimg", 1, [2, 3, 4])]),
        "grid_bad_version": build([(1, b"grid", b"\x01" + grid[1:],
                                    grid_props)] + cell_items, 1,
                                  refs=[(b"dimg", 1, [2, 3, 4, 5])]),
        "alpha": build([c1, a2], 1, refs=aux),
        "premultiplied": build([c1, a2], 1, refs=aux + [(b"prem", 1, [2])]),
        "alpha_no_ispe": build([c1, (2, b"av01", alpha["payload"],
                                     without(alpha["props"], b"ispe"))],
                               1, refs=aux),
        "idat": build([c1], 1, iloc_version=1, idat=(1,)),
        "iloc_v2_ipma_v1": build([c1, a2], 1, refs=aux, iloc_version=2,
                                 ipma_version=1, ipma_flags=1),
        "transforms": build([(1, b"av01", color["payload"],
                              color["props"] + [clap, irot, imir])], 1,
                            essential={(1, 4), (1, 5), (1, 6)}),
        "clap_not_essential": build([(1, b"av01", color["payload"],
                                      color["props"] + [clap])], 1),
        "clap_out_of_bounds": build([(1, b"av01", color["payload"],
                                      color["props"] + [bad_clap])], 1,
                                    essential={(1, 4)}),
        "unknown_property": build([(1, b"av01", color["payload"],
                                    color["props"] + [unknown])], 1),
        "unknown_essential": build([(1, b"av01", color["payload"],
                                     color["props"] + [unknown])], 1,
                                   essential={(1, 4)}),
        "thumbnail": build([c1, (7, b"av01", cells[0]["payload"],
                                 cells[0]["props"])], 1,
                           refs=[(b"thmb", 7, [1])]),
        "exif": build([c1, (9, b"Exif", exif, [])], 1,
                      refs=[(b"cdsc", 9, [1])]),
        "exif_no_tiff_header": build([c1, (9, b"Exif", b"\0\0\0\0abcdefgh",
                                           [])], 1,
                                     refs=[(b"cdsc", 9, [1])]),
        "no_pitm": build([c1], 1, pitm=False),
        "no_pixi": build([(1, b"av01", color["payload"],
                           without(color["props"], b"pixi"))], 1),
        "pixi_5_planes": build([(1, b"av01", color["payload"],
                                 without(color["props"], b"pixi") + [pixi5])],
                               1),
        "pixi_depth_10": build([(1, b"av01", color["payload"],
                                 without(color["props"], b"pixi") +
                                 [pixi10])], 1),
        "two_nclx": build([(1, b"av01", color["payload"],
                            color["props"] + [nclx])], 1),
        "no_av1c": build([(1, b"av01", color["payload"],
                           without(color["props"], b"av1C"))], 1),
        "ftyp_mif1_only": build([c1], 1, brands=(b"mif1", b"mif1", b"miaf")),
        "avis_without_moov": build([c1], 1, brands=(b"avis", b"avis",
                                                     b"msf1")),
    }
    return out


BUILT = _built()
# PIL's outcome of each built file (PIL 12.1.0 over libavif 1.3.0) and the
# port's: "pixels" is NotImplementedError for the port, which it also
# raises where libavif's parse passes and the decode then fails (a grid of
# cells smaller than 64 x 64: "Invalid image grid")
BUILT_OUTCOMES = {
    "alpha": ("pixels", "pixels"), "alpha_no_ispe": ("refused", "refused"),
    "avis_without_moov": ("refused", "refused"),
    "clap_not_essential": ("refused", "refused"),
    "clap_out_of_bounds": ("pixels", "pixels"), "exif": ("pixels", "pixels"),
    "exif_no_tiff_header": ("white", "white"),
    "ftyp_mif1_only": ("refused", "refused"), "grid": ("pixels", "pixels"),
    "grid_3_cells": ("white", "white"), "grid_bad_version": ("white", "white"),
    "grid_no_colr": ("pixels", "pixels"),
    "grid_small_cells": ("white", "pixels"), "idat": ("pixels", "pixels"),
    "iloc_v2_ipma_v1": ("pixels", "pixels"), "no_av1c": ("refused", "refused"),
    "no_pitm": ("white", "white"), "no_pixi": ("pixels", "pixels"),
    "pixi_5_planes": ("white", "white"),
    "pixi_depth_10": ("refused", "refused"),
    "premultiplied": ("pixels", "pixels"), "thumbnail": ("pixels", "pixels"),
    "transforms": ("pixels", "pixels"), "two_nclx": ("refused", "refused"),
    "unknown_essential": ("white", "white"),
    "unknown_property": ("pixels", "pixels"),
}


@pytest.mark.parametrize("name", sorted(BUILT))
def test_built_files_open_as_pil_does(name):
    """The files PIL cannot write: the port's parse gives libavif's result,
    and its outcome is PIL's ("pixels" being NotImplementedError)."""
    data = BUILT[name]
    assert avif.parse_result(data)[0] == libavif_parse(data)
    pil, port = BUILT_OUTCOMES[name]
    assert pil_open_outcome(data) == pil
    assert port_open_outcome(data) == port


def _mutations(data: bytes, n: int, seed: int):
    """Seeded cut-and-flip variants of `data`: cuts, bit flips and bytes
    set to 0, 1, 2, 255 or a random value (the header's first 700 bytes)."""
    rs = np.random.RandomState(seed)
    for k in range(n):
        d = bytearray(data)
        mode = k % 3
        if mode == 0:
            d = d[:rs.randint(0, len(d))]
        else:
            for _ in range(rs.randint(1, 3)):
                i = rs.randint(0, min(len(d), 700))
                if mode == 1:
                    d[i] ^= 1 << rs.randint(0, 8)
                else:
                    d[i] = rs.choice([0, 1, 2, 255, rs.randint(0, 256)])
        yield bytes(d)


SWEEPS = {
    "rgb420": lambda: pil_avif(_rgb(32, 48), subsampling="4:2:0"),
    "rgba444_tiles": lambda: pil_avif(_rgba(160, 192), subsampling="4:4:4",
                                      tile_rows=1, tile_cols=1, speed=10),
    "avis": lambda: pil_sequence([_rgba(16, 16, k) for k in range(3)]),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep(name):
    """300 seeded cut-and-flip variants through the bake's decode: no
    pixels other than PIL's, no exception escapes, the parse result is
    libavif's on every file, and NotImplementedError comes exactly where
    libavif's parse passes (PIL then decodes with dav1d, or fails in it)."""
    counts = collections.Counter()
    for data in _mutations(SWEEPS[name](), 300, 7):
        code, _p = avif.parse_result(data)
        want, frame0 = libavif_parse(data, frame0=True)
        assert code == want
        outcome = sweep_outcome(data)
        if identify.identify(data) == "AVIF":
            # the port is white after a passing parse exactly where libavif
            # fails to read frame 0's samples
            read_fails = frame0 in (avif.TRUNCATED_DATA,
                                    avif.BMFF_PARSE_FAILED, avif.NO_CONTENT)
            assert (outcome == "unported") == (code == avif.OK and
                                              not read_fails), (code, frame0)
        counts[outcome] += 1
    # NotImplementedError only for the files PIL decodes or fails in dav1d
    # (113-132 of 300 when written; PIL's bytes could only come from
    # another plugin taking bytes the AVIF plugin refuses)
    assert counts["pixels"] + counts["white"] + counts["unported"] == 300
    assert counts["unported"] <= 150 and counts["white"] >= 100, counts


@pytest.mark.parametrize("seed", range(3))
def test_container_field_sweep(seed):
    """Each byte of the ftyp, iloc, ipma, ispe, pixi, av1C and colr boxes of
    a still (seeds 0, 1) and of an RGBA still (seed 2) set to 0, 1, 0x80,
    0xFF and its value + 1: the parse gives libavif's result, the bake
    PIL's outcome or NotImplementedError where the parse passes."""
    data = pil_avif(_rgba(24, 40, seed) if seed == 2 else _rgb(24, 40, seed),
                    quality=50 + 10 * seed)
    spans = []
    meta = [(s, e) for t, s, e in boxes(data) if t == b"meta"][0]
    for t, s, e in boxes(data):
        if t == b"ftyp":
            spans.append((s - 8, e))
    for t, s, e in boxes(data, meta[0] + 4, meta[1]):
        if t == b"iloc":
            spans.append((s - 8, e))
        if t == b"iprp":
            for t2, s2, e2 in boxes(data, s, e):
                if t2 == b"ipma":
                    spans.append((s2 - 8, e2))
                for t3, s3, e3 in boxes(data, s2, e2):
                    if t3 in (b"ispe", b"pixi", b"av1C", b"colr"):
                        spans.append((s3 - 8, e3))
    counts = collections.Counter()
    for a, b in spans:
        for i in range(a, b):
            for v in (0, 1, 0x80, 0xFF, (data[i] + 1) & 0xFF):
                if v == data[i]:
                    continue
                d = data[:i] + bytes([v]) + data[i + 1:]
                code, _p = avif.parse_result(d)
                assert code == libavif_parse(d), (i, v)
                counts[sweep_outcome(d)] += 1
    assert counts["white"] and counts["unported"], counts


def test_parse_fuzz_of_built_structures():
    """Mutations of the grid, idat, iloc / ipma version, transform,
    thumbnail and Exif files: the port's parse result is libavif's."""
    for k, name in enumerate(("grid", "idat", "iloc_v2_ipma_v1",
                              "transforms", "thumbnail", "exif")):
        for data in _mutations(BUILT[name], 120, 100 + k):
            assert avif.parse_result(data)[0] == libavif_parse(data), name


def test_bake_of_failing_avif_matches_jax():
    """AVIFs PIL refuses or fails to open bake white in both packages (the
    JAX bake catches PIL's error), slot for slot."""
    import base64

    from kajiya_tpu.scene import textures as tex_j

    names = [n for n, (_pil, port) in sorted(BUILT_OUTCOMES.items())
             if port != "pixels"]
    uris = ["data:application/octet-stream;base64," +
            base64.b64encode(BUILT[n]).decode() for n in names]
    atlas_t, sub_t = textures.bake_texture_pages(uris)
    atlas_j, sub_j = tex_j.build_texture_pages(uris)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


def test_fixtures_manifest():
    """tests/data/avif/ (tools/make_avif_fixtures.py): each file's libavif
    parse result, PIL's outcome and the bake's ("unported" or "white",
    which chip_smoke.py's avif_phase holds on the card's host) are the
    manifest's, and the directory stays small."""
    import json

    root = os.path.join(os.path.dirname(__file__), "data", "avif")
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest) >= 25
    total = 0
    for name, want in manifest.items():
        path = os.path.join(root, name)
        with open(path, "rb") as f:
            data = f.read()
        total += len(data)
        assert len(data) == want["bytes"], name
        assert avif.parse_result(data)[0] == want["parse"], name
        assert libavif_parse(data) == want["parse"], name
        assert pil_open_outcome(data) == want["pil"], name
        if want.get("unported"):
            with pytest.raises(NotImplementedError, match="AVIF"):
                textures._decode_image(path)
        else:
            assert want.get("white")
            with pytest.raises((OSError, ValueError)):
                textures._decode_image(path)
    assert total < 256 * 1024
