"""IPTC/NAA texture decoding, as PIL 12.1.0's `IptcImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

`_open` reads the records (`1c`, a record number PIL knows, a data set,
a length of two bytes or, above 128, of that many bytes less 128) up to
the first 8:10 record or the end, keeping each data set's bytes (a
repeated one as a list). Record 3:60 gives the mode (one layer without a
component: `L`; 3 or 4 layers with one: `RGB` or `CMYK`, the band 3:65
names), 3:20 and 3:30 the size, 3:120 the compression (1 raw, 5 JPEG; any
other, or none, is PIL's OSError: white). Each lookup fails as PIL's
does: a missing record or one of the wrong kind is a refusal.

The load gathers the 8:10 records' bytes, behind a `P5` header when raw,
and opens them as an image of their own (`ppm.py`, `jpeg.py`; another
format raises NotImplementedError). An `L` image is that image; an `RGB`
or `CMYK` one merges it, which must be `L`, into its band beside zeros,
at the inner image's size.
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, candidates, check_pixels, opening
from .jpeg import decode_jpeg, read_header
from .ppm import decode_ppm
from .raster import DecodeError, Stream

COMPRESSION = {1: "raw", 5: "jpeg"}


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp: Stream):
    """IptcImageFile.field: (tag, size), or (None, 0) at zeros or the end;
    a length above 132 is PIL's OSError."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise DecodeError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(fp.read(size - 128))
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _open(fp: Stream):
    info = {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers = info[(3, 60)][0]
    component = info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    try:
        compression = COMPRESSION[_i(info[(3, 120)])]
    except KeyError as e:
        raise DecodeError("Unknown IPTC image compression") from e
    tile = offset if tag == (8, 10) else None
    return mode, band, size, compression, tile


def _inner(data: bytes, raw: bool):
    """Image.open of the gathered bytes, loaded: (mode, RGBA). Raw data is
    the `P5` PPM of an `L` image; JPEG data is tried in PIL's order."""
    if raw:
        return "L", decode_ppm(data)
    for fmt in candidates(data):
        if fmt != "JPEG":
            raise NotImplementedError(
                f"IPTC holding {fmt}: not ported (ROADMAP.md section 1)")
        try:
            with opening("JPEG"):
                mode = read_header(data)[0]
            return mode, decode_jpeg(data)
        except Refused:
            continue
    raise DecodeError("IPTC: cannot identify the image data")


def decode_iptc(data: bytes) -> np.ndarray:
    """IPTC bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("IPTC"):
        mode, band, (w, h), compression, tile = _open(fp)
    if not mode or w <= 0 or h <= 0:
        raise Refused("IPTC: no mode or size (ImageFile refuses it)")
    check_pixels(w, h)
    if tile is None:
        raise DecodeError("IPTC: cannot load this image")
    fp.seek(tile)
    out = [b"P5\n%d %d\n255\n" % (w, h)] if compression == "raw" else []
    try:
        while True:
            tag, size = _field(fp)
            if tag != (8, 10):
                break
            out.append(fp.read(size))
    except (SyntaxError, IndexError, struct.error) as e:
        raise DecodeError(f"IPTC record: {e!r}") from e
    inner_mode, rgba = _inner(b"".join(out), compression == "raw")
    if band is None:
        return rgba
    if inner_mode != "L":
        raise DecodeError("IPTC: a band that is not L (mode mismatch)")
    bands = [np.zeros(rgba.shape[:2], np.uint8)] * len(mode)
    if not -len(bands) <= band < len(bands):
        raise DecodeError("IPTC: band index out of range")
    bands[band] = rgba[..., 0]
    px = np.stack(bands, -1)
    return raster.to_rgba(mode, px)
