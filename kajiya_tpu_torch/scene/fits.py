"""FITS texture decoding, as PIL 12.1.0's `FitsImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

The 80-byte cards are read as PIL reads them: the first must be `SIMPLE =
T`; an `END` card closes a header unit (the file position rounds up to
2880) and names the image of the first unit whose `NAXIS` is not 0
(`NAXIS` 1 is one column); the first card after a closed unit that is no
`XTENSION` starts the data, which PIL takes from that card's position (a
data unit shorter than 80 bytes moves it back into the header). `BITPIX`
8 is `L`, 16 `I;16`, 32 `I`, -32 and -64 `F` (any other leaves no mode:
a refusal), read bottom-up through the little-endian or native raw mode
of that name: big-endian 16-bit values come out byte-swapped and floats
near 0, and -64 reads half the data as float32 words. A `BINTABLE` with
`ZIMAGE = T` and `ZCMPTYPE = 'GZIP_1  '` is PIL's `FitsGzipDecoder`: the
bytes after the table, gunzipped, the last 1, 2 or 4 bytes of each 4-byte
word (`ZBITPIX` 8, 16, 32; a float `ZBITPIX` gives none, which PIL
refuses), rows in reverse order.

A card value `int` cannot read raises ValueError (PIL's too: white); a
missing key is PIL's KeyError, which `ImageFile` takes as a refusal.
"""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def _get_size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse_headers(headers: dict):
    """(decoder, offset, size, mode, bits) of FitsImageFile._parse_headers;
    decoder "" where the unit holds no image."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        no_prefix_size = _get_size(headers, prefix) or (0, 0)
        bits = int(headers[b"BITPIX"])
        offset = no_prefix_size[0] * no_prefix_size[1] * (bits // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _get_size(headers, prefix)
    if not size:
        return "", 0, None, "", 0
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, size, _MODES.get(bits, ""), bits


def decode_fits(data: bytes) -> np.ndarray:
    """FITS bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    headers: dict = {}
    in_progress, decoder = False, ""
    with opening("FITS"):
        while True:
            card = fp.read(80)
            if not card:
                raise DecodeError("Truncated FITS file")
            keyword = card[:8].strip()
            if keyword in (b"SIMPLE", b"XTENSION"):
                in_progress = True
            elif headers and not in_progress:
                break
            elif keyword == b"END":
                fp.seek(math.ceil(fp.tell() / 2880) * 2880)
                if not decoder:
                    decoder, offset, size, mode, bits = _parse_headers(
                        headers)
                in_progress = False
                continue
            if decoder:
                continue
            value = card[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not keyword.startswith(b"SIMPLE")
                                or value != b"T"):
                raise SyntaxError("Not a FITS file")
            headers[keyword] = value
        if not decoder:
            raise DecodeError("No image data")
    offset += fp.tell() - 80
    w, h = size
    if not mode or w <= 0 or h <= 0:
        raise Refused("FITS: no mode or size (ImageFile refuses it)")
    check_pixels(w, h)
    if offset < 0:
        raise DecodeError("FITS: negative seek value")
    if decoder == "raw":
        return raster.to_rgba(mode, raster.raw_decode(data, offset, mode,
                                                      mode, w, h, ystep=-1))
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:    # BadGzipFile is OSError
        raise DecodeError(f"FITS GZIP_1: {e}") from e
    nb = min(bits // 8, 4)
    if nb <= 0 or len(value) < 4 * w * h:
        raise DecodeError("FITS GZIP_1: not enough image data")
    words = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
    rows = np.ascontiguousarray(words[::-1, :, 4 - nb:]).reshape(h, -1)
    return raster.to_rgba(mode, raster.unpack(rows, mode, mode, w))


def _card(key: str, value) -> bytes:
    if isinstance(value, bool):
        value = "T" if value else "F"
    elif isinstance(value, str) and key not in ("END",):
        value = f"'{value:<8}'"
    text = f"{key:<8}= {value:>20}" if key != "END" else "END"
    return text.ljust(80).encode("ascii")


def _unit(cards) -> bytes:
    head = b"".join(_card(k, v) for k, v in cards) + _card("END", None)
    return head + b" " * (-len(head) % 2880)


def encode_fits(img: np.ndarray, bitpix: int = 8) -> bytes:
    """(H, W) -> a FITS primary image of BITPIX `bitpix` (8: uint8, 16:
    int16, 32: int32, -32: float32, -64: float64), rows bottom-up as PIL
    reads them, big-endian, the data unit padded to 2880 bytes."""
    h, w = img.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    body = np.ascontiguousarray(img[::-1]).astype(dt).tobytes()
    head = _unit([("SIMPLE", True), ("BITPIX", bitpix), ("NAXIS", 2),
                  ("NAXIS1", w), ("NAXIS2", h)])
    return head + body + b"\0" * (-len(body) % 2880)
