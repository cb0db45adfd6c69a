"""PBM / PGM / PPM / PFM texture decoding, as PIL 12.1.0's `PpmImagePlugin`
reads them (`Image.open(f).convert("RGBA")`, byte for byte).

The header is read as PIL reads it: a magic of up to 6 bytes (P1-P6, Pf,
and PIL's P0CMYK, PyP, PyRGBA and PyCMYK), then whitespace-separated
tokens of at most 10 bytes, `#` comments running to the end of their line.
A bad token, maxval or scale is PIL's ValueError (white). The binary
formats are PIL's `raw` rows (P4 inverted bits, P5 / P6 bytes, a P5 of
maxval 65535 big-endian 16-bit as mode I, Pf 32-bit floats bottom-up in
the byte order of its scale's sign); any other maxval goes through PIL's
`PpmDecoder`, which scales each sample to 0..255 (0..65535 for a P5 of
maxval above 255, which becomes mode I and is then clipped at 255, not
scaled, by `convert`). The plain formats (P1-P3) go through
`PpmPlainDecoder`, block by block as PIL reads them, with its comment
handling. Rounding is Python's `round`, half to even.
"""
from __future__ import annotations

import math
import re

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

WHITESPACE = b" \t\n\x0b\x0c\r"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1024 * 1024
_DIGITS = re.compile(rb"[0-9\s]*")


def _read_magic(fp: Stream) -> bytes:
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in WHITESPACE:
            break
        magic += c
    return magic


def _read_token(fp: Stream) -> bytes:
    token = b""
    while len(token) <= 10:
        c = fp.read(1)
        if not c:
            break
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while fp.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise DecodeError("Reached EOF while reading header")
    if len(token) > 10:
        raise DecodeError("Token too long in file header")
    return token


def decode_ppm(data: bytes) -> np.ndarray:
    """PPM-family bytes -> (H, W, 4) uint8 RGBA, as PIL's
    `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("PPM"):
        magic = _read_magic(fp)
        if magic not in MODES:
            raise SyntaxError("not a PPM file")
        mode = image_mode = MODES[magic]
    try:
        w, h = int(_read_token(fp)), int(_read_token(fp))
    except ValueError as e:
        raise DecodeError(f"PPM: {e}") from e
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = None
    if mode == "1":
        rawmode = "1;I"
    elif mode == "F":
        try:
            scale = float(_read_token(fp))
        except ValueError as e:
            raise DecodeError(f"PPM: {e}") from e
        if scale == 0.0 or not math.isfinite(scale):
            raise DecodeError("scale must be finite and non-zero")
        rawmode = "F;32F" if scale < 0 else "F;32BF"
    else:
        try:
            maxval = int(_read_token(fp))
        except ValueError as e:
            raise DecodeError(f"PPM: {e}") from e
        if not 0 < maxval < 65536:
            raise DecodeError("maxval must be greater than 0 and less than "
                              "65536")
        if maxval > 255 and mode == "L":
            image_mode = "I"
        rawmode = mode
        if not plain:
            if maxval == 65535 and mode == "L":
                rawmode = "I;16B"
            elif maxval != 255:
                plain = None            # PIL's "ppm" decoder
    offset = fp.tell()
    if w <= 0 or h <= 0:
        raise Refused("PPM: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    if plain:
        px = _plain(data, offset, image_mode, w, h, maxval)
    elif plain is None:
        px = _scaled(data, offset, image_mode, w, h, maxval)
    elif mode == "F":
        px = raster.raw_decode(data, offset, "F", rawmode, w, h, 0, -1)
    elif rawmode == "I;16B":
        px = raster.raw_decode(data, offset, "I;16B", "I;16B", w, h)
        image_mode = "I;16B"
    else:
        px = raster.raw_decode(data, offset, mode, rawmode, w, h)
    if image_mode == "P":
        return raster.to_rgba("P", px, raster.palette("RGB", b""))
    return raster.to_rgba(image_mode, px)


def _as_mode(values: np.ndarray, mode: str, w: int, h: int) -> np.ndarray:
    """set_as_raw: the first w h bands values as pixels of `mode` (fewer
    is PIL's "not enough image data")."""
    n = w * h * BANDS[mode]
    if values.size < n:
        raise DecodeError("not enough image data")
    v = values[:n]
    if mode == "I":
        return v.astype(np.int32).reshape(h, w)
    v = v.astype(np.uint8)
    return v.reshape((h, w) if BANDS[mode] == 1 else (h, w, BANDS[mode]))


def _scaled(data, offset, mode, w, h, maxval):
    """PpmDecoder: whole pixels of 1- or 2-byte big-endian samples until
    the image is full or the data ends; each round(v / maxval * top),
    clipped at top (65535 for mode I, else 255)."""
    bands = BANDS[mode]
    size = 1 if maxval < 256 else 2
    top = 65535 if mode == "I" else 255
    n = min(w * h, max(0, len(data) - offset) // (size * bands))
    raw = np.frombuffer(data, np.uint8, n * size * bands, offset)
    v = raw if size == 1 else raw.view(">u2")
    v = np.minimum(top, np.round(v.astype(np.float64) / maxval * top))
    return _as_mode(v, mode, w, h)


def _comment_end(block: bytes, start: int = 0) -> int:
    a = block.find(b"\n", start)
    b = block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Plain:
    """PpmPlainDecoder over the bytes from the tile's offset."""

    def __init__(self, data: bytes, offset: int):
        self.fp = Stream(data, offset)
        self.spans = False

    def block(self) -> bytes:
        return self.fp.read(SAFEBLOCK)

    def strip_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> np.ndarray:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.strip_comments(block).split())
            if tokens.strip(b"01"):
                raise DecodeError("Invalid token for this mode")
            data = (data + tokens)[:total]
        return np.frombuffer(data, np.uint8)

    def values(self, total: int, maxval: int, top: int) -> np.ndarray:
        out, count = [], 0
        half = b""
        while count != total:
            block = self.block()
            if not block:
                if half:
                    block = b" "
                else:
                    break
            block = self.strip_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise DecodeError("Token too long found in data")
            tokens = tokens[:total - count]
            if any(len(t) > 10 for t in tokens):
                raise DecodeError("Token too long found in data")
            if _DIGITS.fullmatch(b" ".join(tokens)):
                v = np.array(tokens or [b"0"], np.bytes_).astype(np.int64)
                v = v[:len(tokens)]
            else:
                try:
                    v = np.array([int(t) for t in tokens], np.int64)
                except ValueError as e:
                    raise DecodeError(f"PPM: {e}") from e
            if (v < 0).any() or (v > maxval).any():
                raise DecodeError("Channel value out of range for this mode")
            out.append(np.round(v.astype(np.float64) / maxval * top))
            count += len(tokens)
        return np.concatenate(out) if out else np.zeros(0)


def _plain(data, offset, mode, w, h, maxval):
    dec = _Plain(data, offset)
    if mode == "1":
        bits = dec.bitonal(w * h)
        if bits.size < w * h:
            raise DecodeError("not enough image data")
        return np.where(bits.reshape(h, w) == ord("0"), 255, 0).astype(
            np.uint8)
    top = 65535 if mode == "I" else 255
    return _as_mode(dec.values(w * h * BANDS[mode], maxval, top), mode, w, h)
