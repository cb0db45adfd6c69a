"""XPM texture decoding, as PIL 12.1.0's `XpmImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

After the `/* XPM */` magic, the first line that starts with the quoted
`"w h colours bpp` values; a value that is no number is PIL's ValueError
(white). Each colour line's key is its `bpp` characters after the quote;
its first `c` entry is `#rrggbb` (read by `int(..., 16)`), or `None`,
which makes the key PIL's "transparency" (other names and a line with no
`c` are PIL's ValueError: white). Up to 256 colour lines give mode `P`
(the palette in the order of the distinct keys), more give `RGB`. The
decoder then reads lines (skipping one `/* pixels */`), joins what lies
between each line's first and last quote, and looks up every `bpp`
characters until the image's bytes are there: an unknown key is white,
too few pixels PIL's "not enough image data" (white). A `P` image's
transparency is a byte string, so `convert("RGBA")` sets the alpha of
the first palette entries to the key's character codes, as PIL does; an
`RGB` image's cannot be converted (white).
"""
from __future__ import annotations

import re

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
# the writer's key characters
KEY_CHARS = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+-"


def _readline(fp: Stream) -> bytes:
    end = fp.data.find(b"\n", fp.pos)
    return fp.read(-1 if end < 0 else end + 1 - fp.pos)


def decode_xpm(data: bytes) -> np.ndarray:
    """XPM bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("XPM"):
        if not fp.read(9).startswith(b"/* XPM */"):
            raise SyntaxError("not an XPM file")
        while True:
            line = _readline(fp)
            if not line:
                raise SyntaxError("broken XPM file")
            m = _HEAD.match(line)
            if m:
                break
        try:
            w, h, colours, bpp = (int(g) for g in m.groups())
        except ValueError as e:
            raise DecodeError(f"XPM header: {e}") from e
        palette, transparency = {}, None
        for _ in range(colours):
            line = _readline(fp).rstrip()
            c = line[1:bpp + 1]
            s = line[bpp + 1:-2].split()
            for i in range(0, len(s), 2):
                if s[i] == b"c":
                    rgb = s[i + 1]
                    if rgb == b"None":
                        transparency = c
                    elif rgb.startswith(b"#"):
                        try:
                            v = int(rgb[1:], 16)
                        except ValueError as e:
                            raise DecodeError(f"XPM colour: {e}") from e
                        palette[c] = bytes([v >> 16 & 255, v >> 8 & 255,
                                            v & 255])
                    else:
                        raise DecodeError("cannot read this XPM file")
                    break
            else:
                raise DecodeError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise Refused("XPM: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    mode = "RGB" if colours > 256 else "P"
    keys = list(palette)
    index = {k: i for i, k in enumerate(keys)}
    values = [palette[k] for k in keys] if mode == "RGB" else \
        [bytes([i]) for i in range(len(keys))]
    table = np.frombuffer(b"".join(values), np.uint8).reshape(len(keys), -1)
    lut = None
    if bpp in (1, 2):
        # every key of `bpp` characters by its code: the lines' lookups in
        # numpy (a line whose length is no multiple of `bpp` takes the loop)
        lut = np.full(256 ** bpp, -1, np.int32)
        for k, i in index.items():
            if len(k) == bpp:
                lut[int.from_bytes(k, "big")] = i
    need = w * h * (3 if mode == "RGB" else 1)
    out, n, pixel_header = [], 0, False
    while n < need:
        line = _readline(fp)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        if bpp == 0:
            raise DecodeError("XPM: range() arg 3 must not be zero")
        if lut is not None and len(line) % bpp == 0:
            v = np.frombuffer(line, np.uint8).astype(np.int32)
            code = v if bpp == 1 else v[0::2] << 8 | v[1::2]
            i = lut[code]
            if (i < 0).any():
                raise DecodeError("XPM: unknown pixel key")
            out.append(table[i].tobytes())
            n += i.size * table.shape[1]
            continue
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if key not in index:
                raise DecodeError(f"XPM: unknown pixel key {key!r}")
            out.append(values[index[key]])
            n += len(values[0])
    raw = b"".join(out)
    if len(raw) < need:
        raise DecodeError("XPM: not enough image data")
    px = raster.raw_decode(raw, 0, mode, mode, w, h)
    if mode == "RGB":
        if transparency is not None:
            raise DecodeError("XPM: RGB transparency must be a colour tuple")
        return raster.to_rgba("RGB", px)
    pal = raster.palette("RGB", b"".join(palette.values()))
    if transparency is not None:
        # putpalettealphas: the key's bytes become the first entries' alpha
        if len(transparency) > 256:
            raise DecodeError("XPM: invalid palette alpha size")
        t = np.frombuffer(transparency, np.uint8)
        pal[:len(t), 3] = t
    return raster.to_rgba("P", px, pal)


def encode_xpm(idx: np.ndarray, colours: np.ndarray, bpp: int = 1) -> bytes:
    """(H, W) indices into `colours` ((N, 3) uint8) -> an XPM whose keys are
    `bpp` characters of `KEY_CHARS` each."""
    base = len(KEY_CHARS)
    digits = np.arange(len(colours))[:, None] // base ** np.arange(bpp) % base
    keys = np.frombuffer(KEY_CHARS, np.uint8)[digits]          # (N, bpp)
    h, w = idx.shape
    head = [b"/* XPM */", b"static char *image[] = {",
            b'"%d %d %d %d",' % (w, h, len(colours), bpp)]
    head += [b'"%s c #%02x%02x%02x",' % (k.tobytes(), *map(int, c))
             for k, c in zip(keys, colours)]
    head.append(b"/* pixels */")
    rows = np.empty((h, w * bpp + 3), np.uint8)
    rows[:, 0] = ord('"')
    rows[:, 1:-2] = keys[idx].reshape(h, w * bpp)
    rows[:, -2:] = np.frombuffer(b'",', np.uint8)
    body = b"\n".join(r.tobytes() for r in rows)
    return b"\n".join(head) + b"\n" + body + b"\n};\n"
