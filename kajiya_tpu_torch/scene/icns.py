"""ICNS texture decoding, as PIL 12.1.0's `IcnsImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

`_open` walks the blocks (a block of fewer than 8 bytes steps back into
its own header, as PIL's relative seek does) and takes the largest size,
by (width, height, scale), that has a member of PIL's `SIZES` table. The
load reads every member of that size in the table's order: a PNG member
(`png.py`, without its tRNS: the icon takes the PNG's pixels, not its
info) wins over the RGB ones; else `it32` / `ih32` / `il32` / `is32` give
RGB, raw or in PIL's PackBits-like RLE per channel (it32 behind four zero
bytes), and a `t8mk` ... `s8mk` mask gives alpha (none: opaque). A
JPEG 2000 member (a codestream or a JP2 file) decodes through `j2k.py`, as
`read_png_or_jpeg2000` opens it with `Jpeg2KImageFile` and converts it to
RGBA; it is read at load time, so any of its errors whitens. A PNG or
JPEG 2000 member whose size no listed size divides raises, as PIL's size
setter does.
"""
from __future__ import annotations

import struct

import numpy as np

from . import j2k, raster
from .identify import Refused, opening
from .png import PNG_SIGNATURE, decode_png
from .raster import DecodeError, Stream

# PIL's IcnsFile.SIZES, in its order: (width, height, scale) -> members
SIZES = (
    ((512, 512, 2), ((b"ic10", "png"),)),
    ((512, 512, 1), ((b"ic09", "png"),)),
    ((256, 256, 2), ((b"ic14", "png"),)),
    ((256, 256, 1), ((b"ic08", "png"),)),
    ((128, 128, 2), ((b"ic13", "png"),)),
    ((128, 128, 1), ((b"ic07", "png"), (b"it32", "32t"), (b"t8mk", "mk"))),
    ((64, 64, 1), ((b"icp6", "png"),)),
    ((32, 32, 2), ((b"ic12", "png"),)),
    ((48, 48, 1), ((b"ih32", "32"), (b"h8mk", "mk"))),
    ((32, 32, 1), ((b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mk"))),
    ((16, 16, 2), ((b"ic11", "png"),)),
    ((16, 16, 1), ((b"icp4", "png"), (b"is32", "32"), (b"s8mk", "mk"))),
)
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
_JP2 = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def _open(fp: Stream):
    """IcnsFile.__init__ and bestsize: (blocks, sizes present, best)."""
    sig, filesize = struct.unpack(">4sI", fp.read(8))
    if not sig.startswith(b"icns"):
        raise SyntaxError("not an icns file")
    blocks, i = {}, 8
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", fp.read(8))
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocksize -= 8
        blocks[sig] = (i, blocksize)
        fp.seek(fp.tell() + blocksize)
        i += blocksize
    sizes = [size for size, members in SIZES
             if any(code in blocks for code, _ in members)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    return blocks, sizes, max(sizes)


def _read_32(fp: Stream, start: int, length: int, n: int) -> np.ndarray:
    """read_32: (n, 3) uint8, raw when the member holds exactly 3 n bytes,
    else three channels of RLE (a control byte c < 128 copies c + 1 bytes,
    else repeats the next byte c - 125 times), read on from `start`."""
    fp.seek(start)
    if length == n * 3:
        raw = fp.read(length)
        if len(raw) < length:
            raise DecodeError("ICNS: not enough image data")
        return np.frombuffer(raw, np.uint8).reshape(n, 3)
    out = np.empty((n, 3), np.uint8)
    for band in range(3):
        chunks, left = [], n
        while left > 0:
            b = fp.read(1)
            if not b:
                break
            if b[0] & 0x80:
                size = b[0] - 125
                chunks.append(fp.read(1) * size)
            else:
                size = b[0] + 1
                chunks.append(fp.read(size))
            left -= size
        if left != 0:
            raise DecodeError(f"ICNS: error reading channel [{left} left]")
        plane = b"".join(chunks)
        if len(plane) < n:
            raise DecodeError("ICNS: buffer is not large enough")
        out[:, band] = np.frombuffer(plane, np.uint8, n)
    return out


def decode_icns(data: bytes) -> np.ndarray:
    """ICNS bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    fp = Stream(data)
    with opening("ICNS"):
        blocks, sizes, best = _open(fp)
    w, h = best[0] * best[2], best[1] * best[2]
    n = w * h
    rgb = alpha = png = jp2k = None
    for code, reader in dict(SIZES)[best]:
        if code not in blocks:
            continue
        start, length = blocks[code]
        if reader == "png":
            sig = data[start:start + 12]
            if sig.startswith(PNG_SIGNATURE):
                png = start
            elif sig.startswith(_J2K) or sig == _JP2:
                jp2k = data[start:start + length]
            else:
                raise DecodeError("Unsupported icon subimage format")
        elif reader == "32t":
            if data[start:start + 4] != b"\0\0\0\0":
                raise DecodeError("Unknown signature, expecting 0x00000000")
            rgb = _read_32(fp, start + 4, length - 4, n)
        elif reader == "32":
            rgb = _read_32(fp, start, length, n)
        else:
            mask = data[start:start + n]
            if len(mask) < n:
                raise DecodeError("ICNS mask: buffer is not large enough")
            alpha = np.frombuffer(mask, np.uint8)
    if png is not None or jp2k is not None:
        if png is not None:
            out = decode_png(data[png:], transparency=False)
        else:
            try:
                out = j2k.decode_j2k(jp2k)
            except Refused as e:
                raise DecodeError(f"ICNS JPEG 2000 member: {e}") from e
        ph, pw = out.shape[:2]
        # IcnsImageFile's size setter: some listed size a multiple of it
        if not any((s[0] * s[2]) // pw == (s[1] * s[2]) / ph for s in sizes):
            raise DecodeError("This is not one of the allowed sizes")
        return out
    if rgb is None:
        raise DecodeError("ICNS: no RGB member for the best size")
    px = np.concatenate([rgb, np.full((n, 1), 255, np.uint8) if alpha is None
                         else alpha[:, None]], -1)
    return raster.to_rgba("RGBA", px.reshape(h, w, 4))


def _rle(channel: bytes) -> bytes:
    """One channel in read_32's RLE: runs of 3 to 130, literals of up to
    128."""
    out, i, n = bytearray(), 0, len(channel)
    while i < n:
        j = i
        while j + 1 < n and channel[j + 1] == channel[i] and j - i < 129:
            j += 1
        if j - i >= 2:
            out += bytes([j - i + 1 + 125, channel[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and channel[j] == channel[j + 1] == channel[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + channel[i:j]
        i = j
    return bytes(out)


def encode_icns(members) -> bytes:
    """An ICNS file of `members`, (code, payload) pairs in file order:
    `rgb_member` and `mask_member` make the RGB and mask payloads, a PNG
    file is its own."""
    body = b"".join(code + struct.pack(">I", len(p) + 8) + p
                    for code, p in members)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def rgb_member(rgb: np.ndarray, it32: bool = False) -> bytes:
    """(H, W, 3) uint8 -> an RLE RGB member (it32 with its zero header)."""
    planes = np.ascontiguousarray(np.moveaxis(rgb, -1, 0)).reshape(3, -1)
    out = b"".join(_rle(p.tobytes()) for p in planes)
    if len(out) == planes.size:
        raise ValueError("RLE as long as the raw channels: PIL reads it raw")
    return b"\0\0\0\0" + out if it32 else out


def mask_member(alpha: np.ndarray) -> bytes:
    """(H, W) uint8 -> a mask member."""
    return np.ascontiguousarray(alpha, np.uint8).tobytes()
