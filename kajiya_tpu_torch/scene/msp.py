"""MSP (Windows Paint) texture decoding, as PIL 12.1.0's `MspImagePlugin`
reads it (`Image.open(f).convert("RGBA")`, byte for byte).

A 32-byte header whose 16 little-endian words XOR to 0 (else a refusal),
the size in words 2 and 3. Version 1 (`DanM`) is raw `1` rows from byte
32. Version 2 (`LinS`) is PIL's `MspDecoder`: a map of one byte count per
row, then each row's RLE (a 0 byte, a count and a value repeats the
value; any other byte n copies n literal bytes; a count of 0 is a white
row); every row's bytes run on into one stream that PIL reads as packed
rows. A short map, row or run is PIL's OSError, too few bytes its "not
enough image data" (white).
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError


def decode_msp(data: bytes) -> np.ndarray:
    """MSP bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("MSP"):
        s = data[:32]
        if not s.startswith((b"DanM", b"LinS")):
            raise SyntaxError("not an MSP file")
        checksum = 0
        for i in range(0, 32, 2):
            checksum ^= struct.unpack_from("<H", s, i)[0]
        if checksum != 0:
            raise SyntaxError("bad MSP checksum")
        w, h = struct.unpack_from("<HH", s, 4)
    if w <= 0 or h <= 0:
        raise Refused("MSP: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    if s.startswith(b"DanM"):
        return raster.to_rgba("1", raster.raw_decode(data, 32, "1", "1", w,
                                                     h))
    rowmap = data[32:32 + 2 * h]
    if len(rowmap) < 2 * h:
        raise DecodeError("Truncated MSP file in row map")
    pos, out = 32 + 2 * h, []
    blank = b"\xff" * ((w + 7) // 8)
    for y, rowlen in enumerate(np.frombuffer(rowmap, "<u2").tolist()):
        if rowlen == 0:
            out.append(blank)
            continue
        row = data[pos:pos + rowlen]
        pos += rowlen
        if len(row) != rowlen:
            raise DecodeError(f"Truncated MSP file, row {y}")
        idx = 0
        while idx < rowlen:
            runtype = row[idx]
            idx += 1
            if runtype == 0:
                if idx + 2 > rowlen:
                    raise DecodeError(f"Corrupted MSP file in row {y}")
                out.append(row[idx + 1:idx + 2] * row[idx])
                idx += 2
            else:
                out.append(row[idx:idx + runtype])
                idx += runtype
    raw = b"".join(out)
    if len(raw) < (w + 7) // 8 * h:
        raise DecodeError("MSP: not enough image data")
    return raster.to_rgba("1", raster.raw_decode(raw, 0, "1", "1", w, h))
