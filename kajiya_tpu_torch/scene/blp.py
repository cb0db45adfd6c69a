"""BLP texture decoding, as PIL 12.1.0's `BlpImagePlugin` reads it
(`Image.open(f).convert("RGBA")`, byte for byte).

The header gives the compression, the alpha flag (RGBA with it, RGB
without) and the size; 16 mip offsets and 16 lengths follow, of which PIL
reads the first. BLP1: compression 0 is a JPEG (a shared header, then the
first mip's data), opened as PIL's `JpegImageFile` (four components as
CMYK, never YCCK) and converted to RGB, its bytes then read as BGR (so red
and blue trade places); compression 1
with encoding 4 or 5 is 256 BGRA palette entries and one index a pixel,
read right after the palette. BLP2: the palette always comes first; then,
from the first mip's offset, encoding 1 (indices), or 2 (DXT1 / DXT3 /
DXT5 by the alpha encoding 0 / 1 / 7) through PIL's own Python block
decoders (`decode_dxt1` / 3 / 5: 565 colours shifted, not replicated;
integer interpolation), which `csrc/raster_decoder.cpp` runs: DXT3 and DXT5
give 4 bytes a pixel even for an RGB image, and every block row gives rows
of whole blocks, so PIL's raw decoder reads that stream as it comes.

Everything PIL raises while decoding (its BLPFormatError, a subclass of
NotImplementedError, for a compression or encoding it has no decoder for;
OSError for data that ends first; ValueError for too little image data)
turns the JAX bake's texture white, so here it is a DecodeError: the port's
NotImplementedError means "not ported", never "PIL refuses".
"""
from __future__ import annotations

import struct

import numpy as np

from . import raster
from .identify import Refused, check_pixels, opening
from .raster import DecodeError, Stream


def decode_blp(data: bytes) -> np.ndarray:
    """BLP bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    with opening("BLP"):
        fp = Stream(data)
        magic = fp.read(4)
        if magic not in (b"BLP1", b"BLP2"):
            raise DecodeError(f"Bad BLP magic {magic!r}")
        compression = struct.unpack("<i", fp.read(4))[0]
        alpha_encoding = None
        if magic == b"BLP1":
            alpha = struct.unpack("<I", fp.read(4))[0] != 0
        else:
            encoding = struct.unpack("<b", fp.read(1))[0]
            alpha = struct.unpack("<b", fp.read(1))[0] != 0
            alpha_encoding = struct.unpack("<b", fp.read(1))[0]
            fp.seek(fp.tell() + 1)
        w, h = struct.unpack("<II", fp.read(8))
        if magic == b"BLP1":
            encoding = struct.unpack("<i", fp.read(4))[0]
    if w <= 0 or h <= 0:
        raise Refused("BLP: size not positive (ImageFile refuses it)")
    check_pixels(w, h)
    mode = "RGBA" if alpha else "RGB"
    fp = Stream(data, 28 if magic == b"BLP1" else 20)
    try:
        offsets = struct.unpack("<16I", raster.safe_read(fp, 64))
        lengths = struct.unpack("<16I", raster.safe_read(fp, 64))
        if magic == b"BLP1":
            stream = _blp1(data, fp, compression, encoding, alpha, offsets,
                           lengths)
        else:
            stream = _blp2(data, fp, compression, encoding, alpha,
                           alpha_encoding, offsets, lengths, w, h)
    except struct.error as e:
        raise DecodeError("Truncated BLP file") from e
    if isinstance(stream, np.ndarray):      # the JPEG's RGB, read as BGR
        return _as_raw(stream, "BGR", w, h)
    return _as_raw(stream, mode, w, h)


def _as_raw(stream, rawmode: str, w: int, h: int) -> np.ndarray:
    """set_as_raw: the stream's first rows as pixels (fewer bytes than the
    image needs is PIL's "not enough image data")."""
    stream = np.frombuffer(bytes(stream), np.uint8) if not isinstance(
        stream, np.ndarray) else stream.reshape(-1)
    per = 3 if rawmode in ("RGB", "BGR") else 4
    if stream.size < w * h * per:
        raise DecodeError("not enough image data")
    px = stream[:w * h * per].reshape(h, w, per)
    if rawmode == "BGR":
        px = px[..., ::-1]
    return raster.to_rgba("RGB" if per == 3 else "RGBA",
                          np.ascontiguousarray(px))


def _palette(fp: Stream) -> np.ndarray:
    """_read_palette: 256 BGRA entries (a short read raises)."""
    return np.frombuffer(raster.safe_read(fp, 1024), np.uint8).reshape(256, 4)


def _bgra(fp: Stream, pal: np.ndarray, alpha: bool, n: int) -> bytes:
    """_read_bgra: `n` indices, each its entry's R, G, B (and A)."""
    idx = np.frombuffer(raster.safe_read(fp, n), np.uint8)
    order = [2, 1, 0, 3] if alpha else [2, 1, 0]
    return pal[idx][:, order].tobytes()


def _blp1(data, fp, compression, encoding, alpha, offsets, lengths):
    if compression == 0:
        return _jpeg(data, fp, offsets, lengths)
    if compression == 1 and encoding in (4, 5):
        pal = _palette(fp)
        return _bgra(fp, pal, alpha, lengths[0])
    raise DecodeError(f"Unsupported BLP compression {compression} / "
                      f"encoding {encoding}")


def _blp2(data, fp, compression, encoding, alpha, alpha_encoding, offsets,
          lengths, w, h):
    pal = _palette(fp)
    fp.seek(offsets[0])
    if compression != 1:
        raise DecodeError(f"Unknown BLP compression {compression}")
    if encoding == 1:
        return _bgra(fp, pal, alpha, lengths[0])
    if encoding != 2:
        raise DecodeError(f"Unknown BLP encoding {encoding}")
    if alpha_encoding not in (0, 1, 7):
        raise DecodeError(f"Unsupported alpha encoding {alpha_encoding}")
    bpp = 3 if alpha_encoding == 0 and not alpha else 4
    linesize = (w + 3) // 4 * (8 if alpha_encoding == 0 else 16)
    if len(data) - offsets[0] < linesize * ((h + 3) // 4):
        raise DecodeError("Truncated File Read")
    out = np.empty(((h + 3) // 4) * 4 * ((w + 3) // 4) * 4 * bpp, np.uint8)
    st = raster.library().kt_blp_dxt(data, len(data), offsets[0], w, h,
                                     alpha_encoding, int(alpha),
                                     out.ctypes.data)
    raster.check_status(st, "BLP DXT")
    return out.tobytes()


def _jpeg(data, fp, offsets, lengths) -> np.ndarray:
    """_decode_jpeg_stream: the shared header, a skip to the first mip, its
    data; PIL's JPEG reader (no plugin walk: its refusals raise), RGB."""
    from . import jpeg

    size = struct.unpack("<I", raster.safe_read(fp, 4))[0]
    header = raster.safe_read(fp, size)
    raster.safe_read(fp, offsets[0] - fp.tell())
    stream = header + raster.safe_read(fp, lengths[0])
    try:
        mode, jw, jh = jpeg.read_header(stream)
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError,
            struct.error) as e:
        raise DecodeError(f"BLP JPEG: {e!r}") from e
    check_pixels(jw, jh)
    # the BLP plugin sets the JPEG mode of a four-component JPEG to
    # "CMYK": libjpeg takes it as CMYK, not YCCK
    rgba = jpeg.decode_jpeg_stream(stream, 3 if mode == "CMYK" else 0)
    return np.ascontiguousarray(rgba[..., :3])
