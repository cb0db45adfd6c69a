"""JPEG encoding for the live viewer's MJPEG stream, and JPEG decoding for
texture sources.

The JAX package encodes its stream with PIL; the port may not import PIL, so
it has its own encoder: `csrc/jpeg_encoder.cpp` (8-bit, 4:2:0, the Annex K
quantisation tables at IJG quality 85, PIL's setting in the JAX viewer, the
Annex K Huffman tables, libjpeg's colour conversion, chroma box filter and
float DCT; restart intervals; and a grey lossless writer), compiled with g++ at first use into the gitignored `_build/`
(`hostlib.load`) and called through ctypes, which releases the interpreter
lock during the call, so encoding does not stall the render thread. Where the
encoder cannot be built, `encode_jpeg` raises with the compiler's output:
there is no encoder in Python to fall back to. It runs on the host, as PIL's
libjpeg does for the JAX package.

`decode_jpeg` decodes a texture source to what PIL's
`Image.open(f).convert("RGBA")` gives, byte for byte: `csrc/jpeg_decoder.cpp`
follows libjpeg-turbo 3.1.3's default decompression as PIL drives it
(baseline, extended and progressive frames, Huffman or arithmetic coded,
and lossless frames; islow IDCT, block smoothing, fancy upsampling,
jdcolor.c's tables; L, RGB and CMYK / YCCK as PIL reads them), built and
loaded the same way. Corrupt entropy data that libjpeg decodes with a
warning (a segment that ends early, a bad code, restart markers out of
sequence, scans out of the progression) comes out as libjpeg decodes it,
PIL's 65536-byte feed included; corrupt data that makes PIL raise raises
`JpegError`, a ValueError (the bake turns it white, as the JAX package's
does).

`decode_jpeg_planes` gives libjpeg's raw data output (each component's
samples, no upsampling, no colour conversion), which libtiff's old-style
JPEG codec reads. `read_jpeg_header` reads a JFIF's size and components from
its SOF0 marker.
"""
from __future__ import annotations

import ctypes
import io
import os
import struct
import threading

import numpy as np

from .. import hostlib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER_SOURCE = os.path.join(_PKG, "csrc", "jpeg_encoder.cpp")
DECODER_SOURCE = os.path.join(_PKG, "csrc", "jpeg_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_encoder = None
_decoder = None


class JpegError(ValueError):
    """The bytes are not a JPEG that PIL would decode."""


def encoder_library() -> ctypes.CDLL:
    """The native encoder, compiled at first use into BUILD_DIR and loaded
    with ctypes (`hostlib.load`)."""
    global _encoder
    with _lock:
        if _encoder is not None:
            return _encoder
        lib = hostlib.load(ENCODER_SOURCE, "jpeg_encoder", CXX, CXX_FLAGS,
                           BUILD_DIR, "the JPEG encoder")
        lib.kt_jpeg_bound.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.kt_jpeg_bound.restype = ctypes.c_longlong
        lib.kt_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong]
        lib.kt_jpeg_encode.restype = ctypes.c_longlong
        lib.kt_jpeg_encode_rst.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong]
        lib.kt_jpeg_encode_rst.restype = ctypes.c_longlong
        lib.kt_jpeg_lossless_bound.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.kt_jpeg_lossless_bound.restype = ctypes.c_longlong
        lib.kt_jpeg_encode_lossless.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong]
        lib.kt_jpeg_encode_lossless.restype = ctypes.c_longlong
        _encoder = lib
        return lib


def encode_jpeg(img: np.ndarray, restart: int = 0) -> bytes:
    """Encode an (H, W, 3) uint8 RGB image as a baseline 4:2:0 JFIF at
    quality 85, with a restart marker every `restart` MCUs (0: none)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    lib = encoder_library()
    h, w = img.shape[:2]
    px = np.ascontiguousarray(img)
    out = np.empty(lib.kt_jpeg_bound(w, h), np.uint8)
    n = lib.kt_jpeg_encode_rst(px.ctypes.data, w, h, restart, out.ctypes.data,
                               out.size)
    if n < 0:
        raise ValueError(f"the JPEG encoder refused a {w}x{h} image "
                         f"(restart {restart}, status {n})")
    return out[:n].tobytes()


def encode_jpeg_lossless(grey: np.ndarray, psv: int = 1) -> bytes:
    """Encode an (H, W) uint8 grey image as a lossless (SOF3) JPEG with
    predictor `psv` (1-7), no point transform: it decodes to `grey`."""
    if grey.dtype != np.uint8 or grey.ndim != 2:
        raise ValueError(f"encode_jpeg_lossless takes (H, W) uint8, got "
                         f"{grey.dtype} {grey.shape}")
    lib = encoder_library()
    h, w = grey.shape
    px = np.ascontiguousarray(grey)
    out = np.empty(lib.kt_jpeg_lossless_bound(w, h), np.uint8)
    n = lib.kt_jpeg_encode_lossless(px.ctypes.data, w, h, psv,
                                    out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"the lossless JPEG encoder refused a {w}x{h} "
                         f"image (predictor {psv}, status {n})")
    return out[:n].tobytes()


def decoder_library() -> ctypes.CDLL:
    """The native decoder, compiled at first use into BUILD_DIR."""
    global _decoder
    with _lock:
        if _decoder is not None:
            return _decoder
        lib = hostlib.load(DECODER_SOURCE, "jpeg_decoder", CXX, CXX_FLAGS,
                           BUILD_DIR, "the JPEG decoder")
        lib.kt_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.kt_jpeg_dims.restype = ctypes.c_int
        lib.kt_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.kt_jpeg_decode.restype = ctypes.c_int
        lib.kt_jpeg_decode_as.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.kt_jpeg_decode_as.restype = ctypes.c_int
        lib.kt_jpeg_planes_info.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.kt_jpeg_planes_info.restype = ctypes.c_int
        lib.kt_jpeg_planes.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.kt_jpeg_planes.restype = ctypes.c_int
        _decoder = lib
        return lib


def _raise(status: int, msg: ctypes.Array) -> None:
    raise JpegError(f"corrupt JPEG: {msg.value.decode('ascii', 'replace')}")


# JpegImagePlugin.MARKER: the handler `_open` runs for each marker code
# (None: the code is known but nothing reads its segment)
_SOF_CODES = (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
              0xCD, 0xCE, 0xCF, 0xDE)
_HANDLERS = {0xFF00 | c: "SOF" for c in _SOF_CODES}
_HANDLERS.update({0xFF00 | c: "SKIP" for c in (0xC4, 0xCC, 0xDA, 0xDC, 0xDD,
                                               0xDF)})
_HANDLERS.update({0xFF00 | c: None for c in (0xC8, *range(0xD0, 0xDA),
                                             *range(0xF0, 0xFE))})
_HANDLERS.update({0xFF00 | c: "APP" for c in range(0xE0, 0xF0)})
_HANDLERS.update({0xFFDB: "DQT", 0xFFFE: "COM"})


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", b, o)[0]


def _segment(fp: io.BytesIO) -> bytes:
    """A handler's `n = i16(read(2)) - 2; ImageFile._safe_read(fp, n)`."""
    n = _i16(fp.read(2)) - 2
    if n <= 0:
        return b""
    s = fp.read(n)
    if len(s) < n:
        raise JpegError("Truncated File Read")
    return s


def read_header(data: bytes):
    """JpegImageFile._open's walk over the markers up to the first SOS:
    (mode, width, height) of the last frame header it reads. Raises what
    `_open` raises: SyntaxError, IndexError or struct.error where PIL
    refuses the bytes (a marker code outside its table, a frame header it
    cannot handle, the data ending first), JpegError where it raises
    OSError (a segment longer than the file)."""
    fp = io.BytesIO(data)
    if fp.read(3) != b"\xff\xd8\xff":
        raise SyntaxError("not a JPEG file")
    s = b"\xff"
    mode, size, icc = "", (0, 0), []
    while True:
        i = s[0]
        if i == 0xFF:
            s = s + fp.read(1)
            i = _i16(s)
        else:
            s = fp.read(1)     # junk that is not FF
            continue
        if i in _HANDLERS:
            kind = _HANDLERS[i]
            if kind in ("SKIP", "COM"):
                _segment(fp)
            elif kind == "APP":
                seg = _segment(fp)
                if (i == 0xFFE0 and seg.startswith(b"JFIF")) or \
                        (i == 0xFFEE and seg.startswith(b"Adobe")):
                    _i16(seg, 5)
                elif i == 0xFFE2 and seg.startswith(b"ICC_PROFILE\0"):
                    icc.append(seg)
                elif i == 0xFFED and seg.startswith(b"Photoshop 3.0\x00"):
                    _photoshop(seg)
            elif kind == "DQT":
                seg = _segment(fp)
                while len(seg):
                    qt_length = 1 + (1 if seg[0] // 16 == 0 else 2) * 64
                    if len(seg) < qt_length:
                        raise SyntaxError("bad quantization table marker")
                    seg = seg[qt_length:]
            elif kind == "SOF":
                seg = _segment(fp)
                size = (_i16(seg, 3), _i16(seg, 1))
                if seg[0] != 8:
                    raise SyntaxError(f"cannot handle {seg[0]}-bit layers")
                mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(seg[5], "")
                if not mode:
                    raise SyntaxError(f"cannot handle {seg[5]}-layer images")
                if icc:
                    icc.sort()
                    icc[0][13]
                    icc = []
            if i == 0xFFDA:
                break
            s = fp.read(1)
        elif i in (0, 0xFFFF):
            s = b"\xff"       # a padded marker
        elif i == 0xFF00:
            s = fp.read(1)     # an escaped FF
        else:
            raise SyntaxError("no marker found")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("no mode or size (PIL: not identified)")
    return mode, size[0], size[1]


def _photoshop(seg: bytes) -> None:
    """APP's walk over Photoshop's 8BIM resources: a cut resource ends it
    (struct.error), a cut name length raises IndexError."""
    offset = 14
    while seg[offset:offset + 4] == b"8BIM":
        try:
            offset += 4
            _i16(seg, offset)
            offset += 2
            offset += 1 + seg[offset]
            offset += offset & 1
            size = struct.unpack_from(">I", seg, offset)[0]
            offset += 4 + size
            offset += offset & 1
        except struct.error:
            break


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`.
    Raises `identify.Refused` where `JpegImageFile._open` refuses them."""
    from .identify import check_pixels, opening

    data = bytes(data)
    with opening("JPEG"):
        read_header(data)
    lib = decoder_library()
    msg = ctypes.create_string_buffer(256)
    w, h = ctypes.c_int(), ctypes.c_int()
    st = lib.kt_jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          msg, len(msg))
    if st:
        _raise(st, msg)
    check_pixels(w.value, h.value)
    out = np.empty((h.value, w.value, 4), np.uint8)
    st = lib.kt_jpeg_decode(data, len(data), out.ctypes.data, w.value,
                            h.value, msg, len(msg))
    if st:
        _raise(st, msg)
    return out


def decode_jpeg_stream(data: bytes, color: int) -> np.ndarray:
    """A JPEG stream as libjpeg decodes it for libtiff (no PIL header
    walk): (H, W, 4) uint8, its colour space set by `color` (1: YCbCr
    converted to RGB, 2: the components as coded; a single component is
    grey either way). `color` 3 takes the colour space from the markers,
    as PIL does, but four components as CMYK even under an Adobe YCCK
    transform (PIL's BLP reader sets the JPEG mode "CMYK")."""
    lib = decoder_library()
    data = bytes(data)
    msg = ctypes.create_string_buffer(256)
    w, h = ctypes.c_int(), ctypes.c_int()
    st = lib.kt_jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          msg, len(msg))
    if st:
        _raise(st, msg)
    out = np.empty((h.value, w.value, 4), np.uint8)
    st = lib.kt_jpeg_decode_as(data, len(data), out.ctypes.data, w.value,
                               h.value, color, msg, len(msg))
    if st:
        _raise(st, msg)
    return out


def jpeg_frame(data: bytes) -> dict:
    """The frame header of a JPEG stream as libjpeg reads it (the markers
    before it read and checked): width, height, the largest sampling
    factors and each component's (h, v). Raises JpegError where libjpeg's
    jpeg_read_header fails before the frame."""
    lib = decoder_library()
    data = bytes(data)
    msg = ctypes.create_string_buffer(256)
    info = np.zeros(5 + 4 * 4, np.int32)
    st = lib.kt_jpeg_planes_info(data, len(data), info.ctypes.data, msg,
                                 len(msg))
    if st:
        _raise(st, msg)
    comps = [tuple(int(v) for v in info[5 + 4 * i:9 + 4 * i])
             for i in range(int(info[0]))]
    return {"width": int(info[1]), "height": int(info[2]),
            "hmax": int(info[3]), "vmax": int(info[4]),
            "comps": [c[:2] for c in comps], "planes": [c[2:] for c in comps]}


def decode_jpeg_planes(data: bytes) -> list:
    """libjpeg's raw data output of a JPEG stream (jpeg_read_raw_data, no
    upsampling and no colour conversion, as libtiff's old-style JPEG codec
    asks for it): one (rows, width) uint8 plane a component, at the
    component's resolution and padded to whole MCUs."""
    frame = jpeg_frame(data)
    lib = decoder_library()
    data = bytes(data)
    msg = ctypes.create_string_buffer(256)
    sizes = [w * h for w, h in frame["planes"]]
    out = np.empty(sum(sizes), np.uint8)
    st = lib.kt_jpeg_planes(data, len(data), out.ctypes.data, msg, len(msg))
    if st:
        _raise(st, msg)
    planes, pos = [], 0
    for (w, h), n in zip(frame["planes"], sizes):
        planes.append(out[pos:pos + n].reshape(h, w))
        pos += n
    return planes


def read_jpeg_header(data: bytes):
    """(width, height, components) from a JFIF's SOF0 marker; raises
    ValueError for anything else (no SOI, or no baseline frame header)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI)")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"no marker at byte {i}")
        marker = data[i + 1]
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if marker == 0xC0:
            _, h, w, nc = struct.unpack(">BHHB", data[i + 4:i + 10])
            return w, h, nc
        if marker == 0xDA:
            break
        i += 2 + length
    raise ValueError("no baseline frame header (SOF0)")
