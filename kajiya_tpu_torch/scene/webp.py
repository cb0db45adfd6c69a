"""WebP texture decoding, as PIL 12.1.0 reads it through libwebp 1.6.0's
animation decoder (`Image.open(f).convert("RGBA")`, byte for byte).

PIL opens every WebP with `_webp.WebPAnimDecoder`: `WebPGetFeatures` on
the whole file picks the mode (RGB when the file declares no alpha, so
alpha 255), `WebPAnimDecoderNew` validates the file (`WebPGetFeatures`
again and the demuxer, `WebPDemux`), and the first frame is decoded in
MODE_RGBA onto a canvas of zeros at its offset. This module walks the RIFF
container as those three do, with their checks (chunk sizes against the
RIFF size, the VP8X flags and canvas, an ANIM chunk before the ANMF
frames, a frame inside the canvas, ALPH before the image, the VP8 / VP8L
headers); `csrc/webp_decoder.cpp` decodes the frame: simple `VP8 ` (lossy),
`VP8L` (lossless) and extended `VP8X` files, with ALPH (raw or lossless,
with its filters), ICCP / EXIF / XMP skipped and animations read to their
first frame. Anything libwebp refuses raises `WebPError` (an OSError, as
PIL's; white in the bake). PIL never falls through from WebP to another
plugin.
"""
from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

import numpy as np

from .. import hostlib
from .identify import check_pixels

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "webp_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
ICCP_FLAG, EXIF_FLAG, XMP_FLAG = 0x20, 0x08, 0x04
ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | ICCP_FLAG | EXIF_FLAG | \
    XMP_FLAG

_lock = threading.Lock()
_lib = None


class WebPError(OSError):
    """libwebp refuses the file: PIL raises OSError."""


def library() -> ctypes.CDLL:
    """The native decoder, compiled at first use into BUILD_DIR."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = hostlib.load(SOURCE, "webp_decoder", CXX, CXX_FLAGS, BUILD_DIR,
                           "the WebP decoder")
        i64, ptr, c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.kt_vp8_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p,
                                      i64, c_int, c_int, ptr, i64,
                                      ctypes.c_char_p, c_int]
        lib.kt_vp8_decode.restype = c_int
        lib.kt_vp8l_decode.argtypes = [ctypes.c_char_p, i64, c_int, c_int,
                                       ptr, i64, ctypes.c_char_p, c_int]
        lib.kt_vp8l_decode.restype = c_int
        _lib = lib
        return lib


def _le(b: bytes, o: int, n: int) -> int:
    return int.from_bytes(b[o:o + n], "little")


class _NotEnough(Exception):
    """VP8_STATUS_NOT_ENOUGH_DATA."""


def _vp8_info(data: bytes, chunk_size: int):
    """VP8GetInfo: (width, height) of a key frame, or None."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | data[1] << 8 | data[2] << 16
    w, h = _le(data, 6, 2) & 0x3fff, _le(data, 8, 2) & 0x3fff
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or \
            (bits >> 5) >= chunk_size or w == 0 or h == 0:
        return None
    return w, h


def _vp8l_info(data: bytes):
    """VP8LGetInfo: (width, height, alpha) of a VP8L header, or None."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5 != 0:
        return None
    v = _le(data, 1, 4)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


@dataclass
class Headers:
    """What `ParseHeadersInternal` finds."""
    width: int
    height: int
    has_alpha: bool
    animated: bool
    lossless: bool = False
    offset: int = 0           # of the VP8 / VP8L payload
    alpha: tuple | None = None   # (offset, size) of the ALPH payload


def parse_headers(data: bytes, have_all_data: bool) -> Headers:
    """libwebp's ParseHeadersInternal; raises WebPError for a bitstream
    error or missing data, as WebPGetFeatures / WebPDecode fail."""
    try:
        return _parse_headers(data, have_all_data)
    except _NotEnough:
        raise WebPError("not enough data") from None


def _parse_headers(data: bytes, have_all_data: bool) -> Headers:
    n, pos = len(data), 0
    if n < 12:
        raise _NotEnough
    riff_size = 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise WebPError("wrong RIFF signature")
        size = _le(data, 4, 4)
        if size < 12 or size > MAX_CHUNK_PAYLOAD:
            raise WebPError("bad RIFF size")
        if have_all_data and size > n - 8:
            raise _NotEnough
        riff_size, pos = size, 12
    # VP8X
    if n - pos < 8:
        raise _NotEnough
    found_vp8x, flags, cw, ch = False, 0, 0, 0
    if data[pos:pos + 4] == b"VP8X":
        if _le(data, pos + 4, 4) != 10:
            raise WebPError("wrong VP8X chunk size")
        if n - pos < 18:
            raise _NotEnough
        flags = _le(data, pos + 8, 4)
        cw, ch = 1 + _le(data, pos + 12, 3), 1 + _le(data, pos + 15, 3)
        if cw * ch >= MAX_IMAGE_AREA:
            raise WebPError("image is too large")
        pos += 18
        found_vp8x = True
    if not riff_size and found_vp8x:
        raise WebPError("VP8X without RIFF")
    hd = Headers(cw, ch, bool(flags & ALPHA_FLAG),
                 bool(flags & ANIMATION_FLAG))
    if found_vp8x and hd.animated:
        return hd
    try:
        if n - pos < 4:
            raise _NotEnough
        if (riff_size and found_vp8x) or \
                (not riff_size and not found_vp8x and
                 data[pos:pos + 4] == b"ALPH"):
            pos = _optional_chunks(data, pos, riff_size, hd)
        # the VP8 / VP8L chunk header
        if n - pos < 8:
            raise _NotEnough
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le(data, pos + 4, 4)
            if riff_size >= 12 and size > riff_size - 12:
                raise WebPError("inconsistent chunk size")
            if have_all_data and size > n - pos - 8:
                raise _NotEnough
            compressed, lossless = size, tag == b"VP8L"
            pos += 8
        else:
            lossless = len(data) - pos >= 5 and data[pos] == 0x2F and \
                data[pos + 4] >> 5 == 0
            compressed = n - pos
        if compressed > MAX_CHUNK_PAYLOAD:
            raise WebPError("chunk too large")
        hd.lossless, hd.offset = lossless, pos
        if not lossless:
            if n - pos < 10:
                raise _NotEnough
            info = _vp8_info(data[pos:], compressed)
            if info is None:
                raise WebPError("bad VP8 header")
            w, h = info
        else:
            if n - pos < 5:
                raise _NotEnough
            info = _vp8l_info(data[pos:])
            if info is None:
                raise WebPError("bad VP8L header")
            w, h, hd.has_alpha = info[0], info[1], bool(info[2])
        if found_vp8x and (cw, ch) != (w, h):
            raise WebPError("canvas and image sizes differ")
        hd.width, hd.height = w, h
    except _NotEnough:
        # WebPGetFeatures reports a VP8X file's canvas without its image
        if not found_vp8x or have_all_data:
            raise
    hd.has_alpha |= hd.alpha is not None
    return hd


def _optional_chunks(data, pos, riff_size, hd) -> int:
    """ParseOptionalChunks: skip to the VP8 / VP8L chunk, noting ALPH."""
    total = 4 + 8 + 10
    while True:
        if len(data) - pos < 8:
            raise _NotEnough
        size = _le(data, pos + 4, 4)
        if size > MAX_CHUNK_PAYLOAD:
            raise WebPError("bad chunk size")
        disk = (8 + size + 1) & ~1
        total += disk
        if riff_size > 0 and total > riff_size:
            raise WebPError("bad chunk size")
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            return pos
        if len(data) - pos < disk:
            raise _NotEnough
        if tag == b"ALPH":
            hd.alpha = (pos + 8, size)
        pos += disk


# ----------------------------------------------------------------------------
# the demuxer (WebPDemux, not partial)
# ----------------------------------------------------------------------------

@dataclass
class Frame:
    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    image: tuple = (0, 0)     # (offset, size) of the image chunk
    alpha: tuple = (0, 0)     # (offset, size) of the ALPH chunk
    has_alpha: bool = False
    frame_num: int = 0
    complete: bool = False


class _Mem:
    def __init__(self, data: bytes, riff_end: int):
        self.data, self.start, self.riff_end = data, 12, riff_end
        self.end = min(len(data), riff_end)

    def size(self) -> int:
        return self.end - self.start

    def invalid(self, n: int) -> bool:
        return n > self.riff_end - self.start

    def le(self, n: int) -> int:
        v = _le(self.data, self.start, n)
        self.start += n
        return v


class _Demux:
    def __init__(self, data: bytes):
        if len(data) < 20:
            raise WebPError("demux: not enough data")
        riff_size = _le(data, 4, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise WebPError("demux: bad RIFF size")
        self.mem = _Mem(data, riff_size + 8)
        if self.mem.end < self.mem.riff_end:
            raise WebPError("demux: partial file")
        self.flags, self.canvas, self.frames = 0, (0, 0), []
        self.is_ext = False
        tag = data[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            self._single_image()
            self._valid_simple()
        elif tag == b"VP8X":
            self._vp8x()
            self._valid_extended()
        else:
            raise WebPError("demux: no image chunk")

    def _store_frame(self, frame_num: int, min_size: int, frame: Frame):
        """StoreFrame: ALPH and one image chunk; False if the data ends."""
        mem = self.mem
        if mem.size() < 8 or mem.size() < min_size:
            raise WebPError("demux: not enough data")
        alpha_chunks = image_chunks = 0
        while True:
            start = mem.start
            fourcc = mem.data[mem.start:mem.start + 4]
            mem.start += 4
            payload = mem.le(4)
            if payload > MAX_CHUNK_PAYLOAD:
                raise WebPError("demux: bad chunk size")
            padded = payload + (payload & 1)
            avail = min(padded, mem.size())
            if mem.invalid(padded):
                raise WebPError("demux: chunk passes the RIFF end")
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks += 1
                frame.alpha = (start, 8 + avail)
                frame.has_alpha = True
                frame.frame_num = frame_num
                mem.start += avail
            elif fourcc in (b"VP8L", b"VP8 ") and image_chunks == 0:
                if fourcc == b"VP8L" and alpha_chunks > 0:
                    raise WebPError("demux: ALPH before VP8L")
                chunk = mem.data[start:start + 8 + avail]
                try:
                    hd = parse_headers(chunk, False)
                except WebPError:
                    raise WebPError("demux: bad image chunk") from None
                image_chunks += 1
                frame.image = (start, 8 + avail)
                frame.width, frame.height = hd.width, hd.height
                frame.has_alpha |= hd.has_alpha
                frame.frame_num = frame_num
                frame.complete = True
                mem.start += avail
            else:
                mem.start -= 8
                return
            if mem.start == mem.riff_end:
                return
            if mem.size() < 8:
                raise WebPError("demux: not enough data")

    def _single_image(self):
        mem = self.mem
        if self.frames or mem.invalid(8):
            raise WebPError("demux: bad single image")
        if mem.size() < 8:
            raise WebPError("demux: not enough data")
        frame = Frame()
        self._store_frame(1, 0, frame)
        if not self.flags & ALPHA_FLAG and frame.alpha[1] > 0:
            frame.alpha, frame.has_alpha = (0, 0), False
        if not self.is_ext and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
            self.flags |= ALPHA_FLAG if frame.has_alpha else 0
        self._add_frame(frame)

    def _add_frame(self, frame: Frame):
        if self.frames and not self.frames[-1].complete:
            raise WebPError("demux: frame after an incomplete one")
        self.frames.append(frame)

    def _vp8x(self):
        mem = self.mem
        if mem.size() < 8:
            raise WebPError("demux: not enough data")
        self.is_ext = True
        mem.start += 4
        size = mem.le(4)
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise WebPError("demux: bad VP8X size")
        size += size & 1
        if mem.invalid(size) or mem.size() < size:
            raise WebPError("demux: bad VP8X size")
        self.flags = mem.le(1)
        mem.start += 3
        self.canvas = (1 + mem.le(3), 1 + mem.le(3))
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            raise WebPError("demux: canvas too large")
        mem.start += size - 10
        if mem.invalid(8) or mem.size() < 8:
            raise WebPError("demux: not enough data")
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            fourcc = mem.data[mem.start:mem.start + 4]
            mem.start += 4
            size = mem.le(4)
            if size > MAX_CHUNK_PAYLOAD:
                raise WebPError("demux: bad chunk size")
            padded = size + (size & 1)
            if mem.invalid(padded):
                raise WebPError("demux: chunk passes the RIFF end")
            if fourcc == b"VP8X":
                raise WebPError("demux: second VP8X")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    raise WebPError("demux: image outside a frame")
                mem.start -= 8
                self._single_image()
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    raise WebPError("demux: bad ANIM chunk")
                if mem.size() < padded:
                    raise WebPError("demux: not enough data")
                anim_chunks += 1
                mem.start += padded
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    raise WebPError("demux: ANMF before ANIM")
                self._anmf(padded)
            else:
                if padded > mem.size():
                    raise WebPError("demux: not enough data")
                mem.start += padded
            if mem.start == mem.riff_end:
                return
            if mem.size() < 8:
                raise WebPError("demux: not enough data")

    def _anmf(self, chunk_size: int):
        mem = self.mem
        if chunk_size < 16 or mem.invalid(chunk_size):
            raise WebPError("demux: bad ANMF chunk")
        if mem.size() < 16:
            raise WebPError("demux: not enough data")
        frame = Frame()
        frame.x, frame.y = 2 * mem.le(3), 2 * mem.le(3)
        frame.width, frame.height = 1 + mem.le(3), 1 + mem.le(3)
        mem.le(3)
        mem.le(1)
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            raise WebPError("demux: frame too large")
        start = mem.start
        self._store_frame(len(self.frames) + 1, chunk_size - 16, frame)
        if mem.start - start > chunk_size - 16:
            raise WebPError("demux: frame passes its ANMF chunk")
        if self.flags & ANIMATION_FLAG and frame.frame_num > 0:
            self._add_frame(frame)

    def _valid_simple(self):
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise WebPError("demux: invalid simple file")
        f = self.frames[0]
        if f.width <= 0 or f.height <= 0:
            raise WebPError("demux: invalid simple file")

    def _valid_extended(self):
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames \
                or self.flags & ~ALL_VALID_FLAGS:
            raise WebPError("demux: invalid extended file")
        cw, ch = self.canvas
        for f in self.frames:
            if not is_animation and f.frame_num > 1:
                raise WebPError("demux: several frames in a still file")
            if f.alpha[1] == 0 and f.image[1] == 0:
                raise WebPError("demux: empty frame")
            if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                raise WebPError("demux: ALPH after the image")
            if f.width <= 0 or f.height <= 0:
                raise WebPError("demux: empty frame")
            if not is_animation:
                ok = (f.x, f.y, f.width, f.height) == (0, 0, cw, ch)
            else:
                ok = f.x + f.width <= cw and f.y + f.height <= ch
            if not ok:
                raise WebPError("demux: frame outside the canvas")


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 4) uint8 RGBA, as PIL's `convert("RGBA")`."""
    data = bytes(data)
    try:
        rgbx = not parse_headers(data, False).has_alpha
    except WebPError:
        raise WebPError("could not create decoder object") from None
    dmux = _Demux(data)
    cw, ch = dmux.canvas
    check_pixels(cw, ch)
    f = dmux.frames[0]
    # the frame's payload: from its ALPH chunk (if kept) to its image's end
    start, size = f.image
    if f.alpha[1] > 0:
        inter = f.image[0] - (f.alpha[0] + f.alpha[1]) if f.image[0] > 0 \
            else 0
        start, size = f.alpha[0], size + f.alpha[1] + inter
    frag = data[start:start + size]
    hd = parse_headers(frag, True)
    if (hd.width, hd.height) != (f.width, f.height):
        raise WebPError("frame size differs from the demuxer's")
    canvas = np.zeros((ch, cw, 4), np.uint8)
    out = canvas[f.y:f.y + f.height, f.x:f.x + f.width]
    sub = np.zeros((f.height, f.width, 4), np.uint8)
    lib = library()
    msg = ctypes.create_string_buffer(256)
    payload = frag[hd.offset:]
    if hd.lossless:
        st = lib.kt_vp8l_decode(payload, len(payload), f.width, f.height,
                                sub.ctypes.data, 4 * f.width, msg, len(msg))
    else:
        alph = None if hd.alpha is None else \
            frag[hd.alpha[0]:hd.alpha[0] + hd.alpha[1]]
        st = lib.kt_vp8_decode(payload, len(payload), alph,
                               0 if alph is None else len(alph), f.width,
                               f.height, sub.ctypes.data, 4 * f.width, msg,
                               len(msg))
    if st:
        raise WebPError(f"failed to read next frame: "
                        f"{msg.value.decode('ascii', 'replace')}")
    out[:] = sub
    if rgbx:
        canvas[..., 3] = 255
    return canvas


def encode_vp8l(img: np.ndarray):
    """(H, W, 3) uint8 -> (a lossless WebP, the RGBA it decodes to): one
    VP8L stream with no transform, no colour cache and no backward
    reference; green, red and blue each a complete code of 256 symbols of
    8 bits (symbol s is code s), alpha a one-symbol code (255, no bits)."""
    h, w = img.shape[:2]

    def field(v, n):                 # n bits of v, least significant first
        return [(v >> i) & 1 for i in range(n)]

    def full_code(alphabet):
        # code-length code: symbols 0 and 8 of one bit each (12 lengths in
        # the RFC's order, 8 the 12th), then a length per symbol
        out = [0] + field(12 - 4, 4)
        for sym in (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8):
            out += field(1 if sym in (0, 8) else 0, 3)
        out += [0]                   # lengths for the whole alphabet
        return out + [1] * 256 + [0] * (alphabet - 256)

    bits = field(0x2F, 8) + field(w - 1, 14) + field(h - 1, 14) + [0] + \
        field(0, 3)
    bits += [0, 0, 0]                # no transform, no cache, no meta codes
    bits += full_code(256 + 24) + full_code(256) + full_code(256)
    bits += [1, 0, 1] + field(255, 8)    # alpha: the one symbol 255
    bits += [1, 0, 0, 0]                 # distance: the one symbol 0
    px = np.ascontiguousarray(img[..., [1, 0, 2]]).reshape(-1)   # G, R, B
    stream = np.concatenate([np.array(bits, np.uint8), np.unpackbits(px)])
    payload = np.packbits(stream, bitorder="little").tobytes()
    chunk = b"VP8L" + len(payload).to_bytes(4, "little") + payload + \
        b"\0" * (len(payload) & 1)
    data = b"RIFF" + (4 + len(chunk)).to_bytes(4, "little") + b"WEBP" + chunk
    rgba = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return data, rgba
