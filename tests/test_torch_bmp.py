"""Port parity: BMP, DIB, ICO and CUR textures (`scene/bmp.py`,
`scene/ico.py`) against PIL 12.1.0's `Image.open(f).convert("RGBA")`.

Tolerance: exact everywhere. Each source either decodes to PIL's bytes, or
PIL raises and the port raises an error the bake turns white (OSError or
ValueError), never NotImplementedError. Inputs are made from numpy seeds:
files PIL writes, and hand-built ones for what PIL does not write (every
header size, 1/4/8-bit palettes of colour and of grey, short palettes,
16/24/32 bits, top-down rows, RLE4 / RLE8 streams with deltas, ends of
line and of bitmap and short data, every bitfield layout PIL knows and one
it does not, ICO entries with AND masks and 32-bit alpha, CUR entries). A
hypothesis test cuts and flips bytes. The bake of each format equals JAX's
`build_texture_pages` atlas byte for byte.

The helpers here (`pil_rgba`, `port_rgba`, `assert_as_pil`,
`sweep_outcome`, `assert_bake_matches_jax`) are shared by the TGA, GIF,
WebP, PCX, PPM, SGI, QOI, PSD, BLP and FTEX files."""
import base64
import functools
import io
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from kajiya_tpu_torch.scene import bmp, textures

# cut-and-flip cases per hypothesis test: derandomised, so every run checks
# the same cases
FUZZ = settings(max_examples=60, deadline=None, derandomize=True,
                suppress_health_check=list(HealthCheck))


def uri(data: bytes) -> str:
    return "data:application/octet-stream;base64," + \
        base64.b64encode(data).decode()


def pil_rgba(data: bytes):
    """PIL's RGBA, or None where PIL raises (the JAX bake's white)."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:
        return None


def port_rgba(data: bytes):
    """The port's RGBA through the bake's dispatch, or None where it raises
    what the bake turns white (NotImplementedError propagates)."""
    try:
        return textures._decode_image(uri(data))
    except (OSError, ValueError):
        return None


def assert_as_pil(data: bytes, must_decode: bool = False):
    want, got = pil_rgba(data), port_rgba(data)
    if want is None:
        assert got is None, "PIL refuses, the port decodes"
        assert not must_decode, "PIL refuses a file it should decode"
        return
    assert got is not None, "PIL decodes, the port refuses"
    np.testing.assert_array_equal(got, want)


def assert_as_pil_or_unported(data: bytes):
    """`assert_as_pil`, except where the dispatch reaches a plugin the port
    does not decode (a cut or flipped header can make one accept the
    bytes): then NotImplementedError, naming it."""
    from kajiya_tpu_torch.scene import identify

    try:
        assert_as_pil(data)
    except NotImplementedError as e:
        unported = [f for f in identify.candidates(data)
                    if f not in textures._DECODERS]
        assert unported and unported[0] in str(e)


def sweep_outcome(data: bytes, inner: tuple = ()) -> str:
    """`assert_as_pil_or_unported`, naming the outcome for a sweep's
    count: "pixels" (PIL's bytes), "white" (an error in both) or
    "unported" (NotImplementedError, from an unported plugin that accepts
    the bytes first, or one whose message holds a string of `inner`: an
    unported case inside a ported decoder)."""
    from kajiya_tpu_torch.scene import identify

    try:
        got = port_rgba(data)
    except NotImplementedError as e:
        if not any(k in str(e) for k in inner):
            unported = [f for f in identify.candidates(data)
                        if f not in textures._DECODERS]
            assert unported and unported[0] in str(e), str(e)
        return "unported"
    want = pil_rgba(data)
    if want is None:
        assert got is None, "PIL refuses, the port decodes"
        return "white"
    assert got is not None, "PIL decodes, the port refuses"
    np.testing.assert_array_equal(got, want)
    return "pixels"


def assert_bake_matches_jax(sources):
    """The port's atlas and slot table equal JAX's, byte for byte, and no
    slot is white."""
    from kajiya_tpu.scene import textures as tex_j

    uris = [uri(d) for d in sources]
    atlas_t, sub_t = textures.bake_texture_pages(uris)
    atlas_j, sub_j = tex_j.build_texture_pages(uris)
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    for page, size, ox, oy in sub_t[1:]:
        assert not (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


def pil_saved(img: np.ndarray, fmt: str, mode: str, **kw) -> bytes:
    im = Image.fromarray(img, "RGBA" if img.shape[-1] == 4 else "RGB")
    buf = io.BytesIO()
    im.convert(mode).save(buf, fmt, **kw)
    return buf.getvalue()


def bmp_file(w, h, bits, pix, comp=0, pal=b"", masks=b"", hsize=40,
             colors=0, hmask=None):
    """A BMP with any info header size; `hmask` the bitfields inside a
    header of 52 bytes or more, `masks` those after a 40-byte one."""
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h & 0xFFFF, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bits, comp,
                           len(pix), 0, 0, colors, 0)
        if hmask is not None:
            info += struct.pack("<IIII", *hmask)
        info = info[:hsize] + b"\0" * (hsize - min(len(info), hsize))
    off = 14 + len(info) + len(masks) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + info + \
        masks + pal + pix


def grey_palette(bits, entry):
    n = 1 << bits
    levels = (0, 255) if n == 2 else range(n)
    return b"".join(bytes([v, v, v] + [0] * (entry - 3)) for v in levels)


# ----------------------------------------------------------------------------
# BMP and DIB
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 20)])
def test_pil_written_bmp(mode, size):
    rng = np.random.default_rng(sum(map(ord, mode)) + size[0])
    img = rng.integers(0, 256, size + (4,), np.uint8)
    assert_as_pil(pil_saved(img, "BMP", mode), must_decode=True)
    assert_as_pil(pil_saved(img, "DIB", "RGB"), must_decode=True)


@pytest.mark.parametrize("hsize", [12, 40, 52, 56, 64, 108, 124])
def test_headers_depths_palettes(hsize):
    """Every depth PIL reads under this header size, bottom-up and (with
    a 40+ byte header) top-down, with a colour, a grey and a short
    palette."""
    rng = np.random.default_rng(hsize)
    for w, h in [(7, 5), (1, 1), (33, 4)]:
        for bits in (1, 4, 8, 16, 24, 32):
            stride = ((w * bits + 31) >> 3) & ~3
            pix = rng.integers(0, 256, stride * h, np.uint8).tobytes()
            entry = 3 if hsize == 12 else 4
            pals = [b""]
            if bits <= 8:
                n = 1 << bits
                pals = [rng.integers(0, 256, entry * n, np.uint8).tobytes(),
                        grey_palette(bits, entry),
                        rng.integers(0, 256, entry * max(1, n // 2),
                                     np.uint8).tobytes()]
            for pal in pals:
                for top_down in ((False, True) if hsize > 12 else (False,)):
                    assert_as_pil(bmp_file(w, -h if top_down else h, bits,
                                           pix, pal=pal, hsize=hsize))


def _rle_stream(rng, w, h, rle4):
    """A random RLE stream: encoded runs, absolute runs (padded to 16
    bits), deltas, a run past the row's end, ends of line, end of
    bitmap."""
    out = b""
    for _ in range(h):
        x = 0
        while x < w:
            r = rng.random()
            if r < 0.4:
                k = int(rng.integers(1, w - x + 1))
                out += bytes([k, int(rng.integers(0, 256))])
            elif r < 0.7 and w - x >= 3:
                k = int(rng.integers(3, min(w - x, 40) + 1))
                nb = (k + 1) // 2 if rle4 else k
                out += bytes([0, k]) + rng.integers(0, 256, nb,
                                                    np.uint8).tobytes()
                out += b"\0" if nb % 2 else b""
            elif r < 0.75:
                k = 1
                out += bytes([0, 2, int(rng.integers(0, 3)),
                              int(rng.integers(0, 2))])
            elif r < 0.8:
                k = w
                out += bytes([int(rng.integers(w - x, 255)), 7])
            else:
                k = int(rng.integers(1, 5))
                out += bytes([k, int(rng.integers(0, 256))])
            x += k
        out += b"\0\0"
    return out + b"\0\1"


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("case", ["colour", "grey", "short", "top_down",
                                  "no_end"])
def test_rle(rle4, case):
    rng = np.random.default_rng(int(rle4) * 10 + len(case))
    bits = 4 if rle4 else 8
    for w, h in [(7, 5), (20, 6), (3, 1), (64, 9)]:
        pix = _rle_stream(rng, w, h, rle4)
        pal = grey_palette(bits, 4) if case == "grey" else \
            rng.integers(0, 256, 4 << bits, np.uint8).tobytes()
        if case == "short":
            pix = pix[:int(rng.integers(1, len(pix)))]
        if case == "no_end":
            pix = pix[:-2]
        assert_as_pil(bmp_file(w, -h if case == "top_down" else h, bits,
                               pix, comp=2 if rle4 else 1, pal=pal))


@pytest.mark.parametrize("mask", [
    (32, 0xFF0000, 0xFF00, 0xFF, 0x0), (32, 0xFF000000, 0xFF0000, 0xFF00, 0),
    (32, 0xFF000000, 0xFF00, 0xFF, 0x0),
    (32, 0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (32, 0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    (32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (32, 0xFF000000, 0xFF00, 0xFF, 0xFF0000), (32, 0, 0, 0, 0),
    (24, 0xFF0000, 0xFF00, 0xFF, 0), (16, 0xF800, 0x7E0, 0x1F, 0),
    (16, 0x7C00, 0x3E0, 0x1F, 0), (16, 0xF0, 0xF, 0xF00, 0),
    (8, 0xE0, 0x1C, 0x3, 0)], ids=lambda m: "-".join(map(hex, m)))
@pytest.mark.parametrize("hsize", [40, 56, 108])
def test_bitfields(mask, hsize):
    """Every layout of PIL's MASK_MODES decodes as PIL's; others are PIL's
    OSError (white)."""
    bits, *m = mask
    rng = np.random.default_rng(bits + hsize)
    w, h = 9, 4
    stride = ((w * bits + 31) >> 3) & ~3
    pix = rng.integers(0, 256, stride * h, np.uint8).tobytes()
    if hsize == 40:
        data = bmp_file(w, h, bits, pix, comp=3,
                        masks=struct.pack("<III", *m[:3]))
    else:
        data = bmp_file(w, h, bits, pix, comp=3, hsize=hsize, hmask=m)
    assert_as_pil(data)


@pytest.mark.parametrize("case", ["jpeg", "png", "comp6", "bits2", "hsize20",
                                  "colors300", "width0", "truncated"])
def test_refused_layouts_bake_white(case):
    """What PIL refuses: white in both packages' bakes (width 0 is a
    refusal at open, with no other plugin after it)."""
    rng = np.random.default_rng(1)
    pix = rng.integers(0, 256, 24 * 5, np.uint8).tobytes()
    pal = rng.integers(0, 256, 1200, np.uint8).tobytes()
    data = {
        "jpeg": bmp_file(7, 5, 24, pix, comp=4),
        "png": bmp_file(7, 5, 24, pix, comp=5),
        "comp6": bmp_file(7, 5, 24, pix, comp=6),
        "bits2": bmp_file(7, 5, 2, pix, pal=pal[:16]),
        "hsize20": b"BM" + struct.pack("<IHHI", 80, 0, 0, 34) +
        struct.pack("<I", 20) + bytes(16) + pix,
        "colors300": bmp_file(7, 5, 8, pix, pal=pal, colors=300),
        "width0": bmp_file(0, 5, 24, pix),
        "truncated": bmp_file(7, 5, 24, pix)[:100],
    }[case]
    assert pil_rgba(data) is None
    assert port_rgba(data) is None
    from kajiya_tpu.scene import textures as tex_j

    atlas_t, sub_t = textures.bake_texture_pages([uri(data)])
    np.testing.assert_array_equal(
        atlas_t, np.asarray(tex_j.build_texture_pages([uri(data)])[0]))
    page, size, ox, oy = sub_t[1]
    assert (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


# ----------------------------------------------------------------------------
# ICO and CUR
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGBA", "RGB", "P", "L", "1"])
@pytest.mark.parametrize("fmt", ["png", "bmp"])
def test_pil_written_ico(mode, fmt):
    rng = np.random.default_rng(len(mode) + len(fmt))
    img = rng.integers(0, 256, (48, 48, 4), np.uint8)
    data = pil_saved(img, "ICO", mode, sizes=[(16, 16), (32, 32), (48, 48)],
                     bitmap_format=fmt)
    assert_as_pil(data, must_decode=True)


def _dib(w, h, bits, pix, pal=b""):
    return struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, len(pix), 0, 0,
                       0, 0) + pal + pix


def _entry(w, h, bpp, size, offset):
    return struct.pack("<BBBBHHII", w, h, 0, 0, 1, bpp, size, offset)


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("entry_bpp", ["same", "32", "0"])
def test_ico_bitmap_entries(bits, entry_bpp):
    """A DIB entry at half its height, its alpha from the AND mask below 32
    bits in the directory (or from the pixels' fourth bytes at 32); a
    second, smaller entry that the sort puts after the first."""
    rng = np.random.default_rng(bits)
    w, h = 13, 9
    stride = ((w * bits + 31) >> 3) & ~3
    pix = rng.integers(0, 256, stride * h, np.uint8).tobytes()
    pal = rng.integers(0, 256, 4 << bits, np.uint8).tobytes() \
        if bits <= 8 else b""
    andm = rng.integers(0, 256, ((w + 31) // 32) * 4 * h, np.uint8).tobytes()
    body = _dib(w, 2 * h, bits, pix, pal) + andm
    small = _dib(4, 8, 24, rng.integers(0, 256, 12 * 8, np.uint8).tobytes())
    bpp = {"same": bits, "32": 32, "0": 0}[entry_bpp]
    data = b"\0\0\1\0" + struct.pack("<H", 2) + \
        _entry(4, 4, 24, len(small), 38 + len(body)) + \
        _entry(w, h, bpp, len(body), 38) + body + small
    # a 32-bit entry over a DIB of 8 bits or fewer has too few alpha bytes:
    # PIL raises (white)
    assert_as_pil(data, must_decode=bits >= 24 or bpp != 32)


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_cur(bits):
    """CUR keeps its first entry unless a later one is wider and taller;
    the bitmap at the entry's offset (32-bit BI_RGB at offset 22 read with
    its alpha) at half its height."""
    rng = np.random.default_rng(bits + 100)
    w, h = 13, 9
    stride = ((w * bits + 31) >> 3) & ~3
    pix = rng.integers(0, 256, stride * h * 2, np.uint8).tobytes()
    pal = rng.integers(0, 256, 4 << bits, np.uint8).tobytes() \
        if bits <= 8 else b""
    body = _dib(w, 2 * h, bits, pix, pal)
    for entries in ([(w, h)], [(w, h), (w + 2, h + 2), (w - 1, h + 5)],
                    [(w + 2, h), (w, h)]):
        off = 6 + 16 * len(entries)
        data = b"\0\0\2\0" + struct.pack("<H", len(entries)) + b"".join(
            _entry(ew, eh, bits, len(body), off) for ew, eh in entries) + \
            body
        assert_as_pil(data, must_decode=True)


def test_cur_without_entries_is_refused():
    """No entry: CUR's refusal, and no other plugin takes the bytes."""
    data = b"\0\0\2\0\0\0" + bytes(range(5, 45))
    assert pil_rgba(data) is None and port_rgba(data) is None


# ----------------------------------------------------------------------------
# corrupt streams and the bake
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fuzz_base():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (12, 17, 4), np.uint8)
    return [pil_saved(img, "BMP", "RGB"), pil_saved(img, "BMP", "P"),
            bmp_file(17, 12, 8, _rle_stream(rng, 17, 12, False), comp=1,
                     pal=rng.integers(0, 256, 1024, np.uint8).tobytes()),
            bmp_file(17, 12, 4, _rle_stream(rng, 17, 12, True), comp=2,
                     pal=rng.integers(0, 256, 64, np.uint8).tobytes()),
            pil_saved(img, "ICO", "RGBA", sizes=[(16, 16)],
                      bitmap_format="bmp"),
            pil_saved(img, "ICO", "RGBA", sizes=[(16, 16)])]



@FUZZ
@given(st.data())
def test_corrupt_streams_as_pil(data):
    """Cut or flipped bytes: the port gives PIL's bytes, or raises where PIL
    raises (white through the bake)."""
    # the base files are made on first use: PIL writing at import would
    # register its plugins in another order than the other test modules see
    src = bytearray(_fuzz_base()[data.draw(st.integers(0, 5))])
    if data.draw(st.booleans()):
        src = src[:data.draw(st.integers(0, len(src)))]
    else:
        for _ in range(data.draw(st.integers(1, 4))):
            i = data.draw(st.integers(0, len(src) - 1))
            src[i] ^= 1 << data.draw(st.integers(0, 7))
    assert_as_pil_or_unported(bytes(src))


def test_bake_matches_jax():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (40, 56, 4), np.uint8)
    assert_bake_matches_jax([
        pil_saved(img, "BMP", "RGB"), pil_saved(img, "DIB", "RGB"),
        pil_saved(img, "ICO", "RGBA", sizes=[(32, 32)]),
        b"\0\0\2\0" + struct.pack("<H", 1) + _entry(13, 9, 24, 0, 22) +
        _dib(13, 18, 24, rng.integers(0, 256, 40 * 18, np.uint8).tobytes()),
        bmp_file(20, 6, 8, _rle_stream(rng, 20, 6, False), comp=1,
                 pal=rng.integers(0, 256, 1024, np.uint8).tobytes())])


def test_writer_decodes_to_its_texels():
    """`bmp.encode_bmp24` (the legacy city's normal maps): PIL and the port
    both decode it to the texels it reports."""
    img = np.random.default_rng(3).integers(0, 256, (37, 29, 3), np.uint8)
    data, want = bmp.encode_bmp24(img)
    np.testing.assert_array_equal(pil_rgba(data), want)
    np.testing.assert_array_equal(bmp.decode_bmp(data), want)
