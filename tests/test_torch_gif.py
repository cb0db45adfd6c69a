"""Port parity: GIF textures (`scene/gif.py`, the LZW loop in
`csrc/raster_decoder.cpp`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")` of the first frame.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises). Inputs from numpy
seeds: files PIL writes (interlaced and not, 2 to 256 colours, a
transparency index, grey and RGB sources), and hand-built ones: a local
table, a short one, a grey one (mode "L"), no table, a frame smaller than
the logical screen or reaching past it, comment and application
extensions, stray bytes between blocks, and LZW streams from this file's
own encoder: initial code sizes 1 to 8, clear codes and deferred clears (a
full 4096-entry table that stops growing), the code that is the next
entry, an end code before the frame is full, codes past the table and a
code size PIL refuses. A hypothesis test cuts and flips bytes."""
import functools
import io
import struct

import numpy as np
import pytest
from hypothesis import given
from hypothesis import strategies as st
from PIL import Image

from kajiya_tpu_torch.scene import gif
from test_torch_bmp import (FUZZ, assert_as_pil, assert_as_pil_or_unported,
                            assert_bake_matches_jax, pil_rgba, pil_saved,
                            port_rgba)


def lzw(indices, min_size, clear_every=None, clear_when_full=False,
        end=True, extra_codes=()):
    """GIF LZW codes of `indices` (a greedy encoder whose code size follows
    the decoder's: it grows after the entry 2^size - 1 is added, and stays
    at 12 bits once the table is full), packed into sub-blocks."""
    clear_code, end_code = 1 << min_size, (1 << min_size) + 1
    bits, nbits = 0, 0
    out = bytearray()
    state = {}

    def emit(code):
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += state["size"]
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8
        if code == clear_code:
            reset()
            return
        if state["first"]:
            state["first"] = False
        elif state["next"] < 4096:
            if state["next"] == (1 << state["size"]) - 1 and \
                    state["size"] < 12:
                state["size"] += 1
            state["next"] += 1

    def reset():
        state.update(size=min_size + 1, next=clear_code + 2, first=True,
                     table={}, enc_next=clear_code + 2)

    state["size"] = min_size + 1
    emit(clear_code)
    prefix, since_clear = None, 0
    for k in indices:
        k = int(k)
        if prefix is None:
            prefix = k
            continue
        if (prefix, k) in state["table"]:
            prefix = state["table"][(prefix, k)]
            continue
        emit(prefix)
        since_clear += 1
        if state["enc_next"] < 4096:
            state["table"][(prefix, k)] = state["enc_next"]
            state["enc_next"] += 1
        elif clear_when_full:
            emit(clear_code)
        if clear_every and since_clear >= clear_every:
            emit(clear_code)
            since_clear = 0
        prefix = k
    if prefix is not None:
        emit(prefix)
    for c in extra_codes:
        emit(c)
    if end:
        emit(end_code)
    if nbits:
        out.append(bits & 255)
    data = bytes(out)
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_file(screen, frame, data, palette=None, local=None, min_size=8,
             interlace=False, gce=None, pre=b"", trailer=b";"):
    """A GIF89a: logical screen `screen` (w, h), a global table `palette`
    (bytes, 2^n entries) or none, extension bytes `pre`, a graphic-control
    extension with transparency index `gce`, and one image descriptor at
    `frame` (x, y, w, h) with a local table `local`."""
    def table_bits(p):
        return (len(p) // 3).bit_length() - 2

    flags = 0x80 | table_bits(palette) if palette else 0
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0)
    out += palette or b""
    out += pre
    if gce is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 10, gce) + b"\0"
    lflags = (0x40 if interlace else 0) | \
        (0x80 | table_bits(local) if local else 0)
    out += b"," + struct.pack("<HHHHB", *frame, lflags) + (local or b"")
    return out + bytes([min_size]) + data + trailer


def random_palette(rng, n):
    return rng.integers(0, 256, 3 * n, np.uint8).tobytes()


@pytest.mark.parametrize("ncolors", [2, 5, 16, 256])
@pytest.mark.parametrize("interlace", [False, True], ids=["rows",
                                                          "interlaced"])
@pytest.mark.parametrize("transparency", [False, True],
                         ids=["opaque", "transparent"])
def test_pil_written(ncolors, interlace, transparency):
    rng = np.random.default_rng(ncolors + 2 * interlace + transparency)
    for h, w in [(20, 17), (64, 40), (1, 1), (9, 300)]:
        idx = rng.integers(0, ncolors, (h, w)).astype(np.uint8)
        im = Image.fromarray(idx, "P")
        im.putpalette(random_palette(rng, ncolors))
        kw = dict(interlace=interlace)
        if transparency:
            kw["transparency"] = int(idx[0, 0])
        buf = io.BytesIO()
        im.save(buf, "GIF", **kw)
        assert_as_pil(buf.getvalue(), must_decode=True)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "1"])
def test_pil_written_other_modes(mode):
    rng = np.random.default_rng(len(mode))
    img = rng.integers(0, 256, (21, 34, 4), np.uint8)
    assert_as_pil(pil_saved(img, "GIF", mode), must_decode=True)


@pytest.mark.parametrize("case", ["local", "local_over_global", "grey_local",
                                  "grey_global", "none", "short_global",
                                  "short_local", "index_past_table"])
def test_colour_tables(case):
    """The local table wins over the global one; an identity grey table (or
    none) leaves mode "L", yet a grey local table takes the colours of a
    global one; a table the file cuts short is PIL's refusal."""
    rng = np.random.default_rng(len(case))
    w, h = 23, 11
    ncol = 16
    idx = rng.integers(0, 256 if case == "index_past_table" else ncol,
                       (h, w))
    grey = bytes(np.repeat(np.arange(ncol, dtype=np.uint8), 3))
    pal, local = {
        "local": (None, random_palette(rng, ncol)),
        "local_over_global": (random_palette(rng, ncol),
                              random_palette(rng, ncol)),
        "grey_local": (random_palette(rng, ncol), grey),
        "grey_global": (grey, None),
        "none": (None, None),
        "short_global": (random_palette(rng, ncol), None),
        "short_local": (None, random_palette(rng, ncol)),
        "index_past_table": (random_palette(rng, ncol), None),
    }[case]
    data = gif_file((w, h), (0, 0, w, h), lzw(idx.reshape(-1), 8), pal,
                    local)
    if case.startswith("short"):
        data = data[:13 + (len(pal) // 2 if pal else 10)]
    assert_as_pil(data, must_decode=not case.startswith("short"))


@pytest.mark.parametrize("case", ["inside", "inside_transparent", "beyond",
                                  "beyond_transparent", "interlaced_inside"])
def test_frame_placement(case):
    """A frame smaller than the screen sits at its offset over index 0 (or
    over the transparency index); one reaching past it grows the image."""
    rng = np.random.default_rng(len(case) + 50)
    fw, fh = 9, 7
    idx = rng.integers(0, 16, (fh, fw))
    screen = (20, 15) if "inside" in case else (6, 5)
    offset = (4, 3) if "inside" in case else (2, 1)
    data = gif_file(screen, (*offset, fw, fh), lzw(idx.reshape(-1), 8),
                    random_palette(rng, 16),
                    gce=5 if "transparent" in case else None,
                    interlace="interlaced" in case)
    assert_as_pil(data, must_decode=True)


@pytest.mark.parametrize("case", ["comment", "netscape", "unknown_ext",
                                  "stray", "two_gce", "no_frame",
                                  "gce_short"])
def test_blocks_before_the_frame(case):
    rng = np.random.default_rng(len(case) + 70)
    w, h = 12, 8
    idx = rng.integers(0, 4, (h, w))
    pre = {
        "comment": b"!\xfe\x05hello\x03abc\0",
        "netscape": b"!\xff\x0bNETSCAPE2.0\x03\x01\x05\x00\0",
        "unknown_ext": b"!\x42\x02ab\x01c\0",
        "stray": b"\x00\x7f\x13",
        "two_gce": b"!\xf9\x04\x01\x00\x00\x02\0",
        "no_frame": b"",
        "gce_short": b"!\xf9\x02\x01\x00\0",
    }[case]
    data = gif_file((w, h), (0, 0, w, h), lzw(idx.reshape(-1), 2),
                    random_palette(rng, 4), pre=pre, min_size=2,
                    gce=3 if case == "two_gce" else None)
    if case == "no_frame":
        data = data[:13 + 12] + b";"
    assert_as_pil(data, must_decode=case not in ("no_frame", "gce_short"))


@pytest.mark.parametrize("min_size", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("clears", ["none", "every_100", "when_full",
                                    "deferred"])
def test_lzw(min_size, clears):
    """Initial code sizes 1 to 8; codes from 3 to 12 bits; the table full
    at 4096 entries, with a clear code then or none (a deferred clear).
    At size 1 PIL's decoder never grows its 2-bit codes (its first free
    entry, 4, is past the 2-bit mask), so such a stream fails in both."""
    rng = np.random.default_rng(min_size * 10 + len(clears))
    ncol = 1 << min_size
    # long runs and repeats grow the table fast; noise fills it
    w, h = 150, 120
    idx = np.repeat(rng.integers(0, ncol, w * h // 3), 3)
    idx[::7] = rng.integers(0, ncol, idx[::7].shape)
    data = gif_file((w, h), (0, 0, w, h),
                    lzw(idx, min_size,
                        clear_every=100 if clears == "every_100" else None,
                        clear_when_full=clears == "when_full"),
                    random_palette(rng, max(ncol, 2)), min_size=min_size,
                    interlace=bool(min_size & 1))
    assert_as_pil(data, must_decode=min_size >= 2)


@pytest.mark.parametrize("case", ["early_end", "past_table", "first_not_lit",
                                  "bits13", "bits0", "truncated",
                                  "zero_block", "no_trailer"])
def test_lzw_errors(case):
    """An end code or empty block before the frame is full and a stream cut
    short are PIL's truncation; a code past the table is PIL's broken
    stream; 13 bits PIL refuses. Each white in both; a missing trailer is
    no error."""
    rng = np.random.default_rng(len(case) + 90)
    w, h = 16, 10
    idx = rng.integers(0, 16, (h, w)).reshape(-1)
    min_size = 13 if case == "bits13" else 0 if case == "bits0" else 4
    stream = {
        "early_end": lzw(idx[:50], 4),
        "past_table": lzw(idx[:40], 4, end=False, extra_codes=(31,)),
        "first_not_lit": lzw([], 4, end=False, extra_codes=(20, 1, 2)),
        "bits13": lzw(idx, 4),
        "bits0": lzw(idx % 2, 4),
        "truncated": lzw(idx, 4)[:20],
        "zero_block": lzw(idx[:60], 4, end=False)[:-1] + b"\0",
        "no_trailer": lzw(idx, 4),
    }[case]
    data = gif_file((w, h), (0, 0, w, h), stream, random_palette(rng, 16),
                    min_size=min_size,
                    trailer=b"" if case == "no_trailer" else b";")
    assert_as_pil(data, must_decode=case == "no_trailer")


@functools.lru_cache(maxsize=None)
def _fuzz_base():
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (14, 19, 4), np.uint8)
    idx = rng.integers(0, 16, (9, 12))
    return [pil_saved(img, "GIF", "RGB"), pil_saved(img, "GIF", "L"),
            gif_file((15, 12), (2, 1, 12, 9), lzw(idx.reshape(-1), 4),
                     random_palette(rng, 16), min_size=4, gce=3,
                     interlace=True)]



@FUZZ
@given(st.data())
def test_corrupt_streams_as_pil(data):
    """Cut or flipped bytes: PIL's bytes, or an error where PIL raises."""
    # the base files are made on first use: PIL writing at import would
    # register its plugins in another order than the other test modules see
    src = bytearray(_fuzz_base()[data.draw(st.integers(0, 2))])
    if data.draw(st.booleans()):
        src = src[:data.draw(st.integers(0, len(src)))]
    else:
        for _ in range(data.draw(st.integers(1, 4))):
            i = data.draw(st.integers(0, len(src) - 1))
            src[i] ^= 1 << data.draw(st.integers(0, 7))
    assert_as_pil_or_unported(bytes(src))


def test_bake_matches_jax():
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (50, 70, 4), np.uint8)
    idx = rng.integers(0, 64, (30, 40))
    assert_bake_matches_jax([
        pil_saved(img, "GIF", "RGB"), pil_saved(img, "GIF", "L"),
        gif_file((45, 35), (3, 2, 40, 30), lzw(idx.reshape(-1), 6),
                 random_palette(rng, 64), min_size=6, gce=7,
                 interlace=True)])


def test_writer_decodes_to_its_texels():
    """`gif.encode_gif256` (the legacy city's metallic-roughness maps):
    PIL and the port both decode it to the texels it reports, a source of
    at most 256 colours exactly, a noisy one quantised."""
    rng = np.random.default_rng(15)
    few = rng.integers(0, 256, (200, 3), np.uint8)[rng.integers(0, 200,
                                                               (61, 77))]
    noisy = rng.integers(0, 256, (40, 33, 3), np.uint8)
    for img in (few, noisy):
        data, want = gif.encode_gif256(img)
        np.testing.assert_array_equal(pil_rgba(data), want)
        np.testing.assert_array_equal(port_rgba(data), want)
    np.testing.assert_array_equal(gif.encode_gif256(few)[1][..., :3], few)
