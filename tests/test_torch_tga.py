"""Port parity: TGA textures (`scene/tga.py`) against PIL 12.1.0's
`Image.open(f).convert("RGBA")`, and the dispatch's plugin fall-through.

Tolerance: exact everywhere (the helpers of test_torch_bmp.py: PIL's bytes,
or an error the bake turns white where PIL raises). Inputs from numpy
seeds: files PIL writes (with and without RLE), and hand-built ones for
what PIL does not write: image types 1, 2, 3, 9, 10 and 11 at depths 1, 8,
16, 24 and 32 (the pairs PIL has no decoder for included), colour maps of
15-, 16-, 24- and 32-bit entries with a first-entry offset and short ones,
the id field, all four orientations, RLE packets that run across rows.
A TGA as PIL writes it starts `00 00 02 00`, which CUR's rule accepts too:
CUR's `_open` refuses it and the TGA plugin reads it, in PIL and in the
port. Where an unported plugin stands first (PCX, IPTC, GBR), the port
raises NotImplementedError (the cases `scene/identify.py` lists)."""
import functools
import struct

import numpy as np
import pytest
from hypothesis import given
from hypothesis import strategies as st

from kajiya_tpu_torch.scene import identify, tga, textures
from test_torch_bmp import (FUZZ, assert_as_pil, assert_as_pil_or_unported,
                            assert_bake_matches_jax, pil_rgba, pil_saved,
                            port_rgba, uri)


def tga_file(w, h, itype, depth, pix, cmap=(0, 0, 0), cmap_data=b"",
             idlen=0, flags=0, cmt=None):
    if cmt is None:
        cmt = 1 if cmap[1] else 0
    head = struct.pack("<BBBHHBHHHHBB", idlen, cmt, itype, cmap[0], cmap[1],
                       cmap[2], 0, 0, w, h, depth, flags)
    return head + bytes(range(idlen)) + cmap_data + pix


def rle_packets(rng, n_pixels, bpp, across_rows=True, w=None):
    """Random run and literal packets for `n_pixels` pixels of `bpp`
    bytes; runs kept inside rows unless `across_rows`."""
    out, n = b"", 0
    while n < n_pixels:
        left = n_pixels - n
        if not across_rows:
            left = min(left, w - n % w)
        if rng.random() < 0.5:
            k = int(rng.integers(1, min(left, 128) + 1))
            out += bytes([0x80 | (k - 1)]) + rng.integers(
                0, 256, bpp, np.uint8).tobytes()
        else:
            k = int(rng.integers(1, min(n_pixels - n, 128) + 1))
            out += bytes([k - 1]) + rng.integers(0, 256, bpp * k,
                                                 np.uint8).tobytes()
        n += k
    return out


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P", "1"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_pil_written(mode, rle):
    rng = np.random.default_rng(len(mode) + rle)
    img = rng.integers(0, 256, (9, 13, 4), np.uint8)
    data = pil_saved(img, "TGA", mode, rle=rle)
    # PIL writes a 1-bit RLE file that its reader cannot expand (white)
    assert_as_pil(data, must_decode=not (mode == "1" and rle))


@pytest.mark.parametrize("itype", [1, 2, 3, 9, 10, 11])
@pytest.mark.parametrize("depth", [1, 8, 16, 24, 32])
def test_types_depths_orientations(itype, depth):
    """Every orientation, with no colour map and with maps of each entry
    size (offset, full, short), and an id field."""
    rng = np.random.default_rng(itype * 40 + depth)
    w, h = 7, 5
    bpp = depth // 8
    for flags in (0, 0x10, 0x20, 0x30, 0x28):
        if itype & 8:
            pix = rle_packets(rng, w * h, bpp, across_rows=False, w=w)
        else:
            pix = rng.integers(0, 256, ((w * depth + 7) // 8) * h,
                               np.uint8).tobytes()
        for cmap in [(0, 0, 0), (3, 40, 24), (0, 256, 16), (2, 30, 32),
                     (0, 10, 15), (0, 4, 24)]:
            cd = rng.integers(0, 256, cmap[1] * ((cmap[2] + 7) // 8),
                              np.uint8).tobytes()
            for idlen in (0, 3):
                assert_as_pil(tga_file(w, h, itype, depth, pix, cmap, cd,
                                       idlen=idlen, flags=flags))


@pytest.mark.parametrize("case", ["literal_across", "run_across", "one_run",
                                  "past_end", "short"])
@pytest.mark.parametrize("depth", [8, 16, 24, 32])
def test_rle_across_rows(case, depth):
    """A literal packet runs on into the next row and data past the image
    is ignored (PIL decodes both); a run that passes its row's end is PIL's
    overrun, and data that ends first is truncation (both white)."""
    rng = np.random.default_rng(depth + len(case))
    w, h, bpp = 7, 5, depth // 8
    px = lambda k: rng.integers(0, 256, bpp * k, np.uint8).tobytes()  # noqa
    pix = {
        "literal_across": bytes([9]) + px(10) + bytes([24]) + px(25),
        "run_across": bytes([0x89]) + px(1) + bytes([0x98]) + px(1),
        "one_run": bytes([0x80 | 34]) + px(1),
        "past_end": bytes([127]) + px(128),
        "short": bytes([20]) + px(12),
    }[case]
    itype = 10 if depth in (16, 24, 32) else 11
    assert_as_pil(tga_file(w, h, itype, depth, pix, flags=0x20),
                  must_decode=case in ("literal_across", "past_end"))


def test_pil_tga_bakes_through_cur():
    """PIL's TGA writer starts `00 00 02 00`: CUR's rule accepts it, CUR's
    `_open` finds no cursor and refuses, and the TGA plugin decodes it, in
    PIL and in the port's bake (equal to JAX's)."""
    img = np.random.default_rng(5).integers(0, 256, (24, 40, 4), np.uint8)
    data = pil_saved(img, "TGA", "RGBA")
    assert data[:4] == b"\0\0\2\0"
    assert identify.candidates(data) == ["CUR", "TGA"]
    assert_as_pil(data, must_decode=True)
    assert_bake_matches_jax([data, pil_saved(img, "TGA", "RGB")])


@pytest.mark.parametrize("case", ["pcx", "iptc", "gbr"])
def test_unported_plugin_first_raises(case):
    """The refusal cases of `scene/identify.py`: an unported plugin that
    PIL's order tries first makes the port raise NotImplementedError, never
    white, whatever PIL's own `_open` of that plugin then does."""
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 256, 64 * 4, np.uint8).tobytes()
    data = {
        "pcx": tga_file(8, 8, 2, 32, pix, idlen=10),
        "iptc": tga_file(8, 8, 1, 8, pix[:64], (0, 256, 24),
                         rng.integers(0, 256, 768, np.uint8).tobytes(),
                         idlen=28),
        "gbr": b"\0\0\1\0\0\0\0\1" + pix,
    }[case]
    assert identify.candidates(data)[0] == case.upper()
    with pytest.raises(NotImplementedError, match=case.upper()):
        textures._decode_image(uri(data))


@functools.lru_cache(maxsize=None)
def _fuzz_base():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (11, 17, 4), np.uint8)
    return [pil_saved(img, "TGA", "RGBA"), pil_saved(img, "TGA", "RGB",
                                                     rle=True),
            pil_saved(img, "TGA", "P", rle=True),
            tga_file(17, 11, 10, 16, rle_packets(rng, 17 * 11, 2),
                     flags=0x30)]



@FUZZ
@given(st.data())
def test_corrupt_streams_as_pil(data):
    """Cut or flipped bytes: PIL's bytes, or an error where PIL raises."""
    # the base files are made on first use: PIL writing at import would
    # register its plugins in another order than the other test modules see
    src = bytearray(_fuzz_base()[data.draw(st.integers(0, 3))])
    if data.draw(st.booleans()):
        src = src[:data.draw(st.integers(0, len(src)))]
    else:
        for _ in range(data.draw(st.integers(1, 4))):
            i = data.draw(st.integers(0, len(src) - 1))
            src[i] ^= 1 << data.draw(st.integers(0, 7))
    assert_as_pil_or_unported(bytes(src))


def test_bake_matches_jax():
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (30, 50, 4), np.uint8)
    assert_bake_matches_jax([
        pil_saved(img, "TGA", "RGBA", rle=True),
        pil_saved(img, "TGA", "LA"),
        tga_file(50, 30, 9, 8, rle_packets(rng, 1500, 1, False, 50),
                 (5, 200, 16),
                 rng.integers(0, 256, 400, np.uint8).tobytes(), idlen=4,
                 flags=0x10)])


def test_writer_decodes_to_its_texels():
    """`tga.encode_tga_rle` (the legacy city's base colour maps): PIL and
    the port both decode it to the texels it reports."""
    rng = np.random.default_rng(4)
    img = np.repeat(rng.integers(0, 256, (19, 80, 3), np.uint8), 3, 1)
    img[::4] = rng.integers(0, 256, img[::4].shape, np.uint8)
    data, want = tga.encode_tga_rle(img)
    np.testing.assert_array_equal(pil_rgba(data), want)
    np.testing.assert_array_equal(port_rgba(data), want)
