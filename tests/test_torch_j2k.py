"""Port parity for JPEG 2000 (`kajiya_tpu_torch/scene/j2k.py` over
`csrc/j2k_decoder.cpp`): J2K codestreams and JP2 files decode to PIL
12.1.0's `Image.open(f).convert("RGBA")` over OpenJPEG 2.5.4, byte for
byte (tolerance 0), in every mode PIL writes (L, LA, RGB, RGBA, I;16,
CMYK, sYCC), reversible and irreversible, with every option PIL's writer
takes (resolutions, tiles and offsets, layers, the five progressions with
and without precincts, code-block sizes, mct, signed, PLT, a comment) and
odd sizes. Files PIL cannot write are built here from PIL's: each Part 1
code-block style set over PIL's data, SOP / EPH markers, PPT and PPM
packet headers (packets located by the decoder's own spans), JP2 headers
of every (components, colour space, codestream) combination, subsampled
components, `pclr` palettes. The seeded cut-and-flip sweeps (300 files
each: lossless and 9/7 codestreams, JP2 files) and a sweep of the main
header's SIZ, COD and QCD bytes give PIL's pixels, white in both, or
NotImplementedError (bounded); never other pixels. The decoder's output
does not depend on its thread count."""
import collections
import io
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import j2k
from test_torch_bmp import assert_bake_matches_jax, sweep_outcome


def pil_j2k(img: np.ndarray, mode: str, **kw) -> bytes:
    """PIL's JPEG 2000 file of an (H, W, 3 or 4) uint8 image in `mode`
    (a JP2 file unless no_jp2)."""
    src = Image.fromarray(img[..., :3] if mode in ("RGB", "YCbCr", "L")
                          else img)
    buf = io.BytesIO()
    src.convert(mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def picture(seed: int, h: int, w: int) -> np.ndarray:
    """Noise over a smooth ramp, with a flat band (every coding pass and
    run-length mode meets it)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 5, y * 7, (x + y) * 3, 255 - x * 2], -1) % 256
    img = (img + rng.integers(0, 48, (h, w, 4))).astype(np.uint8)
    img[: h // 4] = 90
    return img


def _outcome(data: bytes) -> str:
    return sweep_outcome(data, ("JPEG 2000",))


def assert_pixels(data: bytes) -> None:
    assert _outcome(data) == "pixels"


# ----------------------------------------------------------------------------
# what PIL writes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("no_jp2", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "CMYK", "YCbCr"])
def test_modes(mode, irreversible, no_jp2):
    """Every mode PIL writes; YCbCr is written as sYCC and read back as
    RGB through PIL's YCbCr conversion, CMYK converts as PIL's CMYK does
    (a raw codestream reads it as RGBA)."""
    assert_pixels(pil_j2k(picture(1, 37, 29), mode, irreversible=irreversible,
                          no_jp2=no_jp2))


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("no_jp2", [True, False], ids=["j2k", "jp2"])
def test_sixteen_bit_grey(no_jp2, irreversible):
    """I;16: PIL shifts the samples to 16 bits and clamps at 255."""
    img = np.random.default_rng(2).integers(0, 65536, (21, 33)).astype(
        "<u2")
    buf = io.BytesIO()
    Image.frombuffer("I;16", (33, 21), img.tobytes()).save(
        buf, "JPEG2000", no_jp2=no_jp2, irreversible=irreversible)
    assert_pixels(buf.getvalue())


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("levels", range(1, 8))
def test_resolutions(levels, irreversible):
    """num_resolutions from 1 to the most 70 x 90 allows."""
    assert_pixels(pil_j2k(picture(3, 70, 90), "RGB", num_resolutions=levels,
                          irreversible=irreversible))


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("tile,tile_offset,offset", [
    ((32, 32), (0, 0), (0, 0)), ((24, 40), (3, 5), (7, 9)),
    ((16, 16), (0, 0), (5, 3)), ((40, 24), (10, 2), (15, 11))])
def test_tiles_and_offsets(tile, tile_offset, offset, irreversible):
    """Tiles, a tile grid offset and an image offset: each tile lands at
    its place less the image's origin, with its own sample parity."""
    assert_pixels(pil_j2k(picture(4, 70, 90), "RGBA", tile_size=tile,
                          tile_offset=tile_offset, offset=offset,
                          irreversible=irreversible))


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("quality", [("rates", [40, 20, 10]),
                                     ("dB", [20, 30, 40])])
def test_quality_layers(quality, irreversible):
    """Three quality layers: code-blocks included over several layers,
    their segments in chunks."""
    assert_pixels(pil_j2k(picture(5, 70, 90), "RGB", quality_mode=quality[0],
                          quality_layers=quality[1],
                          irreversible=irreversible))


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("precinct", [None, (32, 64), (64, 32), (16, 16)])
@pytest.mark.parametrize("progression", ["LRCP", "RLCP", "RPCL", "PCRL",
                                         "CPRL"])
def test_progressions(progression, precinct, irreversible):
    """The five progression orders with and without precincts. PIL writes
    16 x 16 precincts at 6 resolutions into a stream that OpenJPEG cannot
    read back ("broken data stream"): white in both."""
    kw = {} if precinct is None else dict(precinct_size=precinct)
    data = pil_j2k(picture(6, 70, 90), "RGB", progression=progression,
                   irreversible=irreversible, **kw)
    assert _outcome(data) == ("white" if precinct == (16, 16) else "pixels")


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("cblk", [(4, 4), (8, 8), (16, 64), (64, 16),
                                  (32, 32), (64, 64), (4, 64), (128, 32)])
def test_codeblock_sizes(cblk, irreversible):
    assert_pixels(pil_j2k(picture(7, 70, 90), "RGBA", codeblock_size=cblk,
                          irreversible=irreversible))


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("option", ["mct0", "signed", "signedL", "plt",
                                    "comment"])
def test_options(option, irreversible):
    """mct=0, signed=True (PIL writes unsigned samples as signed, and reads
    them back up to 128 off: the port gives the same bytes), PLT markers
    and a comment."""
    mode, kw = {"mct0": ("RGB", dict(mct=0)),
                "signed": ("RGB", dict(signed=True)),
                "signedL": ("L", dict(signed=True)),
                "plt": ("RGB", dict(plt=True)),
                "comment": ("RGB", dict(comment="kajiya"))}[option]
    assert_pixels(pil_j2k(picture(8, 70, 90), mode, irreversible=irreversible,
                          **kw))


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 13), (13, 1), (17, 33),
                                   (2, 2), (3, 1)])
def test_odd_sizes(shape, mode, irreversible):
    """One-sample lines (a 5/3 odd sample halves, a 9/7 one stays), and
    odd extents."""
    assert_pixels(pil_j2k(picture(9, *shape), mode,
                          irreversible=irreversible))


# ----------------------------------------------------------------------------
# what PIL does not write
# ----------------------------------------------------------------------------

def main_segments(data: bytes, soc: int):
    """(marker, start, end) of the main header's segments after SOC."""
    out, p = [], soc + 2
    while p + 4 <= len(data):
        m, n = struct.unpack_from(">HH", data, p)
        if m == 0xFF90:
            break
        out.append((m, p, p + 2 + n))
        p += 2 + n
    return out


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
def test_codeblock_styles(irreversible):
    """Every combination of the Part 1 code-block styles (BYPASS, RESET,
    TERMALL, VSC, PTERM, SEGSYM) set in COD over PIL's data: OpenJPEG
    decodes the same bytes under the other rules, and the port gives its
    pixels (or fails where it fails); the HTJ2K bit raises
    NotImplementedError naming it, and the HT mixed bit is refused by
    OpenJPEG (white)."""
    base = pil_j2k(picture(10, 37, 29), "RGB", no_jp2=True,
                   irreversible=irreversible)
    cod = [s for s in main_segments(base, 0) if s[0] == 0xFF52][0]
    seen = collections.Counter()
    for style in list(range(64)) + [0x40, 0x41, 0x80]:
        data = bytearray(base)
        data[cod[1] + 12] = style
        got = _outcome(bytes(data))
        seen[got] += 1
        if style & 0x80:
            assert got == "white"
        elif style & 0x40:
            assert got == "unported"
            with pytest.raises(NotImplementedError, match="HTJ2K"):
                j2k.decode_j2k(bytes(data))
    assert seen["pixels"] >= 40 and seen["unported"] == 2, seen


def restructured(data: bytes, how: str) -> bytes:
    """A codestream of one tile-part per tile rewritten with the same
    packets: "sop_eph" (an SOP marker before each packet, EPH after each
    header), "ppt" (the headers in the tile-part's PPT markers) or "ppm"
    (in the main header's PPM markers). The decoder locates the packets."""
    cs = j2k._Codestream(data, 0)
    spans = {}
    while True:
        t = cs.read_tile_header()
        if t is None:
            break
        body = cs.tcps[t].data
        sp = np.full(3 * 65536, -1, np.int64)
        cs.decode_tile(t, sp)
        rows = sp.reshape(-1, 3)
        n = int(np.argmax(rows[:, 0] < 0))
        spans[t] = (body, rows[:n].tolist())
        cs.after_tile()
    main = [data[a:b] for _, a, b in main_segments(data, 0)]
    out_main = [s[:4] + bytes([s[4] | 6]) + s[5:]
                if how == "sop_eph" and s[:2] == b"\xff\x52" else s
                for s in main]
    ppm, tiles = b"", []
    for t in sorted(spans):
        body, rows = spans[t]
        hdrs = [body[a:b] for a, b, _ in rows]
        bodies = [body[b:c] for _, b, c in rows]
        extra = b""
        if how == "sop_eph":
            payload = b"".join(
                b"\xff\x91\x00\x04" + struct.pack(">H", i) + h + b"\xff\x92"
                + d for i, (h, d) in enumerate(zip(hdrs, bodies)))
        else:
            allh, payload = b"".join(hdrs), b"".join(bodies)
            if how == "ppt":
                extra = b"".join(
                    b"\xff\x61" + struct.pack(">HB", len(allh[i:i + 60000])
                                              + 3, z) + allh[i:i + 60000]
                    for z, i in enumerate(range(0, max(len(allh), 1),
                                                60000)))
            else:
                ppm += struct.pack(">I", len(allh)) + allh
        tiles.append(b"\xff\x90" + struct.pack(
            ">HHIBB", 10, t, 14 + len(extra) + len(payload), 0, 1) + extra
            + b"\xff\x93" + payload)
    if how == "ppm":
        out_main += [b"\xff\x60" + struct.pack(">HB", len(ppm[i:i + 60000])
                                               + 3, z) + ppm[i:i + 60000]
                     for z, i in enumerate(range(0, len(ppm), 60000))]
    return b"\xff\x4f" + b"".join(out_main) + b"".join(tiles) + b"\xff\xd9"


RESTRUCTURE_BASES = {
    "rgb": ("RGB", {}),
    "l-97-rpcl": ("L", dict(irreversible=True, progression="RPCL")),
    "rgba-tiles-layers": ("RGBA", dict(tile_size=(16, 16),
                                       quality_mode="rates",
                                       quality_layers=[20, 8])),
    "rgb-cprl-precincts": ("RGB", dict(precinct_size=(32, 32),
                                       progression="CPRL",
                                       codeblock_size=(8, 8)))}


@pytest.mark.parametrize("how", ["sop_eph", "ppt", "ppm"])
@pytest.mark.parametrize("base", list(RESTRUCTURE_BASES))
def test_packet_markers_and_headers(base, how):
    """SOP / EPH markers, PPT and PPM packet headers (across tiles, layers
    and progressions): PIL's pixels, equal to the unchanged file's."""
    mode, kw = RESTRUCTURE_BASES[base]
    data = pil_j2k(picture(11, 37, 29), mode, no_jp2=True, **kw)
    new = restructured(data, how)
    assert new != data
    assert_pixels(new)
    np.testing.assert_array_equal(j2k.decode_j2k(new), j2k.decode_j2k(data))


def jp2_file(codestream: bytes, w: int, h: int, nc: int, enumcs=16,
             extra: bytes = b"") -> bytes:
    """A JP2 file around a codestream: ihdr (nc components), a colr box
    of enumcs (None: none), then `extra` boxes."""
    box = j2k._box
    hdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    if enumcs is not None:
        hdr += box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (j2k.JP2_SIGNATURE + box(b"ftyp", b"jp2 \0\0\0\0jp2 ") +
            box(b"jp2h", hdr + extra) + box(b"jp2c", codestream))


def test_jp2_colour_spaces():
    """ihdr's component count (PIL's mode) x colr's colour space (sRGB,
    grey, sYCC, CMYK, e-sYCC, unknown, none) x the codestream's
    components: PIL's unpacker table as OpenJPEG reports the space (an
    unknown or missing one taken as unstated, by component count)."""
    img = picture(12, 12, 10)
    streams = {n: pil_j2k(img, m, no_jp2=True)
               for n, m in ((1, "L"), (2, "LA"), (3, "RGB"), (4, "RGBA"))}
    seen = collections.Counter()
    for nc in (1, 2, 3, 4):
        for enumcs in (16, 17, 18, 12, 24, 99, None):
            for n in (1, 2, 3, 4):
                seen[_outcome(jp2_file(streams[n], 10, 12, nc, enumcs))] += 1
    assert seen == {"pixels": 36, "white": 76}, seen


def test_subsampled_components():
    """A component's XRsiz / YRsiz set to 2 or 3: PIL reads chroma
    subsampled by its own strides (an unstated colour space with
    subsampled chroma taken as sYCC); where PIL's reads run past the
    decoded samples, NotImplementedError."""
    rng = np.random.default_rng(13)
    seen = collections.Counter()
    for mode in ("L", "LA", "RGB", "RGBA", "YCbCr"):
        for shape in ((12, 10), (9, 7), (5, 11)):
            base = pil_j2k(rng.integers(0, 256, shape + (4,), np.uint8),
                           mode, no_jp2=mode != "YCbCr")
            soc = base.find(j2k.J2K_SIGNATURE)
            nsiz = struct.unpack_from(">H", base, soc + 4)[0]
            for comp in range(4):
                for which in (1, 2):
                    pos = soc + 42 + 3 * comp + which
                    if pos >= soc + 4 + nsiz:
                        continue
                    for v in (2, 3):
                        data = bytearray(base)
                        data[pos] = v
                        seen[_outcome(bytes(data))] += 1
    assert seen["pixels"] >= 110 and seen["unported"] <= 12, seen


def test_pclr_palettes():
    """JP2 `pclr` (+ `cmap`) around an L codestream: PIL opens the image as
    P with the palette its `ImagePalette.getcolor` builds (a repeated
    colour keeps its first index); under a grey colour space, or a 16-bit
    palette (the image stays L under sRGB), PIL's decoder has no unpacker
    (white); a four-column palette raises NotImplementedError naming the
    box."""
    rng = np.random.default_rng(14)
    img = (rng.integers(0, 6, (12, 10, 4)) * 40).astype(np.uint8)
    cs = pil_j2k(img, "L", no_jp2=True)
    entries = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(256)]
    entries[5] = entries[3]

    def pclr(ent, depths=(7, 7, 7)):
        return j2k._box(b"pclr", struct.pack(">HB", len(ent), len(depths)) +
                        bytes(depths) + b"".join(bytes(e) for e in ent))
    cmap = j2k._box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                      for i in range(3)))
    assert _outcome(jp2_file(cs, 10, 12, 1, 16, pclr(entries) + cmap)) == \
        "pixels"
    assert _outcome(jp2_file(cs, 10, 12, 1, 16, pclr(entries))) == "pixels"
    assert _outcome(jp2_file(cs, 10, 12, 1, 16, pclr(entries[:100]) +
                             cmap)) == "pixels"
    assert _outcome(jp2_file(cs, 10, 12, 1, 17, pclr(entries) + cmap)) == \
        "white"
    assert _outcome(jp2_file(cs, 10, 12, 1, 16, pclr(entries, (15, 7, 7)) +
                             cmap)) == "white"
    four = j2k._box(b"pclr", struct.pack(">HB", 3, 4) + bytes((7,) * 4) +
                    bytes(12))
    with pytest.raises(NotImplementedError, match="pclr"):
        j2k.decode_j2k(jp2_file(cs, 10, 12, 1, 16, four))


def test_threads_do_not_change_output(monkeypatch):
    """The code-blocks and components decode on several threads (a thread
    per 64K samples of a tile, up to THREADS); one thread gives the same
    bytes."""
    data = pil_j2k(picture(15, 384, 384), "RGBA", irreversible=True,
                   codeblock_size=(16, 16))
    monkeypatch.setattr(j2k, "THREADS", 8)
    many = j2k.decode_j2k(data)
    monkeypatch.setattr(j2k, "THREADS", 1)
    np.testing.assert_array_equal(j2k.decode_j2k(data), many)
    lossless = pil_j2k(picture(15, 400, 512), "RGB", codeblock_size=(8, 8))
    one = j2k.decode_j2k(lossless)
    monkeypatch.setattr(j2k, "THREADS", 7)
    np.testing.assert_array_equal(j2k.decode_j2k(lossless), one)


# ----------------------------------------------------------------------------
# sweeps
# ----------------------------------------------------------------------------

def _sweep_bases():
    rng = np.random.default_rng(5)
    out = []
    for k in range(6):
        h, w = (int(v) for v in rng.integers(8, 48, 2))
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        img[: h // 2] = (img[: h // 2] // 64) * 64
        out.append((("RGB", "L", "RGBA", "LA", "RGB", "L")[k], img))
    return out


# the sweeps' files that raise NotImplementedError, by kind (PERF.md gives
# the outcomes); no change may send more of them there
CUT_UNPORTED = {"j2k-53": 0, "j2k-97": 0, "jp2": 0}


@pytest.mark.parametrize("kind", list(CUT_UNPORTED))
def test_cut_or_flipped_as_pil(kind):
    """300 seeded cut or flipped files of each kind (lossless and 9/7
    codestreams, JP2 files), over six images, four progressions, 16 x 16
    code-blocks and two layers: PIL's bytes, PIL's error, or
    NotImplementedError (bounded); never other pixels. OpenJPEG decodes
    strictly: a cut file fails, a flipped byte in packet data decodes."""
    rng = np.random.default_rng({"j2k-53": 1, "j2k-97": 2, "jp2": 3}[kind])
    bases = _sweep_bases()
    seen = collections.Counter()
    for t in range(300):
        mode, img = bases[t % len(bases)]
        kw = dict(no_jp2=kind != "jp2", irreversible=kind == "j2k-97")
        if t % 3 == 1:
            kw["progression"] = ("RPCL", "PCRL", "CPRL", "RLCP")[t % 4]
        if t % 5 == 2:
            kw["codeblock_size"] = (16, 16)
        if t % 7 == 3:
            kw.update(quality_mode="rates", quality_layers=[30, 10])
        data = bytearray(pil_j2k(img, mode, **kw))
        if rng.random() < 0.3:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                i = int(rng.integers(0, len(data)))
                data[i] = int(rng.integers(0, 256)) if rng.random() < 0.5 \
                    else data[i] ^ (1 << int(rng.integers(0, 8)))
        seen[_outcome(bytes(data))] += 1
    assert seen["unported"] <= CUT_UNPORTED[kind], seen
    assert seen["pixels"] >= 100 and seen["white"] >= 80, seen


HEADER_SEEDS = {
    "rgb-53": ("RGB", dict(no_jp2=True)),
    "l-97-rpcl": ("L", dict(no_jp2=True, irreversible=True,
                            progression="RPCL", precinct_size=(32, 32))),
    "rgba-jp2-tiles": ("RGBA", dict(tile_size=(16, 16),
                                    codeblock_size=(8, 8)))}
# NotImplementedError in the header sweep, by seed (the HTJ2K bit; a
# subsampled component PIL reads past in a tile)
HEADER_UNPORTED = {"rgb-53": 1, "l-97-rpcl": 1, "rgba-jp2-tiles": 7}


@pytest.mark.parametrize("seed", list(HEADER_SEEDS))
def test_main_header_field_sweep(seed):
    """Each byte of SIZ, COD and QCD set to 0, 1, 0x7F, 0x80, 0xFF and
    its value with the lowest bit flipped: PIL's pixels, white in both, or
    NotImplementedError (bounded)."""
    mode, kw = HEADER_SEEDS[seed]
    base = pil_j2k(picture(16, 37, 29), mode, **kw)
    soc = base.find(j2k.J2K_SIGNATURE)
    seen = collections.Counter()
    for marker, a, b in main_segments(base, soc):
        if marker not in (0xFF51, 0xFF52, 0xFF5C):
            continue
        for i in range(a, b):
            for v in sorted({0, 1, 0x7F, 0x80, 0xFF, base[i] ^ 1} -
                            {base[i]}):
                data = bytearray(base)
                data[i] = v
                seen[_outcome(bytes(data))] += 1
    assert seen["unported"] <= HEADER_UNPORTED[seed], seen
    assert seen["pixels"] >= 120 and seen["white"] >= 150, seen


def test_bake_matches_jax():
    """One source of each kind through both bakes."""
    img = picture(17, 40, 52)
    assert_bake_matches_jax([
        pil_j2k(img, "RGB", no_jp2=True),
        pil_j2k(img, "RGBA", irreversible=True),
        pil_j2k(img, "YCbCr", progression="CPRL", precinct_size=(32, 32)),
        pil_j2k(img, "L", tile_size=(16, 16), offset=(3, 5)),
        restructured(pil_j2k(img, "RGB", no_jp2=True), "ppm")])
