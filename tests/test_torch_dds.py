"""The port's DDS decoder (`kajiya_tpu_torch/scene/dds.py`, BCn blocks in
host C++ `csrc/bcn_decoder.cpp`) against PIL 12.1.0's DdsImagePlugin, which
the JAX package's bake decodes textures with. Tolerance: byte for byte
(`np.asarray(Image.open(...).convert("RGBA"))`).

Files: PIL-written DXT1/3/5, BC2/3 and BC5; DX10 headers followed by random
blocks for every BCn format PIL decodes (BC6H and all BC7 modes included,
and BC7's modeless first byte 0); the FourCC BC4 / BC5 variants; bit-mask,
luminance and palette pixels; sizes that are not a multiple of 4; mip chains
(only the top image is read). Formats PIL refuses bake white in both
packages. The test-scene writers' BC5 and BC7 blocks decode to the texels
they report."""
import base64
import io
import struct

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import dds, textures
from kajiya_tpu_torch.scene.dds import DdsError, decode_dds, dds_header


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data):
    np.testing.assert_array_equal(decode_dds(data), _pil(data))


def _header(width, height, pfflags, fourcc=b"\0\0\0\0", bitcount=0,
            masks=(0, 0, 0, 0), mipmaps=1):
    pf = struct.pack("<II4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    return b"DDS " + struct.pack("<7I", 124, 0x100F, height, width, 0, 0,
                                 mipmaps) + bytes(44) + pf + bytes(20)


@pytest.mark.parametrize("fmt", ["DXT1", "DXT3", "DXT5", "BC2", "BC3",
                                 "BC5"])
@pytest.mark.parametrize("size", [(1, 1), (10, 13), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pil_written_matches_pil(fmt, size):
    """Files PIL's own encoder writes (BC5 from RGB, the rest from RGBA
    with varied alpha, so DXT1's punch-through alpha shows)."""
    rng = np.random.default_rng(len(fmt) * 7 + size[0])
    h, w = size
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    img[..., 3] = rng.choice([0, 40, 128, 255], (h, w))
    im = Image.fromarray(img[..., :3] if fmt == "BC5" else img)
    buf = io.BytesIO()
    im.save(buf, "DDS", pixel_format=fmt)
    _same(buf.getvalue())


# every DXGI format PIL decodes as BCn: (dxgi, BCn)
DX10 = [(70, 1), (71, 1), (73, 2), (74, 2), (76, 3), (77, 3), (79, 4),
        (80, 4), (82, 5), (83, 5), (84, 5), (95, 6), (96, 6), (97, 7),
        (98, 7), (99, 7)]


@pytest.mark.parametrize("dxgi,bcn", DX10, ids=[str(d) for d, _ in DX10])
def test_dx10_random_blocks_match_pil(dxgi, bcn):
    """Random blocks (every BC6H mode and partition, every BC7 mode, BC7
    blocks with a first byte of 0) at 131 x 122 pixels, followed by a mip
    chain's worth of bytes."""
    rng = np.random.default_rng(dxgi)
    w, h = 131, 122
    nb = ((w + 3) // 4) * ((h + 3) // 4)
    size = 8 if bcn in (1, 4) else 16
    blocks = rng.integers(0, 256, (nb, size), np.uint8)
    if bcn == 7:
        mode = rng.integers(0, 9, nb)           # 8: no mode bit set
        low = (1 << (mode + 1)) - 1
        blocks[:, 0] = np.where(mode == 8, 0, (blocks[:, 0] & ~low)
                                | (1 << mode)) & 255
    data = dds_header(w, h, dxgi) + blocks.tobytes() + rng.integers(
        0, 256, nb * size // 3, np.uint8).tobytes()
    _same(data)


@pytest.mark.parametrize("fourcc", [b"BC4U", b"ATI1", b"BC5U", b"ATI2",
                                    b"BC5S"], ids=lambda f: f.decode())
def test_fourcc_random_blocks_match_pil(fourcc):
    rng = np.random.default_rng(fourcc[3])
    w, h = 37, 22
    size = 8 if fourcc[2:3] == b"4" or fourcc == b"ATI1" else 16
    blocks = rng.integers(0, 256, 10 * 6 * size, np.uint8).tobytes()
    _same(_header(w, h, 0x4, fourcc) + blocks)


MASKS = {
    "r5g6b5": (0x40, 16, (0xF800, 0x07E0, 0x001F, 0)),
    "a1r5g5b5": (0x41, 16, (0x7C00, 0x03E0, 0x001F, 0x8000)),
    "a8r8g8b8": (0x41, 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "x8b8g8r8": (0x40, 32, (0xFF, 0xFF00, 0xFF0000, 0)),
    "r8g8b8": (0x40, 24, (0xFF0000, 0xFF00, 0xFF, 0)),
    "gapped": (0x41, 16, (0b1010, 0x0F00, 0, 0xC000)),
    "truncated": (0x41, 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
}


@pytest.mark.parametrize("case", list(MASKS))
def test_mask_formats_match_pil(case):
    """Uncompressed pixels with channel bit masks: 5:6:5, 1:5:5:5, 8-bit
    orders, 24-bit, non-contiguous and zero masks, and a file that ends
    early (PIL reads zeros past the end)."""
    flags, bits, masks = MASKS[case]
    rng = np.random.default_rng(bits)
    w, h = 9, 7
    body = rng.integers(0, 256, w * h * bits // 8, np.uint8).tobytes()
    if case == "truncated":
        body = body[:len(body) // 2 + 1]
    _same(_header(w, h, flags, bitcount=bits, masks=masks) + body)


@pytest.mark.parametrize("case", ["L8", "L8A8", "P8"])
def test_luminance_and_palette_match_pil(case):
    rng = np.random.default_rng(len(case))
    w, h = 11, 6
    if case == "L8":
        data = _header(w, h, 0x20000, bitcount=8) + rng.integers(
            0, 256, w * h, np.uint8).tobytes()
    elif case == "L8A8":
        data = _header(w, h, 0x20001, bitcount=16) + rng.integers(
            0, 256, 2 * w * h, np.uint8).tobytes()
    else:
        data = (_header(w, h, 0x20, bitcount=8)
                + rng.integers(0, 256, 1024, np.uint8).tobytes()
                + rng.integers(0, 256, w * h, np.uint8).tobytes())
    _same(data)


@pytest.mark.parametrize("case", ["bc4_snorm", "bc1_srgb", "bc3_srgb",
                                  "bc6h_typeless", "fourcc_unknown",
                                  "header_size", "truncated_blocks",
                                  "truncated_header", "no_flags"])
def test_refused_formats_bake_white_in_both(case):
    """What PIL refuses (DXGI 81 BC4_SNORM and the BC1-BC3 _SRGB formats
    it has no decoder for, BC6H_TYPELESS, an unknown FourCC, a bad header,
    too few blocks, no pixel-format flag): the port raises DdsError, and
    both packages' bakes give the same atlas, a white slot."""
    from kajiya_tpu.scene import textures as tex_j

    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 256, 16 * 16, np.uint8).tobytes()
    dxgi = {"bc4_snorm": 81, "bc1_srgb": 72, "bc3_srgb": 78,
            "bc6h_typeless": 94}.get(case)
    if dxgi is not None:
        data = dds_header(16, 16, dxgi) + blocks
    elif case == "fourcc_unknown":
        data = _header(16, 16, 0x4, b"ATC ") + blocks
    elif case == "header_size":
        data = b"DDS " + struct.pack("<I", 100) + dds_header(16, 16, 98)[8:] \
            + blocks
    elif case == "truncated_blocks":
        data = dds_header(16, 16, 98) + blocks[:100]
    elif case == "truncated_header":
        data = dds_header(16, 16, 98)[:90]
    else:
        data = _header(16, 16, 0) + blocks
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(DdsError):
        decode_dds(data)
    uri = "data:image/vnd-ms.dds;base64," + __import__("base64").b64encode(
        data).decode()
    atlas_t, sub_t = textures.bake_texture_pages([uri])
    atlas_j, sub_j = tex_j.build_texture_pages([uri])
    np.testing.assert_array_equal(sub_t, np.asarray(sub_j))
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    page, size, ox, oy = sub_t[1]
    assert (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


@pytest.mark.parametrize("writer", ["bc5", "bc7_mode6"])
def test_writers_decode_to_their_texels(writer):
    """The mixed-format city's writers: the blocks decode, in PIL and in
    the port, to exactly the texels the writer reports; flat blocks too."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (32, 24, 4), np.uint8)
    img[:8] = 200                                  # flat blocks
    img[8:16] = np.clip(img[8:16] // 16 + 100, 0, 255)
    if writer == "bc5":
        data, texels = dds.bc5_blocks(img[..., :2])
        f = dds_header(24, 32, 83) + data
        want = np.zeros((32, 24, 4), np.uint8)
        want[..., :2] = texels
        want[..., 3] = 255
    else:
        data, want = dds.bc7_mode6_blocks(img)
        f = dds_header(24, 32, 98) + data
        assert all(b & 0x7F == 0x40 for b in data[::16])  # mode 6 only
    np.testing.assert_array_equal(decode_dds(f), want)
    np.testing.assert_array_equal(_pil(f), want)
    # flat blocks are exact; BC5 follows a smooth channel within its ramp
    assert (want[:8, ..., :2] == 200).all()
    if writer == "bc5":
        err = np.abs(want[8:16, ..., :2].astype(int) - img[8:16, ..., :2])
        assert err.max() <= 2, err.max()


@pytest.mark.parametrize("top", [0x8C, 0x01, 0xFF])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_huge_bit_count_reads_as_pil(mode, top):
    """A masked DDS whose dwRGBBitCount's top byte is set: PIL's
    DdsRgbDecoder reads bitcount // 8 bytes a pixel with `fd.read`, which
    returns the rest of the file and then nothing, so pixel 0 takes the
    body's first bytes and every other pixel reads zero. The port models
    that read instead of allocating gigabytes (a MemoryError, which the
    bake does not catch)."""
    rng = np.random.default_rng(top)
    im = Image.fromarray(rng.integers(0, 256, (17, 23, len(mode)), np.uint8),
                         mode)
    buf = io.BytesIO()
    im.save(buf, "DDS")
    data = bytearray(buf.getvalue())
    data[91] = top
    want = _pil(bytes(data))
    got = decode_dds(bytes(data))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (17, 23, 4)
    assert not (got[1:] == got[0, 0]).all()
    atlas, sub = textures.bake_texture_pages(
        ["data:;base64," + base64.b64encode(bytes(data)).decode()])
    assert sub.shape[0] == 2
