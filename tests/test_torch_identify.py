"""Source identification (`kajiya_tpu_torch/scene/identify.py`) and the
bake's dispatch: no texture that the JAX package decodes through PIL turns
white in the port.

- Each PIL 12.1.0 plugin's `_accept` rule, applied to the first 16 bytes as
  `Image.open` applies it, agrees with the port's mirror on a corpus of
  prefixes (every file PIL writes, every rule's own signature, and seeded
  random bytes).
- The sweep: every format in PIL's `Image.SAVE` that saves a random 8x8 RGB
  or RGBA image is baked by both packages (`build_texture_pages`); each
  source gives equal atlases or, for a format the port does not decode
  yet, raises NotImplementedError naming ROADMAP.md, and never a white slot
  where JAX's is not white.
- Bytes that no plugin accepts bake white in both."""
import base64
import io

import numpy as np
import pytest
from PIL import Image

from kajiya_tpu_torch.scene import identify, textures

Image.init()


def _saved(fmt, mode):
    """A random 8x8 image in `mode` saved by PIL as `fmt`, or None where
    PIL cannot save it."""
    rng = np.random.default_rng(sum(map(ord, fmt + mode)))
    img = rng.integers(0, 256, (8, 8, len(mode)), np.uint8)
    buf = io.BytesIO()
    try:
        Image.fromarray(img, mode).save(buf, fmt)
    except Exception:
        return None
    return buf.getvalue()


SWEEP = [(f, m) for f in sorted(Image.SAVE) for m in ("RGB", "RGBA")
         if _saved(f, m) is not None]


def _corpus():
    rng = np.random.default_rng(0)
    base = [_saved(f, m)[:16] for f, m in SWEEP]
    base += [b"", b"not an image at all", b"BM", b"P6", b"\x0a\x05",
             b"\x01\xda", b"GRIB\0\0\0\x01", b"  #define x 1"]
    out = list(base)
    for data in base:                 # each head with random bytes after it
        for n in (1, 2, 4, 8, 12):
            out.append(data[:n] + rng.integers(0, 256, 16 - min(n, 16),
                                               np.uint8).tobytes())
    out += [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(500)]
    out += [bytes([b]) + rng.integers(0, 256, 15, np.uint8).tobytes()
            for b in range(256)]
    return out


CORPUS = _corpus()


@pytest.mark.parametrize("name", [n for n, t in identify._ACCEPT
                                  if t is not None])
def test_accept_rules_mirror_pil(name):
    """The mirror of `name`'s `_accept` says what PIL's says (a message
    string, which PIL returns for an unsupported codec, counts as no, and so
    does a rule that raises on a short prefix: `Image.open` catches it)."""
    import struct

    _factory, accept = Image.OPEN[name]
    assert accept is not None
    for data in CORPUS:
        try:
            want = accept(data[:16]) is True
        except (struct.error, IndexError, TypeError, SyntaxError):
            want = False
        assert identify._matches(name, dict(identify._ACCEPT)[name],
                                 data) == want, (name, data[:16])


def test_plugin_order_mirrors_pil():
    """identify lists every plugin PIL registers for opening, in its order,
    and knows which have no `_accept` rule."""
    assert identify.FORMATS == tuple(Image.ID)
    assert {n for n, t in identify._ACCEPT if t is None} == {
        n for n in Image.ID if Image.OPEN[n][1] is None}


@pytest.mark.parametrize("fmt,mode", SWEEP, ids=[f"{f}-{m}" for f, m in SWEEP])
def test_sweep_no_white_where_jax_decodes(fmt, mode):
    from kajiya_tpu.scene import textures as tex_j

    data = _saved(fmt, mode)
    uri = "data:application/octet-stream;base64," + base64.b64encode(
        data).decode()
    atlas_j, sub_j = (np.asarray(x) for x in tex_j.build_texture_pages([uri]))
    page, size, ox, oy = sub_j[1]
    jax_white = bool((atlas_j[page, oy:oy + size, ox:ox + size] == 255).all())
    try:
        atlas_t, sub_t = textures.bake_texture_pages([uri])
    except NotImplementedError as e:
        name = identify.identify(data)
        assert name is not None and name in str(e) and "ROADMAP" in str(e)
        assert name not in textures._DECODERS
        return
    np.testing.assert_array_equal(sub_t, sub_j)
    np.testing.assert_array_equal(atlas_t, atlas_j)
    if not jax_white:
        assert identify.identify(data) in textures._DECODERS


@pytest.mark.parametrize("data", [b"not an image at all", b"", b"\0" * 64,
                                  b"hello\nworld", b"RIFF\0\0\0\0WAVEfmt "],
                         ids=["text", "empty", "zeros", "lines", "wav"])
def test_unidentified_bytes_bake_white_in_both(data):
    from kajiya_tpu.scene import textures as tex_j

    assert identify.identify(data) is None
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data))
    uri = "data:application/octet-stream;base64," + base64.b64encode(
        data).decode()
    atlas_t, sub_t = textures.bake_texture_pages([uri])
    atlas_j, sub_j = tex_j.build_texture_pages([uri])
    np.testing.assert_array_equal(atlas_t, np.asarray(atlas_j))
    page, size, ox, oy = sub_t[1]
    assert (atlas_t[page, oy:oy + size, ox:ox + size] == 255).all()


def test_decompression_bomb_limit():
    """Above twice PIL's MAX_IMAGE_PIXELS the decoders refuse, as PIL does
    (the bake turns it white)."""
    assert identify.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS
    identify.check_pixels(2 * Image.MAX_IMAGE_PIXELS, 1)
    with pytest.raises(ValueError, match="bomb"):
        identify.check_pixels(2 * Image.MAX_IMAGE_PIXELS + 1, 1)


@pytest.mark.parametrize("part", range(4))
def test_tga_with_ten_byte_id_as_pil(part):
    """A TGA whose id field is 10 bytes long and that has no colour map
    starts `0a 00`, which PCX's rule accepts: PIL tries PCX's `_open`
    first (which mostly raises "unknown PCX mode", white) and the port,
    which reads PCX, goes the same way. 50 seeded headers a part: image
    types, depths, origins, sizes and id bytes."""
    import struct

    from test_torch_bmp import sweep_outcome

    rng = np.random.default_rng(2500 + part)
    seen = {}
    for _ in range(50):
        itype = int(rng.choice([1, 2, 3, 9, 10, 11]))
        depth = int(rng.choice([1, 8, 16, 24, 32]))
        w, h = (int(v) for v in rng.integers(1, 20, 2))
        head = struct.pack("<BBBHHBHHHHBB", 10, 0, itype,
                           int(rng.integers(0, 3)), 0, 0,
                           int(rng.integers(0, 4)), int(rng.integers(0, 4)),
                           w, h, depth, int(rng.choice([0, 0x20])))
        ident = rng.integers(0, 256, 10, np.uint8)
        ident[rng.random(10) < 0.5] = 1
        body = rng.integers(0, 256, w * h * 4 + 40, np.uint8).tobytes()
        data = head + ident.tobytes() + body
        assert identify.candidates(data)[0] == "PCX"
        outcome = sweep_outcome(data)
        seen[outcome] = seen.get(outcome, 0) + 1
    assert "unported" not in seen, seen
