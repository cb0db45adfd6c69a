"""Port parity, numerics base: RNG, blue noise, camera, color, tiling, image
helpers and the plain version of the warp kernel W, each run through the JAX
function and its kajiya_tpu_torch counterpart on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.core import bluenoise as bn_j
from kajiya_tpu.core import camera as cam_j
from kajiya_tpu.core import color as col_j
from kajiya_tpu.core import img as im_j
from kajiya_tpu.core import rng as rng_j
from kajiya_tpu.ops import tiling as til_j
from kajiya_tpu.ops.warp_pallas import warp2d_pallas
from kajiya_tpu_torch.core import bluenoise as bn_t
from kajiya_tpu_torch.core import camera as cam_t
from kajiya_tpu_torch.core import color as col_t
from kajiya_tpu_torch.core import img as im_t
from kajiya_tpu_torch.core import rng as rng_t
from kajiya_tpu_torch.ops import tiling as til_t
from kajiya_tpu_torch.ops.warp_cuda import vector_width, warp2d, warp_plain

# Tolerances: RNG streams and blue-noise masks are bit-exact; camera rays,
# colors and image helpers agree to 1e-6 absolute (float32 rounding of the
# same formulas); the plain warp agrees with the JAX sampler to 1e-6.
ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


# ----------------------------------------------------------------------------
# RNG (bit-exact)
# ----------------------------------------------------------------------------

def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64
                                                ).astype(np.uint32)


def test_pcg_hash_bit_exact():
    x = np.concatenate([_u32(4096, 0), np.array([0, 1, 2 ** 32 - 1],
                                                np.uint32)])
    ref = np.asarray(rng_j.pcg_hash(jnp.asarray(x)))
    got = _n(rng_t.pcg_hash(_t(x.astype(np.int64))))
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_hash_combine_and_pixel_rng_bit_exact():
    a, b = _u32(2048, 1), _u32(2048, 2)
    ref = np.asarray(rng_j.hash_combine(jnp.asarray(a), jnp.asarray(b)))
    got = _n(rng_t.hash_combine(_t(a.astype(np.int64)), _t(b.astype(np.int64))))
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    px = np.arange(64 * 48, dtype=np.uint32)
    for frame in (0, 7, 1000):
        for stream in (0, 3):
            ref = np.asarray(rng_j.pixel_rng(jnp.asarray(px % 64),
                                             jnp.asarray(px // 64),
                                             jnp.uint32(frame), stream))
            got = _n(rng_t.pixel_rng(_t((px % 64).astype(np.int64)),
                                     _t((px // 64).astype(np.int64)),
                                     frame, stream))
            np.testing.assert_array_equal(got.astype(np.uint32), ref)
            np.testing.assert_array_equal(
                _n(rng_t.u01(_t(got))), np.asarray(rng_j.u01(jnp.asarray(ref))))


def test_halton_and_r2_bit_exact():
    np.testing.assert_array_equal(rng_t.halton23_sequence(128),
                                  rng_j.halton23_sequence(128))
    n = np.arange(0, 4096, dtype=np.float32)
    np.testing.assert_array_equal(_n(rng_t.r2_sequence(_t(n))),
                                  np.asarray(rng_j.r2_sequence(jnp.asarray(n))))


def test_bluenoise_masks_and_planes_bit_exact():
    np.testing.assert_array_equal(bn_t.load_masks(), bn_j._load_masks())
    for frame in (0, 1, 5, 77):
        for stream in (0, 1, 9):
            ref = np.asarray(bn_j.blue_noise_plane(48, 150, jnp.int32(frame),
                                                   stream))
            got = _n(bn_t.blue_noise_plane(48, 150, torch.tensor(frame),
                                           stream))
            np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------------
# Camera (1e-6)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("eye,fwd,jit", [
    ((0.0, 0.0, 2.4), (0.0, 0.0, -1.0), (0.0, 0.0)),
    ((0.0, 14.0, 28.0), (0.0, -0.45, -1.0), (0.25, -0.375)),
    ((1.5, 0.3, -2.0), (-0.3, 0.1, 0.9), (-0.5, 0.125)),
])
def test_camera_view_constants_and_rays(eye, fwd, jit):
    w, h = 64, 48
    vj = cam_j.make_view_constants(eye, fwd, fov_y_deg=55.0, width=w,
                                   height=h, jitter=jit)
    vt = cam_t.make_view_constants(eye, fwd, fov_y_deg=55.0, width=w,
                                   height=h, jitter=jit, device="cpu")
    for name in ("view_to_clip", "clip_to_view", "world_to_view",
                 "view_to_world", "sample_offset_pixels", "eye_position"):
        np.testing.assert_allclose(_n(getattr(vt, name)),
                                   np.asarray(getattr(vj, name)), atol=ATOL,
                                   rtol=1e-6)
    oj, dj = cam_j.camera_rays(vj, w, h)
    ot, dt = cam_t.camera_rays(vt, w, h)
    np.testing.assert_allclose(_n(ot), np.asarray(oj), atol=ATOL)
    np.testing.assert_allclose(_n(dt), np.asarray(dj), atol=ATOL)


# ----------------------------------------------------------------------------
# Color, tiling, image helpers (1e-6)
# ----------------------------------------------------------------------------

def _img(shape, seed=0, lo=0.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["luminance", "srgb_encode", "srgb_decode",
                                "lin_to_ycbcr", "ycbcr_to_lin"])
def test_color(fn):
    x = _img((33, 17, 3), seed=3)
    np.testing.assert_allclose(_n(getattr(col_t, fn)(_t(x))),
                               np.asarray(getattr(col_j, fn)(jnp.asarray(x))),
                               atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("shape", [(64, 128, 3), (48, 64), (100, 300, 2)])
def test_tile_order_roundtrip(shape):
    x = _img(shape, seed=4)
    h, w = shape[:2]
    tj = np.asarray(til_j.tile_order(jnp.asarray(x)))
    tt = _n(til_t.tile_order(_t(x)))
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(_n(til_t.untile_order(_t(tt), h, w)), x)


_SHAPES = [(48, 64), (48, 64, 3), (37, 50, 2)]


def _helper_cases():
    offs = [(-1, 0), (0, 0), (2, -3), (-5, 7)]
    return {
        "decimate2": lambda m, x: m.decimate2(x),
        "downsample_2x": lambda m, x: m.downsample_2x(x),
        "downsample_nearest": lambda m, x: m.downsample_nearest(x),
        "upsample2x_bilinear": lambda m, x: m.upsample2x_bilinear(x),
        "upsample_bilinear": lambda m, x: m.upsample_bilinear(x, 71, 90),
        "separable_blur": lambda m, x: m.separable_blur(x, m.GAUSS5),
        "shift2d": lambda m, x: m.shift2d(x, 3, -4),
        "shift_stack": lambda m, x: m.shift_stack(x, offs),
        "local_moments_3x3": lambda m, x: m.local_moments_3x3(x)[1],
    }


@pytest.mark.parametrize("name", sorted(_helper_cases()))
@pytest.mark.parametrize("shape", _SHAPES, ids=str)
def test_image_helpers(name, shape):
    fn = _helper_cases()[name]
    x = _img(shape, seed=5)
    ref = np.asarray(fn(im_j, jnp.asarray(x)))
    got = _n(fn(im_t, _t(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)


def test_pixel_uv():
    np.testing.assert_array_equal(_n(im_t.pixel_uv(48, 64)),
                                  np.asarray(im_j.pixel_uv(48, 64)))


# ----------------------------------------------------------------------------
# Plain W (exact to 1e-6) against the JAX sampler and the Pallas kernel
# ----------------------------------------------------------------------------

H, W = 128, 768


def _uv_local(seed, scale=8.0, h=H, w=W):
    rng = np.random.default_rng(seed)
    base = np.asarray(im_j.pixel_uv(h, w))
    jit = (rng.uniform(size=(h, w, 2)) * 2.0 - 1.0) * scale
    return (base + jit / np.array([w, h], np.float32)).astype(np.float32)


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("c", [1, 3])
def test_warp_plain_matches_jax_sampler(bilinear, c):
    img = _img((H, W, c), seed=6, lo=-1.0, hi=1.0)
    if c == 1:
        img = img[..., 0]
    uv = _uv_local(7) * 1.02 - 0.01      # some taps fall off the edges
    samp = im_j.sample_bilinear if bilinear else im_j.sample_nearest
    ref = np.asarray(samp(jnp.asarray(img), jnp.asarray(uv)))
    got = _n(warp2d(_t(img), _t(uv), bilinear=bilinear))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    via_img = (im_t.warp_bilinear if bilinear else im_t.warp_nearest)
    np.testing.assert_array_equal(_n(via_img(_t(img), _t(uv))), got)


@pytest.mark.parametrize("bilinear", [True, False])
def test_warp_plain_matches_pallas_interpret(bilinear):
    """The Pallas kernel builds its bilinear weights from window-local
    coordinates and differs from the JAX sampler itself by up to ~4e-5 at
    x ~ 512 (float32 coordinate rounding). The port is held to the sampler,
    so against Pallas it must be within the sampler's own distance + 1e-6."""
    img = _img((H, W, 3), seed=8, lo=-1.0, hi=1.0)
    uv = _uv_local(9)
    ref = np.asarray(warp2d_pallas(jnp.asarray(img), jnp.asarray(uv),
                                   bilinear=bilinear, exact=True,
                                   interpret=True))
    samp = im_j.sample_bilinear if bilinear else im_j.sample_nearest
    sampler = np.asarray(samp(jnp.asarray(img), jnp.asarray(uv)))
    got = _n(warp2d(_t(img), _t(uv), bilinear=bilinear))
    assert np.all(np.abs(got - ref) <= np.abs(sampler - ref) + ATOL)
    if not bilinear:
        np.testing.assert_array_equal(got, ref)


def element_index(n: int, c: int, device=None):
    """The warp kernel's thread mapping, written out in plain PyTorch: flat
    element q of an (n, c) output -> (pixel, first channel, channels in the
    element)."""
    width = vector_width(c)
    cv = c // width
    q = torch.arange(n * cv, device=device)
    return q // cv, (q % cv) * width, width


def warp_by_elements(img, uv, bilinear: bool = True):
    """The plain sampler evaluated in the kernel's thread order: every flat
    element samples its pixel's uv and keeps its own channels. Equals
    `warp_plain` bit for bit if the mapping covers every output float once.
    (The kernel's own index arithmetic is launched on the card, for every
    instance of its template, by `chip_smoke.py`.)"""
    squeeze = img.ndim == 2
    img3 = img[..., None] if squeeze else img
    c = img3.shape[-1]
    uv2 = uv.reshape(-1, 2)
    pix, ch, width = element_index(uv2.shape[0], c, img.device)
    full = warp_plain(img3, uv2[pix], bilinear)             # (n * cv, c)
    cols = ch[:, None] + torch.arange(width, device=img.device)
    out = full.gather(1, cols).reshape(tuple(uv.shape[:-1]) + (c,))
    return out[..., 0] if squeeze else out


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("c", [0, 1, 2, 3, 4, 13, 16])
def test_warp_channel_counts_and_thread_mapping(bilinear, c):
    """Every channel count the kernel specialises (and 0: a 2-D image), at a
    uv grid of another size than the image, with taps off every edge: the
    wrapper against the JAX sampler to 1e-6, and the kernel's mapping of
    flat elements to (pixel, channels) in plain PyTorch against the wrapper,
    exactly."""
    h, w, h2, w2 = 37, 50, 29, 41
    img = _img((h, w) if c == 0 else (h, w, c), seed=10 + c, lo=-1.0, hi=1.0)
    rng = np.random.default_rng(20 + c)
    uv = rng.uniform(-0.05, 1.05, (h2, w2, 2)).astype(np.float32)
    samp = im_j.sample_bilinear if bilinear else im_j.sample_nearest
    ref = np.asarray(samp(jnp.asarray(img), jnp.asarray(uv)))
    got = _n(warp2d(_t(img), _t(uv), bilinear=bilinear))
    assert got.shape == ref.shape == ((h2, w2) if c == 0 else (h2, w2, c))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    spread = _n(warp_by_elements(_t(img), _t(uv), bilinear=bilinear))
    np.testing.assert_array_equal(spread, got)
    # the flat run covers every output float once, in order
    cc = max(c, 1)
    pix, ch, width = element_index(h2 * w2, cc)
    assert width == vector_width(cc) and cc % width == 0
    flat = (_n(pix)[:, None] * cc + _n(ch)[:, None]
            + np.arange(width)[None, :]).reshape(-1)
    np.testing.assert_array_equal(flat, np.arange(h2 * w2 * cc))


def test_warp_vector_widths():
    assert [vector_width(c) for c in (1, 2, 3, 4, 6, 13, 16, 20)] == \
        [1, 2, 1, 4, 2, 1, 4, 4]
