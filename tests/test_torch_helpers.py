"""Port parity of the helpers no ported pass calls: `core/img.py`'s
`sample_const_offset`, `half_to_full_taps`, `downsample_min` and
`bilinear_weights_and_indices`, `brdf/ggx.py::fg_lut`,
`sky/env.py::convolve_diffuse`, `sky/atmosphere.py::
atmosphere_sun_transmittance`, `core/camera.py::depth_to_view_z` and
`renderers/gbuffer.py::gbuffer_view_z`, each against the JAX function on
the same seeded numpy inputs.

Tolerance: 1e-6 absolute (relative to max(1, |value|) for the sky maps,
whose radiance reaches ~10) for the float results; `downsample_min` and
the indices of `bilinear_weights_and_indices` must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.brdf import ggx as ggx_j
from kajiya_tpu.core import camera as cam_j
from kajiya_tpu.core import img as img_j
from kajiya_tpu.renderers import gbuffer as gb_j
from kajiya_tpu.sky import atmosphere as atm_j
from kajiya_tpu.sky import env as env_j
from kajiya_tpu_torch.brdf import ggx as ggx_t
from kajiya_tpu_torch.core import camera as cam_t
from kajiya_tpu_torch.core import img as img_t
from kajiya_tpu_torch.renderers import gbuffer as gb_t
from kajiya_tpu_torch.sky import atmosphere as atm_t
from kajiya_tpu_torch.sky import env as env_t

TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(want, got, rel=False):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = np.maximum(1.0, np.abs(want)) if rel else 1.0
    err = np.max(np.abs(want - got) / scale) if want.size else 0.0
    assert err <= TOL, err


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(
        -2.0, 2.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(12, 16), (12, 16, 3)])
@pytest.mark.parametrize("off", [(0.3, -0.7), (-1.0, 1.0), (0.0, 0.0),
                                 (-0.25, 0.5)])
def test_sample_const_offset(shape, off):
    img = _image(shape, 1)
    want = img_j.sample_const_offset(jnp.asarray(img), *off)
    _close(want, img_t.sample_const_offset(_t(img), *off))


@pytest.mark.parametrize("shape", [(6, 8), (6, 8, 4)])
def test_half_to_full_taps(shape):
    half = _image(shape, 2)
    taps_j, w_j = img_j.half_to_full_taps(jnp.asarray(half))
    taps_t, w_t = img_t.half_to_full_taps(_t(half))
    for a, b in zip(taps_j + w_j, taps_t + w_t):
        _close(a, b)


@pytest.mark.parametrize("shape", [(12, 16), (12, 16, 3), (13, 17, 2)])
def test_downsample_min(shape):
    img = _image(shape, 3)
    want = np.asarray(img_j.downsample_min(jnp.asarray(img)))
    got = img_t.downsample_min(_t(img)).numpy()
    assert want.shape == got.shape
    np.testing.assert_array_equal(want, got)


def test_bilinear_weights_and_indices():
    uv = np.random.default_rng(4).uniform(-0.1, 1.1, (9, 7, 2)).astype(
        np.float32)
    iy_j, ix_j, w_j = img_j.bilinear_weights_and_indices((24, 32),
                                                         jnp.asarray(uv))
    iy_t, ix_t, w_t = img_t.bilinear_weights_and_indices((24, 32), _t(uv))
    assert iy_t.dtype == ix_t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(iy_j), iy_t.numpy())
    np.testing.assert_array_equal(np.asarray(ix_j), ix_t.numpy())
    _close(w_j, w_t)


def test_fg_lut():
    want = ggx_j.fg_lut()
    got = ggx_t.fg_lut(device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _close(want, got)
    # computed once: a second call copies the same host table
    assert torch.equal(ggx_t.fg_lut(device="cpu"), got)


@pytest.mark.parametrize("res_out", [8, 16])
def test_convolve_diffuse(res_out):
    sun = np.array([0.3, 0.8, 0.5], np.float32)
    sun /= np.linalg.norm(sun)
    env = np.asarray(env_j.build_sky_env(jnp.asarray(sun), res=32))
    env = env * np.random.default_rng(5).uniform(
        0.5, 1.5, env.shape).astype(np.float32)
    want = env_j.convolve_diffuse(jnp.asarray(env), res_out=res_out)
    _close(want, env_t.convolve_diffuse(_t(env), res_out=res_out), rel=True)


def test_atmosphere_sun_transmittance():
    rng = np.random.default_rng(6)
    for el in (-5.0, 2.0, 10.0, 35.0, 80.0):
        az = rng.uniform(0, 2 * np.pi)
        e = np.radians(el)
        d = np.array([np.cos(e) * np.sin(az), np.sin(e),
                      np.cos(e) * np.cos(az)], np.float32)
        want = atm_j.atmosphere_sun_transmittance(jnp.asarray(d))
        _close(want, atm_t.atmosphere_sun_transmittance(_t(d)))
    from kajiya_tpu_torch import sky

    assert sky.atmosphere_sun_transmittance is \
        atm_t.atmosphere_sun_transmittance


def test_depth_to_view_z():
    depth = np.random.default_rng(7).uniform(0, 1, (24, 32)).astype(
        np.float32)
    depth[0, :4] = 0.0
    want = cam_j.depth_to_view_z(jnp.asarray(depth), near=0.01)
    _close(want, cam_t.depth_to_view_z(_t(depth), near=0.01), rel=True)


def test_gbuffer_view_z():
    rng = np.random.default_rng(8)
    depth = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    hit = rng.uniform(0, 1, (24, 32)) > 0.3
    want = gb_j.gbuffer_view_z({"hit": jnp.asarray(hit),
                                "depth": jnp.asarray(depth)})
    got = gb_t.gbuffer_view_z({"hit": _t(hit), "depth": _t(depth)})
    _close(want, got, rel=True)
