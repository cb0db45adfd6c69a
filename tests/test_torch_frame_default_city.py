"""Port parity, the default frame as a whole on a 12,290-triangle city
(cluster tables: the irradiance cache's unsorted wavefront and every sorted
secondary wavefront go through the culled kernel's plain version; no
emissive triangle, so no mesh-light specular): four frames at 64x48 with a
camera move and the carry-over check into the second validation frame.
Checks as in test_torch_frame_default.py.

Knife edge (shown by `test_coplanar_reflection_knife_edge`): the city's
ground is the plane y = 0, and the reflection rays of wall pixels near it
store hit points on that plane. The RTR lobe resolve keeps a tap only where
the direction from the receiving surface to the tap's stored hit point
leaves that surface (dot(wi, n) > 0); for a ground pixel and a hit point on
the ground that dot is 0 up to rounding, so a last-bit difference of the hit
distance (the plain Woop tests round differently in XLA and PyTorch) keeps
or drops the tap. JAX's own resolve moves as much when the distances move by
one ulp, and the port's resolve fed JAX's planes equals JAX's. The planes
downstream of the resolve (reflections and their history, lit and what
reads it) are therefore held to the fractions in `KNIFE` (measured over the
4 frames: >= 93.5% for the reflections, >= 95.5% for the TAA history,
>= 98% for the rest); every other plane keeps the strict bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kajiya_tpu.renderers import rtr as rtr_j
from kajiya_tpu.scene import procedural as proc_j
from kajiya_tpu_torch.renderers import rtr as rtr_t
from test_torch_frame_default import (N_FRAMES, check_carry_over,
                                      check_frame, run_default, views)

CITY = (lambda: proc_j.city(n=4, subdiv=8), (0.0, 8.0, 14.0),
        (0.0, -0.45, -1.0), (0.15, -0.05, -0.1), False)
KNIFE = {"reflections": 0.9, "rtr_history": 0.9, "rtr_ray_len": 0.93,
         "taa": 0.93, "taa_history": 0.93, "rtr_res_W": 0.97,
         "rtr_res_w_sum": 0.97, "lit": 0.97, "prev_lit": 0.97, "final": 0.97}


@pytest.fixture(scope="module")
def runs():
    return run_default(*CITY)


def test_city_default_takes_the_culled_path(runs):
    from kajiya_tpu_torch.rt.trace import _can_sort

    ts_t, cfg_t, _ = runs
    assert _can_sort(ts_t, True)
    assert not cfg_t.use_mesh_light_specular


def _coplanar_taps(planes, gb):
    """(H, W) bool: pixels whose 13-tap footprint holds a weighted tap whose
    stored hit point lies in the receiving surface's plane (|dot| < 1e-5)."""
    pos = np.asarray(gb["pos"])
    nrm = np.asarray(gb["normal"])
    hit = (pos[::2, ::2] + np.asarray(planes["rtr_res_dir"])
           * np.asarray(planes["rtr_res_t"])[..., None])
    w = np.where(np.asarray(planes["rtr_res_M"]) > 0,
                 np.asarray(planes["rtr_res_W"]), 0.0)
    hh, hw = w.shape
    out = np.zeros(pos.shape[:2], bool)
    for dy, dx in rtr_t._TAPS:
        ys = np.clip(np.arange(hh) + dy, 0, hh - 1)
        xs = np.clip(np.arange(hw) + dx, 0, hw - 1)
        hk = np.repeat(np.repeat(hit[ys][:, xs], 2, 0), 2, 1)
        wk = np.repeat(np.repeat(w[ys][:, xs], 2, 0), 2, 1)
        dv = hk - pos
        wi = dv / np.linalg.norm(dv, axis=-1, keepdims=True)
        out |= (np.abs((wi * nrm).sum(-1)) < 1e-5) & (wk > 0)
    return out


def test_coplanar_reflection_knife_edge(runs):
    """On frame 0's reservoir planes: the port's lobe resolve equals JAX's
    within 1e-5 given the same planes, and JAX's own resolve, with the
    stored hit distances moved by one ulp, changes pixels by > 1e-3, every
    one of them a pixel with a coplanar tap."""
    _, _, out = runs
    r = out[0]
    planes = {k: v for k, v in r["sj"].items() if k.startswith("rtr_res_")}
    gb = r["oj"]["gbuffer"]
    v = views(*CITY[1:4], n=1)[0]
    spec_h = jnp.zeros(planes["rtr_res_radiance"].shape, jnp.float32)
    ref, _ = rtr_j._resolve_footprint(planes, spec_h, planes["rtr_res_t"],
                                      gb, v)
    got, _ = rtr_t._resolve_footprint(
        {k: torch.as_tensor(np.array(x)) for k, x in planes.items()},
        torch.zeros(spec_h.shape), torch.as_tensor(np.array(
            planes["rtr_res_t"])),
        {k: torch.as_tensor(np.array(x)) for k, x in gb.items()}, r["vt"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    t = np.asarray(planes["rtr_res_t"])
    nudged = dict(planes, rtr_res_t=jnp.asarray(np.nextafter(t, np.inf)))
    moved, _ = rtr_j._resolve_footprint(nudged, spec_h, planes["rtr_res_t"],
                                        gb, v)
    changed = np.abs(np.asarray(moved) - np.asarray(ref)).max(-1) > 1e-3
    assert changed.sum() > 0
    assert not (changed & ~_coplanar_taps(planes, gb)).any()


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_default_frames_match_city(runs, frame):
    check_frame(runs, frame, loose=KNIFE)


def test_default_state_carry_over_city(runs):
    check_carry_over(runs, loose=KNIFE)
