"""Frame assembly over an explicit FrameState (port of `kajiya_tpu/frame.py`).

    state', outputs = render_frame(trace_scene, state, view, cfg)

The port renders: raster gbuffer -> reprojection -> SSAO -> sun shadow trace
+ denoise -> the shared secondary-ray wavefront (every-third-frame reservoir
validation, GI candidate trace + hit lighting) -> diffuse GI (ReSTIR
temporal + spatial reservoirs, resolve, temporal filter) -> deferred
lighting with sky reflections -> exposure + post. The irradiance cache, RTR,
TAA and motion blur are not ported yet: `render_frame` raises
NotImplementedError when the config asks for them, naming the ROADMAP step
that brings them. Their state planes are still created by
`init_frame_state` and passed through unchanged, so the state dict matches
the JAX one key for key.

PyTorch runs eagerly; there is no jit and no hot reload.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace
from functools import lru_cache

import torch

from .core import img as im
from .core import rng as rng_mod
from .core.camera import ViewConstants
from .core.profiling import pass_scope
from .device import resolve_device
from .renderers import (deferred, gbuffer, post, reprojection, restir_gi,
                        rtdgi, shadows, ssgi)
from .renderers.hit_lighting import hit_radiance
from .rt.trace import scene_trace_closest
from .sky import env as sky_env_mod
from .sky.atmosphere import sky_radiance
from .world import build_trace_scene, refresh_trace_scene


@dataclass(frozen=True)
class IrcacheConfig:
    """Irradiance-cache shapes (mirror of `kajiya_tpu/renderers/ircache.py`
    IrcacheConfig; the pass itself is ROADMAP section 1, step 6)."""
    cascades: int = 12
    grid_res: int = 32
    max_entries: int = 65536
    rays_per_entry: int = 4
    base_cell_size: float = 0.25
    expire_frames: int = 60
    hysteresis_frames: float = 32.0
    active_budget: int = 16384
    validate_period: int = 3
    validate_rel: float = 0.5
    reposition_rate: float = 0.25


@dataclass(frozen=True)
class WrcConfig:
    """World radiance cache shapes (mirror of `kajiya_tpu/renderers/wrc.py`
    WrcConfig; the pass itself is ROADMAP section 1, step 10)."""
    grid: tuple = (8, 3, 8)
    probe_res: int = 32
    grid_spacing: float = 2.0
    grid_origin: tuple = (-8.0, 0.5, -8.0)


@dataclass(frozen=True)
class RenderConfig:
    """Static frame configuration; same fields and defaults as the JAX one."""

    width: int = 1920
    height: int = 1080
    temporal_upsampling: float = 1.0
    near: float = 0.01
    max_trace_steps: int | None = None
    sun_soft_shadows: bool = True
    primary: str = "raster"
    use_rtdgi: bool = True
    use_rtr: bool = True
    use_ssao: bool = True
    use_taa: bool = True
    use_ircache: bool = True
    ircache_feeds_gi: bool = True
    use_restir_gi: bool = True
    use_mesh_light_specular: bool = False
    use_wrc: bool = False
    wrc: WrcConfig = field(default_factory=WrcConfig)
    use_motion_blur: bool = True
    motion_blur_scale: float = 0.5
    use_dof: bool = False
    dof_focus_dist: float = 2.0
    dof_aperture: float = 4.0
    secondary_full_shading: bool = True
    ircache: IrcacheConfig = field(default_factory=IrcacheConfig)
    debug_mode: str = "none"
    ev_shift: float = 0.0
    dt: float = 1.0 / 60.0
    force_face_normals: bool = False
    no_normal_maps: bool = False
    no_metal: bool = False
    roughness_scale: float = 1.0

    @property
    def out_width(self):
        return int(round(self.width * self.temporal_upsampling))

    @property
    def out_height(self):
        return int(round(self.height * self.temporal_upsampling))


def check_supported(cfg: RenderConfig, ircache_lookup=None, ibl_env=None):
    """Raise NotImplementedError for any pass this slice does not port."""
    missing = [
        (cfg.use_taa, "use_taa (TAA, ROADMAP section 1, step 5)"),
        (cfg.temporal_upsampling != 1.0,
         "temporal_upsampling (TAA super-res, ROADMAP section 1, step 5)"),
        (cfg.use_motion_blur,
         "use_motion_blur (motion blur, ROADMAP section 1, step 5)"),
        (cfg.use_ircache or ircache_lookup is not None,
         "use_ircache (irradiance cache, ROADMAP section 1, step 6)"),
        (cfg.use_rtr, "use_rtr (reflections, ROADMAP section 1, step 8)"),
        (cfg.use_wrc, "use_wrc (world radiance cache, ROADMAP section 1, "
                      "step 10)"),
        (cfg.use_dof, "use_dof (depth of field, ROADMAP section 1, step 10)"),
        (ibl_env is not None, "ibl_env (IBL sky, ROADMAP section 1, step 10)"),
        (cfg.primary != "raster",
         f"primary={cfg.primary!r} (raytraced gbuffer, ROADMAP section 1, "
         "step 3)"),
    ]
    asked = [msg for on, msg in missing if on]
    if asked:
        raise NotImplementedError(
            "not ported to kajiya_tpu_torch yet: " + "; ".join(asked))


@lru_cache(maxsize=1)
def _halton_jitter():
    return torch.as_tensor(rng_mod.halton23_sequence(128) - 0.5)


def jitter_for_frame(frame_idx, enabled: bool = True):
    """(2,) sub-pixel jitter in [-0.5, 0.5) for TAA (CPU tensor)."""
    if not enabled:
        return torch.zeros((2,), dtype=torch.float32)
    return _halton_jitter()[int(frame_idx) % 128]


def init_frame_state(cfg: RenderConfig, device=None):
    """The temporal-resource dict: the same keys and shapes as the JAX
    `init_frame_state` for the same config."""
    dev = resolve_device(device)
    h, w = cfg.height, cfg.width
    oh, ow = cfg.out_height, cfg.out_width
    hh, hw = h // 2, w // 2

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = {
        "frame_idx": z(dtype=torch.int32),
        "prev_depth": z(h, w),
        "prev_lit": z(h, w, 3),
    }
    state.update(shadows.init_state(h, w, device=dev))
    state.update(ssgi.init_state(h, w, device=dev))
    state.update(rtdgi.init_state(h, w, device=dev))
    state.update(
        rtr_history=z(h, w, 3), rtr_hist_len=z(h, w), rtr_ray_len=z(h, w),
        rtr_res_radiance=z(hh, hw, 3), rtr_res_dir=z(hh, hw, 3),
        rtr_res_t=z(hh, hw), rtr_res_w_sum=z(hh, hw), rtr_res_M=z(hh, hw),
        rtr_res_W=z(hh, hw), rtr_res_p_hat=z(hh, hw))
    state.update(taa_history=z(oh, ow, 3), taa_coverage=z(oh, ow),
                 taa_smooth_var=z(oh, ow, 3), taa_velocity=z(oh, ow, 2))
    state.update(post.init_exposure_state(device=dev))
    if cfg.use_ircache:
        e, s = cfg.ircache.max_entries, cfg.ircache.rays_per_entry
        state.update(
            ircache_pos=z(e, 3), ircache_sh=z(e, 3, 4), ircache_life=z(e),
            ircache_seen=torch.full((e,), -(10 ** 6), dtype=torch.int32,
                                    device=dev),
            ircache_valid=z(e, dtype=torch.bool),
            ircache_ray_dir=z(e, s, 3), ircache_ray_rad=z(e, s, 3))
    if cfg.use_rtdgi and cfg.use_restir_gi:
        state.update(restir_gi.init_state(h, w, device=dev))
    if cfg.use_wrc:
        n = cfg.wrc.grid[0] * cfg.wrc.grid[1] * cfg.wrc.grid[2]
        r = cfg.wrc.probe_res
        state["wrc_atlas"] = z(n, r, r, 3)
    return state


_RTR_KEYS = ("rtr_history", "rtr_hist_len", "rtr_ray_len", "rtr_res_radiance",
             "rtr_res_dir", "rtr_res_t", "rtr_res_w_sum", "rtr_res_M",
             "rtr_res_W", "rtr_res_p_hat")
_TAA_KEYS = ("taa_history", "taa_coverage", "taa_smooth_var", "taa_velocity")


def _reflect(d, n):
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def render_frame(ts, state, view: ViewConstants, cfg: RenderConfig,
                 levels=None, ircache_lookup=None, ibl_env=None):
    """One frame. Returns (new_state, outputs)."""
    check_supported(cfg, ircache_lookup, ibl_env)
    h, w = cfg.height, cfg.width
    frame_idx = state["frame_idx"]
    if levels is not None:
        ts = refresh_trace_scene(ts.gpu)

    # sky: the background is the analytic atmosphere; ambient and reflected
    # sky come from SH9 of a small octahedral env map
    sun_dir = ts.gpu.sun_direction
    sky_env_bg = lambda d: sky_radiance(d, sun_dir)         # noqa: E731
    with pass_scope("sky_env"):
        sky_sh = sky_env_mod.project_sh9(
            sky_env_mod.build_sky_env(sun_dir, res=32))
    sky_env = sky_env_mod.sh9_radiance_fn(sky_sh)
    diffuse_env = sky_env_mod.sh9_irradiance_fn(sky_sh)

    with pass_scope("gbuffer"):
        gb = gbuffer.raster_gbuffer(ts, view, w, h,
                                    no_normal_maps=cfg.no_normal_maps)
    if cfg.force_face_normals:
        gb = dict(gb, normal=gb["geo_normal"])
    if cfg.no_metal:
        gb = dict(gb, metallic=torch.zeros_like(gb["metallic"]))
    if cfg.roughness_scale != 1.0:
        gb = dict(gb, roughness=torch.clamp(
            gb["roughness"] * cfg.roughness_scale, 1e-3, 1.0))

    with pass_scope("reprojection"):
        reproj = reprojection.calculate_reprojection_map(
            gb, state["prev_depth"], view, near=cfg.near)

    if cfg.use_ssao:
        with pass_scope("ssao"):
            ao, ssgi_state = ssgi.ssao_pipeline(
                gb, view, frame_idx,
                {"ssao_history": state["ssao_history"]}, reproj,
                near=cfg.near)
    else:
        ao = torch.ones((h, w), dtype=torch.float32,
                        device=gb["depth"].device)
        ssgi_state = {"ssao_history": state["ssao_history"]}

    if cfg.sun_soft_shadows:
        with pass_scope("shadow_trace"):
            mask = shadows.trace_sun_shadow_mask(ts, gb, frame_idx)
        with pass_scope("shadow_denoise"):
            shadow, shadow_state = shadows.denoise(
                mask, {"moments": state["moments"],
                       "history_len": state["history_len"]},
                reproj, gb, near=cfg.near)
    else:
        shadow = torch.ones_like(ao)
        shadow_state = {"moments": state["moments"],
                        "history_len": state["history_len"]}

    # --- shared secondary-ray wavefront: the rays of every GI pass are
    # concatenated into single trace + shade calls (GI rays first; the
    # reflection rays append here once RTR is ported)
    restir_state = {k: v for k, v in state.items()
                    if k.startswith("gi_res_")}
    rtdgi_candidates = None
    gi_invalidity = None
    use_gi_restir = cfg.use_rtdgi and cfg.use_restir_gi
    if cfg.use_rtdgi:
        # screen-space radiance reuse reads a decimated copy of last
        # frame's lit image: halve only while the source stays >= ~480 px
        # wide (4x at production resolutions, none for tiny test frames)
        prev_lit_q, prev_depth_q = state["prev_lit"], state["prev_depth"]
        while prev_lit_q.shape[1] >= 960:
            prev_lit_q = im.downsample_2x(prev_lit_q)
            prev_depth_q = im.downsample_nearest(prev_depth_q)
        shade_kw = dict(prev_lit=prev_lit_q, prev_depth=prev_depth_q,
                        view=view, ircache_lookup=ircache_lookup,
                        max_trace_steps=cfg.max_trace_steps,
                        full_shading=cfg.secondary_full_shading)
        gb_h = rtdgi.half_gbuffer(gb)

        # ---- batched validation of the stored reservoir rays, every third
        # frame: the one host read of the frame index in a frame
        if use_gi_restir:
            with pass_scope("gi_validate"):
                if int(frame_idx) % restir_gi.VALIDATE_PERIOD == 0:
                    org, d, ctx = restir_gi.validation_rays(restir_state,
                                                            gb_h)
                    hit = scene_trace_closest(
                        ts, org, d, t_min=1e-4,
                        max_steps=cfg.max_trace_steps, sort=True)
                    fresh = hit_radiance(ts, hit, d, sky_env, diffuse_env,
                                         **shade_kw)
                    restir_state, gi_invalidity = restir_gi.apply_validation(
                        restir_state, ctx, hit.t, fresh)
                else:
                    gi_invalidity = torch.zeros_like(gb_h["depth"])

        # ---- batched candidate trace + shade
        with pass_scope("gi_trace"):
            org, wi, rng = rtdgi.candidate_rays(gb_h, frame_idx)
            with pass_scope("trace"):
                hit = scene_trace_closest(ts, org, wi, t_min=1e-4,
                                          max_steps=cfg.max_trace_steps,
                                          sort=True)
            with pass_scope("shade"):
                rad, aux = hit_radiance(ts, hit, wi, sky_env, diffuse_env,
                                        rng=rng, return_aux=True, **shade_kw)
            rtdgi_candidates = rtdgi.finish_candidates(
                gb_h, org, wi, hit.hit_mask, hit.t, rad, aux)

    # --- diffuse GI
    if cfg.use_rtdgi:
        with pass_scope("rtdgi"):
            dgi, rtdgi_state, restir_state, _ = rtdgi.rtdgi_pipeline(
                ts, gb, view, frame_idx,
                {"rtdgi_history": state["rtdgi_history"],
                 "rtdgi_hist_len": state["rtdgi_hist_len"]},
                reproj, sky_env, diffuse_env, ssao=ao,
                prev_lit=state["prev_lit"], prev_depth=state["prev_depth"],
                ircache_lookup=ircache_lookup,
                max_trace_steps=cfg.max_trace_steps,
                use_restir=cfg.use_restir_gi,
                restir_state=restir_state if cfg.use_restir_gi else None,
                secondary_full_shading=cfg.secondary_full_shading,
                candidates=rtdgi_candidates, invalidity=gi_invalidity,
                validated=True)
            restir_state = restir_state or {}
    else:
        with pass_scope("sky_ambient"):
            dgi = sky_env_mod.sample_env(
                diffuse_env, gb["normal"].reshape(-1, 3)
            ).reshape(h, w, 3) * ao[..., None]
        rtdgi_state = {"rtdgi_history": state["rtdgi_history"],
                       "rtdgi_hist_len": state["rtdgi_hist_len"]}

    # --- reflections: the sky along the mirror direction until RTR is ported
    with pass_scope("sky_refl"):
        refl = sky_env_mod.sample_env(
            sky_env, _reflect(gb["ray_dir"], gb["normal"]).reshape(-1, 3)
        ).reshape(h, w, 3)
    rtr_state = {k: state[k] for k in _RTR_KEYS}

    # background sky at quarter res, upsampled (it is smooth)
    with pass_scope("sky_bg"):
        if h % 4 == 0 and w % 4 == 0:
            sky_q = sky_env_mod.sample_env(
                sky_env_bg,
                im.decimate2(im.decimate2(gb["ray_dir"])).reshape(-1, 3)
            ).reshape(h // 4, w // 4, 3)
            sky_bg = im.upsample2x_bilinear(im.upsample2x_bilinear(sky_q))
        else:
            sky_bg = sky_env_mod.sample_env(
                sky_env_bg, gb["ray_dir"].reshape(-1, 3)).reshape(h, w, 3)
    with pass_scope("deferred"):
        lit = deferred.light_gbuffer(
            gb, shadow, dgi, refl, sky_bg, ts.gpu.sun_radiance,
            ts.gpu.sun_direction, ssao=ao, debug_mode=cfg.debug_mode)

    # without TAA nothing temporal runs pre-exposed: pre_mult stays 1
    pre_mult = torch.ones_like(state["pre_mult"])
    aa = lit
    taa_state = {k: state[k] for k in _TAA_KEYS}

    with pass_scope("post"):
        exposure, exp_state = post.update_exposure(
            {"smoothed_ev": state["smoothed_ev"]}, lit, dt=cfg.dt,
            ev_shift=cfg.ev_shift)
        final = post.post_combine(aa, exposure / pre_mult)

    passthrough = {k: v for k, v in state.items()
                   if k.startswith(("ircache_", "wrc_"))}
    new_state = {
        "frame_idx": frame_idx + 1,
        "prev_depth": gb["depth"],
        "prev_lit": lit,
        "pre_mult": pre_mult,
        **shadow_state, **ssgi_state, **rtdgi_state, **rtr_state,
        **taa_state, **exp_state, **passthrough, **restir_state,
    }
    outputs = {
        "final": final, "lit": lit, "gbuffer": gb, "shadow": shadow,
        "ssao": ao, "diffuse_gi": dgi, "reflections": refl,
        "reproj": reproj, "exposure": exposure, "taa": aa,
    }
    return new_state, outputs


class Renderer:
    """Owns the scene tables, trace scene and FrameState on one device.

    `draw` keeps the last-good-frame behaviour of the JAX Renderer: after a
    first good frame, a failing frame leaves the state untouched, logs the
    error once and returns the last good outputs; on the first frame the
    error (a kernel launch error included) propagates."""

    def __init__(self, scene, cfg: RenderConfig = RenderConfig(), device=None):
        from .scene.scene import build_gpu_scene

        self.device = resolve_device(device)
        check_supported(cfg)
        self.gpu = build_gpu_scene(scene, device=self.device)
        if int(self.gpu.num_lights) > 0 and cfg.use_rtr:
            cfg = replace(cfg, use_mesh_light_specular=True)
        self.cfg = cfg
        self.ts, _ = build_trace_scene(self.gpu, device=self.device)
        self.state = init_frame_state(cfg, device=self.device)
        self._transforms_changed = False
        self._last_good = None
        self._last_error = None

    def draw(self, view: ViewConstants):
        """Render one frame, advancing the temporal state."""
        try:
            if self._transforms_changed:
                self.ts = refresh_trace_scene(self.ts.gpu)
                self._transforms_changed = False
            self.state, outputs = render_frame(
                self.ts, self.state, view.to(self.device), self.cfg)
            self._last_good = outputs
            self._last_error = None
            return outputs
        except Exception as e:  # noqa: BLE001 - keep presenting, as the JAX one
            if self._last_good is None:
                raise
            msg = f"{type(e).__name__}: {e}"
            if msg != self._last_error:
                logging.getLogger("kajiya_tpu_torch").error(
                    "frame failed, presenting last good frame - %s", msg)
                self._last_error = msg
            return self._last_good

    def set_transforms(self, xforms):
        """Update instance transforms (I, 3, 4); previous transforms roll.
        The trace scene is rebuilt at the next draw."""
        gpu = self.ts.gpu
        gpu.xforms_prev = gpu.xforms
        gpu.xforms = torch.as_tensor(xforms, dtype=torch.float32,
                                     device=self.device)
        self._transforms_changed = True

    def jitter(self, enabled: bool = True):
        return jitter_for_frame(self.state["frame_idx"], enabled)
