"""Frame assembly over an explicit FrameState (port of `kajiya_tpu/frame.py`).

    state', outputs = render_frame(trace_scene, state, view, cfg)

The frame: sky (the atmosphere, or an IBL env map) -> gbuffer (raster, or
traced camera rays) -> reprojection -> irradiance cache (allocate, trace,
value grid) -> SSAO -> sun shadow trace + denoise -> world radiance cache
(opt-in) -> the shared secondary-ray wavefront (every-third-frame validation
of the GI and reflection reservoirs, then the GI candidate and reflection
rays traced and shaded together) -> diffuse GI (ReSTIR temporal + spatial,
resolve, temporal filter) -> reflections (mesh-light specular, ReSTIR
temporal, lobe resolve, temporal filter) -> deferred lighting -> the
pre-exposure split -> TAA -> motion blur -> depth of field (opt-in) ->
exposure + post. Every option of the JAX `RenderConfig` is ported.

    state', outputs = render_frame_reference(trace_scene, state, view, cfg)

is the reference path tracer's progressive frame (the oracle).

    state', outputs = render_frame(..., band=band)

renders one rank's row band of the frame (parallel/: `band` is a
`parallel.comm.Band` of the render-res frame, `out_band` that of the output
frame under temporal super-resolution; the state and outputs are the
bands' planes); the passes fetch what they read outside the band through
the band's collectives, the irradiance cache's tables stay whole and the
same on every rank, and the world radiance cache's atlas is split over its
probes. The banded frame takes no IBL env map (`check_supported`).

PyTorch runs eagerly; there is no jit (docs/port_eager.md). Hot reload
(`core/reload.py`) swaps edited modules and kernels in; `draw` looks
`render_frame` up in this module's globals, which a reload refills, so the
next frame runs the fresh code. The hybrid frame
reads its frame index on the host once (the validation branch); everything
else that depends on it stays on the device, and the path tracer's frame
reads nothing back.
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
from .renderers import (deferred, gbuffer, ircache, post, reprojection,
                        restir_gi, rtdgi, rtr, shadows, ssgi, taa)
from .renderers import wrc as wrc_mod
from .renderers.hit_lighting import hit_radiance
from .renderers.ircache import IrcacheConfig
from .renderers.wrc import WrcConfig
from .rt.trace import scene_trace_closest
from .sky import env as sky_env_mod
from .sky.atmosphere import sky_radiance
from .world import build_trace_scene, refresh_trace_scene


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


def check_supported(cfg: RenderConfig, ibl_env=None, sharded: bool = False):
    """Every `RenderConfig` option of the JAX frame and its `ibl_env` are
    ported, and the row-banded frame (`sharded`) runs every configuration.
    The banded frame takes no IBL env map, as JAX's sharded entry points
    (`kajiya_tpu.parallel.mesh.render_frame_sharded` and
    `render_frame_multihost`) render without one: one given raises
    NotImplementedError."""
    if sharded and ibl_env is not None:
        raise NotImplementedError(
            "the sharded frame takes no IBL env map: JAX's sharded entry "
            "points (kajiya_tpu.parallel.mesh.render_frame_sharded, "
            "render_frame_multihost) render the atmosphere sky")


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
    state.update(rtr.init_state(h, w, device=dev))
    state.update(taa.init_state(cfg.out_height, cfg.out_width, device=dev))
    state.update(post.init_exposure_state(device=dev))
    if cfg.use_ircache:
        state.update(ircache.init_state(cfg.ircache, device=dev))
    if cfg.use_rtdgi and cfg.use_restir_gi:
        state.update(restir_gi.init_state(h, w, device=dev))
    if cfg.use_wrc:
        state.update(wrc_mod.init_state(cfg.wrc, device=dev))
    return state


def _reflect(d, n):
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def ircache_queries(gb, h: int, w: int, band=None):
    """The cache's query points: the gbuffer decimated by the smallest power
    of two stride (at least 4) that keeps them within 32,768. With `band`
    (gb's), the bands' points are all-gathered, in band order: the whole
    frame's points in its row-major order, on every rank."""
    stride = 4
    while (h // stride) * (w // stride) > 32768:
        stride *= 2
    q_pos, q_mask = gb["pos"], gb["hit"]
    sy = stride
    while sy > 1:
        q_pos = im.decimate2(q_pos)
        q_mask = im.decimate2(q_mask)
        sy //= 2
    if band is not None:
        if any(a % stride for a, _b in band.rows):
            raise NotImplementedError(
                f"ircache query stride {stride} does not divide the band "
                f"edges {band.rows}")
        q = band.scaled(stride).gather(
            torch.cat([q_pos, q_mask[..., None].to(q_pos.dtype)], dim=-1),
            label="ircache queries", ircache=True)
        q_pos, q_mask = q[..., :3], q[..., 3] > 0.5
    return q_pos.reshape(-1, 3), q_mask.reshape(-1)


def pre_exposure(pre_prev, smoothed_ev, use_taa: bool):
    """(pre_mult, pre_delta) of a frame: pre_mult chases last frame's
    metered exposure with a 0.9 / 0.1 EMA while TAA runs (1 otherwise);
    pre_delta = pre_mult over last frame's, by which the temporal history
    is rescaled."""
    if use_taa:
        pre_mult = pre_prev * 0.9 + torch.exp2(smoothed_ev) * 0.1
    else:
        pre_mult = torch.ones_like(pre_prev)
    return pre_mult, pre_mult / torch.clamp(pre_prev, min=1e-20)


def render_frame(ts, state, view: ViewConstants, cfg: RenderConfig,
                 levels=None, ircache_lookup=None, ibl_env=None, band=None,
                 out_band=None):
    """One frame. Returns (new_state, outputs). `ircache_lookup`, when
    given, replaces the frame's own irradiance cache (which is then left
    as it is). `band`: render this row band of the frame (parallel/);
    `out_band`: its band of the (cfg.out_height, cfg.out_width) output
    frame, needed when that is not the render size."""
    h, w = cfg.height, cfg.width
    same_res = (cfg.out_height, cfg.out_width) == (h, w)
    taa_band = band if same_res else out_band
    if band is not None:
        check_supported(cfg, ibl_env, sharded=True)
        if taa_band is None:
            raise ValueError("a banded frame under temporal "
                             "super-resolution needs its output band")
    rows = h if band is None else band.n        # this frame's rows
    mts = cfg.max_trace_steps
    frame_idx = state["frame_idx"]
    if levels is not None:
        with pass_scope("tlas_refit"):
            ts = refresh_trace_scene(ts.gpu, ts.bvh, levels)

    # sky: an IBL env map replaces the atmosphere when given (background and
    # secondary rays sample the map; ambient is its SH9 irradiance).
    # Otherwise the background is the analytic atmosphere, and ambient and
    # reflected sky come from SH9 of a small octahedral env map
    if ibl_env is not None:
        sky_env = sky_env_bg = ibl_env
        with pass_scope("sky_env"):
            diffuse_env = sky_env_mod.sh9_irradiance_fn(
                sky_env_mod.project_sh9(ibl_env))
    else:
        sun_dir = ts.gpu.sun_direction
        sky_env_bg = lambda d: sky_radiance(d, sun_dir)     # noqa: E731
        with pass_scope("sky_env"):
            sky_sh = sky_env_mod.project_sh9(
                sky_env_mod.build_sky_env(sun_dir, res=32))
        sky_env = sky_env_mod.sh9_radiance_fn(sky_sh)
        diffuse_env = sky_env_mod.sh9_irradiance_fn(sky_sh)

    with pass_scope("gbuffer"):
        primary = (gbuffer.raster_gbuffer if cfg.primary == "raster"
                   else gbuffer.raytrace_gbuffer)
        kw = {} if band is None else {"band": band}
        gb = primary(ts, view, w, h, max_trace_steps=mts,
                     no_normal_maps=cfg.no_normal_maps, **kw)
    if cfg.force_face_normals:
        gb = dict(gb, normal=gb["geo_normal"])
    if cfg.no_metal:
        gb = dict(gb, metallic=torch.zeros_like(gb["metallic"]))
    if cfg.roughness_scale != 1.0:
        gb = dict(gb, roughness=torch.clamp(
            gb["roughness"] * cfg.roughness_scale, 1e-3, 1.0))

    with pass_scope("reprojection"):
        reproj = reprojection.calculate_reprojection_map(
            gb, state["prev_depth"], view, near=cfg.near, band=band)

    # --- irradiance cache: allocate from quarter-res (or coarser) surface
    # query points, trace per-entry rays, expose the lookup to every
    # downstream pass
    ir_state = {k: v for k, v in state.items() if k.startswith("ircache_")}
    if cfg.use_ircache and ircache_lookup is None:
        eye = view.eye_position
        q_pos, q_mask = ircache_queries(gb, h, w, band)
        with pass_scope("ircache"):
            with pass_scope("ircache_alloc"):
                grid0 = ircache.build_grid(ir_state, eye, cfg.ircache)
                ir_state = ircache.allocate(ir_state, grid0, q_pos, q_mask,
                                            eye, frame_idx, cfg.ircache)
            with pass_scope("ircache_trace"):
                ir_state = ircache.trace_update(
                    ir_state, ts, sky_env, diffuse_env, eye, frame_idx,
                    cfg.ircache, max_trace_steps=mts,
                    secondary_full_shading=cfg.secondary_full_shading,
                    band=band)
            with pass_scope("ircache_value_grid"):
                ir_grid = ircache.build_value_grid(
                    ir_state, ircache.build_grid(ir_state, eye, cfg.ircache),
                    cfg.ircache)

        def ircache_lookup(p, n, _st=ir_state, _g=ir_grid, _e=eye):
            return ircache.lookup_irradiance(_st, _g, p, n, _e, diffuse_env,
                                             cfg.ircache)

        if not cfg.ircache_feeds_gi:
            ircache_lookup = None

    if cfg.use_ssao:
        with pass_scope("ssao"):
            ao, ssgi_state = ssgi.ssao_pipeline(
                gb, view, frame_idx,
                {"ssao_history": state["ssao_history"]}, reproj,
                near=cfg.near, band=band)
    else:
        ao = torch.ones((rows, w), dtype=torch.float32,
                        device=gb["depth"].device)
        ssgi_state = {"ssao_history": state["ssao_history"]}

    if cfg.sun_soft_shadows:
        with pass_scope("shadow_trace"):
            mask = shadows.trace_sun_shadow_mask(ts, gb, frame_idx,
                                                 band=band)
        with pass_scope("shadow_denoise"):
            shadow, shadow_state = shadows.denoise(
                mask, {"moments": state["moments"],
                       "history_len": state["history_len"]},
                reproj, gb, near=cfg.near, band=band)
    else:
        shadow = torch.ones_like(ao)
        shadow_state = {"moments": state["moments"],
                        "history_len": state["history_len"]}

    # --- shared secondary-ray wavefront: the GI candidate rays and the
    # reflection rays, and both passes' every-third-frame validation
    # re-traces, are concatenated (GI first) into single trace + shade calls
    restir_state = {k: v for k, v in state.items()
                    if k.startswith("gi_res_")}
    rtr_state_in = {k: state[k] for k in rtr.KEYS}
    rtdgi_candidates = None
    gi_invalidity = None
    rtr_half = None
    use_gi_restir = cfg.use_rtdgi and cfg.use_restir_gi
    use_rtr_restir = cfg.use_rtr

    # --- world radiance cache (opt-in): trace the probes, expose the lookup
    # to the secondary hit lighting
    wrc_state = {}
    wrc_lookup = None
    if cfg.use_wrc:
        probes = (None if band is None
                  else wrc_mod.probe_band(cfg.wrc, band.comm))
        with pass_scope("wrc"):
            wrc_state = wrc_mod.trace_wrc(
                {"wrc_atlas": state["wrc_atlas"]}, ts, sky_env, diffuse_env,
                frame_idx, cfg.wrc, max_trace_steps=mts, probes=probes)
            wrc_all = wrc_state if probes is None else {
                "wrc_atlas": probes.gather(wrc_state["wrc_atlas"],
                                           label="wrc atlas")}

        def wrc_lookup(p, d, _st=wrc_all, _c=cfg.wrc):
            return wrc_mod.lookup(_st, _c, p, d)

    if cfg.use_rtdgi or cfg.use_rtr:
        # screen-space radiance reuse reads a decimated copy of last
        # frame's lit image: halve only while the source stays >= ~480 px
        # wide (4x at production resolutions, none for tiny test frames)
        prev_lit_q, prev_depth_q = state["prev_lit"], state["prev_depth"]
        while prev_lit_q.shape[1] >= 960:
            prev_lit_q = im.downsample_2x(prev_lit_q)
            prev_depth_q = im.downsample_nearest(prev_depth_q)
        if band is not None:
            # a secondary hit projects anywhere on screen: the reuse source
            # is gathered whole (one packed plane, at its own resolution)
            k = w // prev_lit_q.shape[1]
            src = band.scaled(k).gather(
                torch.cat([prev_lit_q, prev_depth_q[..., None]], dim=-1),
                label="screen reuse source")
            prev_lit_q, prev_depth_q = src[..., :3], src[..., 3]
        shade_kw = dict(prev_lit=prev_lit_q, prev_depth=prev_depth_q,
                        view=view, ircache_lookup=ircache_lookup,
                        max_trace_steps=mts,
                        full_shading=cfg.secondary_full_shading,
                        wrc_lookup=wrc_lookup)
        gb_h = rtdgi.half_gbuffer(gb)

        # ---- batched validation of both passes' stored reservoir rays,
        # every third frame: the one host read of the frame index
        if use_gi_restir or use_rtr_restir:
            with pass_scope("gi_validate"):
                if int(frame_idx) % restir_gi.VALIDATE_PERIOD == 0:
                    orgs, dirs = [], []
                    if use_gi_restir:
                        oa, da, ctx_a = restir_gi.validation_rays(
                            restir_state, gb_h)
                        orgs.append(oa)
                        dirs.append(da)
                    if use_rtr_restir:
                        ob, db, ctx_b = rtr.validation_rays(rtr_state_in, gb)
                        orgs.append(ob)
                        dirs.append(db)
                    d = torch.cat(dirs)
                    hit = scene_trace_closest(ts, torch.cat(orgs), d,
                                              t_min=1e-4, max_steps=mts,
                                              sort=True)
                    fresh = hit_radiance(ts, hit, d, sky_env, diffuse_env,
                                         **shade_kw)
                    na = orgs[0].shape[0] if use_gi_restir else 0
                    if use_gi_restir:
                        restir_state, gi_invalidity = \
                            restir_gi.apply_validation(
                                restir_state, ctx_a, hit.t[:na], fresh[:na])
                    if use_rtr_restir:
                        rtr_state_in = rtr.apply_validation(
                            rtr_state_in, ctx_b, hit.t[na:], fresh[na:],
                            band)
                elif use_gi_restir:
                    gi_invalidity = torch.zeros_like(gb_h["depth"])

        # ---- batched candidate + reflection trace and shade
        with pass_scope("gi_trace"):
            orgs, dirs, rngs = [], [], []
            if cfg.use_rtdgi:
                org_c, wi_c, rng_c = rtdgi.candidate_rays(
                    gb_h, frame_idx, None if band is None else band.half())
                orgs.append(org_c)
                dirs.append(wi_c)
                rngs.append(rng_c)
            if cfg.use_rtr:
                org_r, wi_r, pdf_r, rng_r = rtr.reflection_rays(gb, frame_idx,
                                                                band)
                orgs.append(org_r)
                dirs.append(wi_r)
                rngs.append(rng_r)
            d = torch.cat(dirs)
            with pass_scope("trace"):
                hit = scene_trace_closest(ts, torch.cat(orgs), d, t_min=1e-4,
                                          max_steps=mts, sort=True)
            with pass_scope("shade"):
                rad, aux = hit_radiance(ts, hit, d, sky_env, diffuse_env,
                                        rng=torch.cat(rngs), return_aux=True,
                                        **shade_kw)
            nc = orgs[0].shape[0] if cfg.use_rtdgi else 0
            if cfg.use_rtdgi:
                rtdgi_candidates = rtdgi.finish_candidates(
                    gb_h, org_c, wi_c, hit.hit_mask[:nc], hit.t[:nc],
                    rad[:nc], {"hit_pos": aux["hit_pos"][:nc],
                               "hit_geo_normal": aux["hit_geo_normal"][:nc]})
            if cfg.use_rtr:
                rtr_half = rtr.finish_reflections(gb, wi_r, pdf_r,
                                                  hit.t[nc:], rad[nc:])

    # --- diffuse GI
    if cfg.use_rtdgi:
        with pass_scope("rtdgi"):
            dgi, rtdgi_state, restir_state, rtdgi_candidates = \
                rtdgi.rtdgi_pipeline(
                    ts, gb, view, frame_idx,
                    {"rtdgi_history": state["rtdgi_history"],
                     "rtdgi_hist_len": state["rtdgi_hist_len"]},
                    reproj, sky_env, diffuse_env, ssao=ao,
                    prev_lit=state["prev_lit"],
                    prev_depth=state["prev_depth"],
                    ircache_lookup=ircache_lookup, max_trace_steps=mts,
                    use_restir=cfg.use_restir_gi,
                    restir_state=restir_state if cfg.use_restir_gi else None,
                    secondary_full_shading=cfg.secondary_full_shading,
                    candidates=rtdgi_candidates, invalidity=gi_invalidity,
                    validated=True, band=band)
            restir_state = restir_state or {}
    else:
        with pass_scope("sky_ambient"):
            dgi = sky_env_mod.sample_env(
                diffuse_env, gb["normal"].reshape(-1, 3)
            ).reshape(rows, w, 3) * ao[..., None]
        rtdgi_state = {"rtdgi_history": state["rtdgi_history"],
                       "rtdgi_hist_len": state["rtdgi_hist_len"]}

    # --- reflections
    if cfg.use_rtr:
        with pass_scope("rtr"):
            refl, rtr_state = rtr.rtr_pipeline(
                ts, gb, view, frame_idx, rtr_state_in, reproj, sky_env,
                diffuse_env, prev_lit=state["prev_lit"],
                prev_depth=state["prev_depth"],
                ircache_lookup=ircache_lookup, max_trace_steps=mts,
                half=rtr_half,
                mesh_light_specular=cfg.use_mesh_light_specular,
                rtdgi_candidates=rtdgi_candidates,
                secondary_full_shading=cfg.secondary_full_shading,
                validated=True, band=band)
    else:
        with pass_scope("sky_refl"):
            refl = sky_env_mod.sample_env(
                sky_env, _reflect(gb["ray_dir"], gb["normal"]).reshape(-1, 3)
            ).reshape(rows, w, 3)
        rtr_state = {k: state[k] for k in rtr.KEYS}

    # background sky at quarter res, upsampled (it is smooth)
    with pass_scope("sky_bg"):
        if h % 4 == 0 and w % 4 == 0:
            dirs_q = im.decimate2(im.decimate2(gb["ray_dir"]))
            sky_q = sky_env_mod.sample_env(
                sky_env_bg, dirs_q.reshape(-1, 3)
            ).reshape(dirs_q.shape[0], w // 4, 3)
            if band is None:
                sky_bg = im.upsample2x_bilinear(im.upsample2x_bilinear(sky_q))
            else:
                sky_bg = im.upsample2x_bilinear(
                    im.upsample2x_bilinear(sky_q, band.scaled(4)),
                    band.scaled(2))
        else:
            sky_bg = sky_env_mod.sample_env(
                sky_env_bg, gb["ray_dir"].reshape(-1, 3)).reshape(rows, w, 3)
    with pass_scope("deferred"):
        lit = deferred.light_gbuffer(
            gb, shadow, dgi, refl, sky_bg, ts.gpu.sun_radiance,
            ts.gpu.sun_direction, ssao=ao, debug_mode=cfg.debug_mode)

    # --- pre-exposure split: pre_mult chases last frame's metered exposure
    # (0.9 / 0.1 EMA); everything temporal downstream of `lit` runs
    # pre-exposed, history is rescaled by this frame's pre_mult delta, and
    # post applies only the remaining exposure / pre_mult
    pre_mult, pre_delta = pre_exposure(state["pre_mult"],
                                       state["smoothed_ev"], cfg.use_taa)

    # --- TAA (temporal super-res)
    if cfg.use_taa:
        with pass_scope("taa"):
            aa, taa_state = taa.taa(
                lit * pre_mult, {k: state[k] for k in taa.KEYS},
                reproj, gb["depth"], view.sample_offset_pixels,
                cfg.out_height, cfg.out_width, pre_delta=pre_delta,
                band=band, out_band=taa_band)
    else:
        aa = lit
        taa_state = {k: state[k] for k in taa.KEYS}
    upsampled = cfg.use_taa and not same_res
    aa_band = taa_band if upsampled else band       # the band `aa` holds

    def at_output(x):
        """A render-res plane at the size of `aa`."""
        if not upsampled:
            return x
        return im.upsample_bilinear(x, cfg.out_height, cfg.out_width, band,
                                    aa_band)

    # --- motion blur (taa -> motion blur -> post)
    if cfg.use_motion_blur:
        from .renderers import motion_blur as mb

        vel_out = at_output(gb["velocity"])
        depth_for_mb = at_output(gb["depth"])
        with pass_scope("motion_blur"):
            aa = mb.motion_blur(aa, vel_out, depth_for_mb,
                                frame_fraction=cfg.motion_blur_scale,
                                band=aa_band)

    # --- depth of field (opt-in): CoC + gather after motion blur
    if cfg.use_dof:
        from .renderers import dof as dof_mod

        depth_for_dof = at_output(gb["depth"])
        with pass_scope("dof"):
            aa = dof_mod.dof_gather(aa, depth_for_dof, cfg.dof_focus_dist,
                                    cfg.dof_aperture, near=cfg.near,
                                    band=aa_band)

    # --- post: exposure + glare + tonemap; `aa` is pre-exposed, so post
    # applies only the remainder (the exposure meters `lit`, at render res)
    with pass_scope("post"):
        exposure, exp_state = post.update_exposure(
            {"smoothed_ev": state["smoothed_ev"]}, lit, dt=cfg.dt,
            ev_shift=cfg.ev_shift, band=band)
        final = post.post_combine(aa, exposure / pre_mult, band=aa_band)

    new_state = {
        "frame_idx": frame_idx + 1,
        "prev_depth": gb["depth"],
        "prev_lit": lit,
        "pre_mult": pre_mult,
        **shadow_state, **ssgi_state, **rtdgi_state, **rtr_state,
        **taa_state, **exp_state, **ir_state, **restir_state, **wrc_state,
    }
    outputs = {
        "final": final, "lit": lit, "gbuffer": gb, "shadow": shadow,
        "ssao": ao, "diffuse_gi": dgi, "reflections": refl,
        "reproj": reproj, "exposure": exposure, "taa": aa,
    }
    return new_state, outputs


# ----------------------------------------------------------------------------
# Reference path-tracing mode (the oracle)
# ----------------------------------------------------------------------------

def init_reference_state(cfg: RenderConfig, device=None):
    """The progressive accumulator, its sample count and the exposure."""
    dev = resolve_device(device)
    return {
        "refpt_accum": torch.zeros((cfg.height, cfg.width, 3),
                                   dtype=torch.float32, device=dev),
        "refpt_samples": torch.zeros((), dtype=torch.float32, device=dev),
        "smoothed_ev": torch.zeros((), dtype=torch.float32, device=dev),
    }


def render_frame_reference(ts, state, view: ViewConstants, cfg: RenderConfig,
                           levels=None, num_bounces: int = 16,
                           spp_per_frame: int = 1, max_spp: float = 1000.0,
                           pixel_filter: bool = True):
    """One progressive reference-PT frame: trace spp_per_frame paths a
    pixel, blend them into the accumulator (up to max_spp, the reference's
    1000-spp cap), then run the post chain. Returns (new_state, outputs).
    The sample count that seeds the hashes stays on the device."""
    from .renderers import reference as refpt

    if levels is not None:
        with pass_scope("tlas_refit"):
            ts = refresh_trace_scene(ts.gpu, ts.bvh, levels)

    # PT ray cone: the reference shrinks the pixel cone to 0.3x for its
    # path tracer
    pt_spread = 0.3 * 2.0 / (view.view_to_clip[1, 1] * cfg.height)
    with pass_scope("refpt"):
        frame_radiance = refpt.render_sample(
            ts, view, cfg.width, cfg.height,
            frame_idx=state["refpt_samples"].to(torch.int32),
            spp_chunk=spp_per_frame, num_bounces=num_bounces,
            max_trace_steps=cfg.max_trace_steps, pixel_filter=pixel_filter,
            cone_spread=pt_spread)

    n = torch.clamp(state["refpt_samples"], max=max_spp)
    accum = (state["refpt_accum"]
             + (frame_radiance - state["refpt_accum"]) / (n + 1.0))

    with pass_scope("post"):
        exposure, exp_state = post.update_exposure(
            {"smoothed_ev": state["smoothed_ev"]}, accum, dt=cfg.dt,
            ev_shift=cfg.ev_shift)
        final = post.post_combine(accum, exposure)

    new_state = {"refpt_accum": accum, "refpt_samples": n + 1.0,
                 **exp_state}
    return new_state, {"final": final, "lit": accum, "exposure": exposure}


class Renderer:
    """Owns the scene tables, trace scene and FrameState on one device.

    `draw` keeps the last-good-frame behaviour of the JAX Renderer: after a
    first good frame, a failing frame leaves the state untouched, logs the
    error once and returns the last good outputs; on the first frame the
    error (a kernel launch error included) propagates. Scenes above
    CULLED_BRUTE_MAX_TRIS triangles take the BVH route
    (`build_trace_scene`); `levels` keeps its refit schedule.

    The trace scene bakes the scene tables (`ts.gpu`) into its world
    geometry, attribute rows and light list, so a change to them
    (`set_transforms`, `set_emissive`) is counted and the next `draw`
    refreshes it once; a change made while a refresh runs (the live
    viewer's HTTP thread) is caught by the next draw. The JAX Renderer
    refreshes it in every frame."""

    def __init__(self, scene, cfg: RenderConfig = RenderConfig(), device=None,
                 ibl: str | None = None):
        from .scene.scene import build_gpu_scene

        self.device = resolve_device(device)
        self.gpu = build_gpu_scene(scene, device=self.device)
        if int(self.gpu.num_lights) > 0 and cfg.use_rtr:
            cfg = replace(cfg, use_mesh_light_specular=True)
        self.cfg = cfg
        self.ts, self.levels = build_trace_scene(self.gpu,
                                                 device=self.device)
        self.state = init_frame_state(cfg, device=self.device)
        self.ibl_env = None
        if ibl is not None:
            from .sky.ibl import load_ibl_env

            self.ibl_env = load_ibl_env(ibl, device=self.device)
        self._scene_changes = 0       # changes made to the scene tables
        self._ts_changes = 0          # ... that self.ts was built from
        self._last_good = None
        self._last_error = None

    def rebuild(self):
        """The JAX Renderer's re-trace after a hot reload or a config
        change; a no-op here, kept for the callers (`apps/stream.py`,
        `apps/view.py --watch`). Nothing is traced, and `draw` calls
        `render_frame` through this module's globals, which
        `importlib.reload` refills, so a reloaded frame module is live at
        the next frame. The temporal state is kept."""

    def draw(self, view: ViewConstants):
        """Render one frame, advancing the temporal state."""
        try:
            changes = self._scene_changes
            if changes != self._ts_changes:
                with pass_scope("tlas_refit"):
                    self.ts = refresh_trace_scene(self.ts.gpu, self.ts.bvh,
                                                  self.levels)
                self._ts_changes = changes
            self.state, outputs = render_frame(
                self.ts, self.state, view.to(self.device), self.cfg,
                ibl_env=self.ibl_env)
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
        The trace scene is rebuilt (the BVH refit) at the next draw."""
        gpu = self.ts.gpu
        gpu.xforms_prev = gpu.xforms
        gpu.xforms = torch.as_tensor(xforms, dtype=torch.float32,
                                     device=self.device)
        self._scene_changes += 1

    def set_emissive(self, values):
        """Replace the per-material emissive radiance (M, 3); the attribute
        rows and the light list are rebuilt at the next draw."""
        self.ts.gpu.mat_emissive = torch.as_tensor(
            values, dtype=torch.float32, device=self.device)
        self._scene_changes += 1

    def jitter(self, enabled: bool = True):
        return jitter_for_frame(self.state["frame_idx"], enabled)
