"""Trace-ready scene bundle + hit attribute fetch (port of
`kajiya_tpu/world.py`).

Every scene up to `brute_max_tris` (default CULLED_BRUTE_MAX_TRIS) triangles
takes the Woop route: the brute tables, plus two cluster granularities above
BRUTE_FORCE_MAX_TRIS for the culled kernel, with the triangle tables
Morton-sorted so consecutive blocks are spatially compact. Larger scenes take
the BVH route: a skip-link BVH built once (rt/bvh.py), refit on each refresh,
and no Woop tables (`woop` is None). The Woop route reads no BVH, so none is
built there (`bvh` is None), unlike the JAX package, which always builds one;
no output changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .core.profiling import pass_scope
from .device import resolve_device
from .ops.gather import interp3_rows
from .ops.smallvec import cross, dot3, norm3
from .scene.scene import GpuScene

BRUTE_FORCE_MAX_TRIS = 8192
CULLED_BRUTE_MAX_TRIS = 262_144


@dataclass
class TraceScene:
    """Everything needed to trace + shade: scene tables, world-space
    triangle SoA, Woop tables or the BVH, and the consolidated attribute
    tables."""

    gpu: GpuScene
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    inst_rot: torch.Tensor        # (I, 9) row-major rotation per instance
    light_v0: torch.Tensor        # (L, 3) emissive triangle corners
    light_e1: torch.Tensor
    light_e2: torch.Tensor
    light_area: torch.Tensor      # (L,)
    light_emission: torch.Tensor  # (L, 3)
    light_normal: torch.Tensor    # (L, 3)
    woop: Any                     # dict from ops.woop.build_woop (+ clusters)
    tri_attrs: torch.Tensor       # (T, 35) per-triangle attributes
    vert_attrs: torch.Tensor      # (V, 9) object-space normal + uv + tangent
    bvh: Any = None               # rt.bvh.Bvh on the BVH route (woop None)
    walk_tables: Any = None       # rt.bvh.pack_walk_tables(bvh, tris)

    @property
    def tris(self):
        return (self.v0, self.e1, self.e2)


def build_trace_scene(gpu: GpuScene, device=None, leaf_size: int = 4,
                      brute_max_tris: int = CULLED_BRUTE_MAX_TRIS):
    """Build the trace bundle on `device` (default CUDA; raises without it).
    Returns (TraceScene, levels) like the JAX function. Above
    `brute_max_tris` triangles the BVH route: `levels` is {"levels": the
    refit schedule as device index tensors, "use_brute": False}; otherwise
    {"use_brute": True}. `render_frame` given `levels` refreshes the trace
    scene every frame (and refits the BVH)."""
    dev = resolve_device(device)
    gpu = gpu.to(dev)
    if gpu.num_triangles > brute_max_tris:
        from .rt.bvh import bvh_from_scene, refit_schedule

        bvh, lv, _ = bvh_from_scene(gpu, leaf_size=leaf_size)
        levels = {"levels": refit_schedule(lv, dev), "use_brute": False}
        return refresh_trace_scene(gpu, bvh, levels), levels
    if gpu.num_triangles > BRUTE_FORCE_MAX_TRIS:
        # Morton-sort the triangle tables so consecutive blocks are compact
        from .rt.bvh import morton3d

        v0, e1, e2 = (t.cpu().numpy() for t in gpu.triangle_corners())
        c = v0 + (e1 + e2) / 3.0
        lo, hi = c.min(axis=0), c.max(axis=0)
        norm = (c - lo) / np.maximum(hi - lo, 1e-12)
        perm = np.argsort(morton3d(norm), kind="stable").astype(np.int32)
        gpu = _permute_triangles(gpu, perm)
    levels = {"use_brute": True}
    return refresh_trace_scene(gpu), levels


def _permute_triangles(gpu: GpuScene, perm: np.ndarray) -> GpuScene:
    """Reorder every triangle-indexed table by `perm`."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    lt = gpu.light_tri.cpu().numpy()
    lt2 = np.where(lt >= 0, inv[np.maximum(lt, 0)], -1).astype(np.int32)
    p = torch.as_tensor(perm, dtype=torch.int64, device=gpu.device)
    kw = dict(gpu.__dict__)
    kw.update(tri_idx=gpu.tri_idx[p], tri_mat=gpu.tri_mat[p],
              tri_inst=gpu.tri_inst[p],
              light_tri=torch.as_tensor(lt2, device=gpu.device))
    return GpuScene(**kw)


def _tri_lod_constant(gpu: GpuScene, e1, e2):
    """(T,) 0.5 * log2(twice_uv_area / twice_world_area) per triangle;
    degenerate UVs give 0."""
    uv = gpu.uvs[gpu.tri_idx.long()]                       # (T, 3, 2)
    duv1 = uv[:, 1] - uv[:, 0]
    duv2 = uv[:, 2] - uv[:, 0]
    uv_area2 = torch.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    w_area2 = norm3(cross(e1, e2))
    ok = (uv_area2 > 1e-20) & (w_area2 > 1e-20)
    return torch.where(ok, 0.5 * torch.log2(torch.clamp(uv_area2, min=1e-20)
                                            / torch.clamp(w_area2, min=1e-20)),
                       0.0)


def _pad_tris(n: int) -> int:
    from .ops.woop import TRI_BLOCK

    if n <= TRI_BLOCK:
        return max(8, -(-n // 8) * 8)
    return -(-n // TRI_BLOCK) * TRI_BLOCK


def refresh_trace_scene(gpu: GpuScene, bvh=None, levels=None) -> TraceScene:
    """Recompute the world geometry and the attribute tables for the current
    transforms, and the tables of the scene's route: with `bvh` (the BVH
    route) its bounds are refit by the schedule in `levels` (the dictionary
    build_trace_scene returns) and the walk kernel's tables repacked;
    without, the Woop and cluster tables are built."""
    from .ops.woop import build_clusters, build_woop
    from .ops.woop_cuda import CULL_TB, attach_coef_tables

    n = gpu.num_triangles
    v0, e1, e2 = gpu.triangle_corners()
    woop = walk_tables = None
    if bvh is not None:
        from .rt.bvh import pack_walk_tables, refit_bvh

        bvh = refit_bvh(bvh, levels["levels"], v0, e1, e2)
        walk_tables = pack_walk_tables(bvh, (v0, e1, e2))
    else:
        pad = _pad_tris(n)
        woop = build_woop(v0, e1, e2, pad_to=pad)
        if n > BRUTE_FORCE_MAX_TRIS:
            woop["cmin"], woop["cmax"] = build_clusters(v0, e1, e2,
                                                        pad_to=pad)
            woop["cmin64"], woop["cmax64"] = build_clusters(
                v0, e1, e2, pad_to=pad, tri_block=CULL_TB)
        attach_coef_tables(woop)     # the tables kernels B and C read

    mt = gpu.tri_mat.long()
    v0p, e1p, e2p = gpu.triangle_corners(gpu.xforms_prev)
    g_cross = cross(e1, e2)
    g_n = g_cross / torch.clamp(norm3(g_cross), min=1e-12)[:, None]
    f32 = torch.float32
    tri_attrs = torch.cat([
        e1, e2, v0,
        gpu.mat_base_color[mt][:, :3],
        gpu.mat_metallic[mt][:, None],
        gpu.mat_roughness[mt][:, None],
        gpu.mat_emissive[mt],
        gpu.tri_mat[:, None].to(f32),
        e1p, e2p, v0p,
        g_n,
        gpu.tri_inst[:, None].to(f32),
        gpu.tri_idx.to(f32),
        _tri_lod_constant(gpu, e1, e2)[:, None],
    ], dim=-1)                                                # (T, 35)
    vert_attrs = torch.cat([gpu.normals_obj, gpu.uvs, gpu.tangents_obj],
                           dim=-1)                            # (V, 9)
    inst_rot = gpu.instance_rotations().reshape(-1, 9)

    lt = torch.clamp(gpu.light_tri, min=0).long()
    lv0, le1, le2 = v0[lt], e1[lt], e2[lt]
    l_cross = cross(le1, le2)
    l_len = norm3(l_cross)
    l_normal = l_cross / torch.clamp(l_len, min=1e-12)[:, None]
    emission = gpu.mat_emissive[mt[lt]]
    live = (gpu.light_tri >= 0)[:, None]
    return TraceScene(
        gpu=gpu, v0=v0, e1=e1, e2=e2, inst_rot=inst_rot,
        light_v0=lv0, light_e1=le1, light_e2=le2,
        light_area=torch.where(live[:, 0], 0.5 * l_len, 0.0),
        light_emission=torch.where(live, emission, 0.0),
        light_normal=l_normal, woop=woop, tri_attrs=tri_attrs,
        vert_attrs=vert_attrs, bvh=bvh, walk_tables=walk_tables)


def hit_attributes(ts: TraceScene, hit, ray_dir, mip: int = 0,
                   no_normal_maps: bool = False, full_shading: bool = True,
                   with_prev_pos: bool = False, cone_width=None):
    """Shading attributes at hit points (the software `gbuffer.rchit`).
    Safe for missed rays (mask with hit.hit_mask). Returns (R, ...) tensors.
    Material, instance and vertex ids come from the int32 tables.

    On a textured scene with `full_shading`, four texture fetches modulate
    the material: base colour (bilinear, sRGB), metallic-roughness (G
    roughness, B metallic), emissive (sRGB) and a tangent-space normal map,
    each nearest but the first. `cone_width` (per-ray footprint at the hit)
    picks each fetch's mip by the ray cone: tri constant + log2(cone_width)
    - log2(|cos|) + log2(texture size); without it the static `mip`."""
    gpu = ts.gpu
    tri = torch.clamp(hit.tri, min=0).long()
    ta = ts.tri_attrs[tri]                                  # (R, 35)
    e1_t, e2_t, v0_t = ta[:, 0:3], ta[:, 3:6], ta[:, 6:9]
    u_l, v_l = hit.u[:, None], hit.v[:, None]
    base_color = ta[:, 9:12]
    metallic = ta[:, 12]
    roughness = ta[:, 13]
    emissive = ta[:, 14:17]

    geo_n = ta[:, 27:30]
    flip = torch.sign(-dot3(geo_n, ray_dir))
    flip = torch.where(flip == 0.0, 1.0, flip)
    geo_n = geo_n * flip[:, None]

    if full_shading:
        idx = gpu.tri_idx[tri].long()
        w = 1.0 - hit.u - hit.v
        va = interp3_rows(ts.vert_attrs, idx[:, 0], idx[:, 1], idx[:, 2],
                          w, hit.u, hit.v)                  # (R, 9)
        rot = ts.inst_rot[gpu.tri_inst[tri].long()]         # (R, 9)

        def rot3(v):
            return torch.stack([
                rot[:, 0] * v[:, 0] + rot[:, 1] * v[:, 1] + rot[:, 2] * v[:, 2],
                rot[:, 3] * v[:, 0] + rot[:, 4] * v[:, 1] + rot[:, 5] * v[:, 2],
                rot[:, 6] * v[:, 0] + rot[:, 7] * v[:, 1] + rot[:, 8] * v[:, 2],
            ], dim=-1)

        nrm = rot3(va[:, 0:3])
        nrm = nrm / torch.clamp(torch.sqrt(dot3(nrm, nrm)), min=1e-12)[:, None]
        normal = torch.where((dot3(nrm, geo_n) < 0.0)[:, None], -nrm, nrm)
        uv = va[:, 3:5]
        tangent = rot3(va[:, 5:8])
        tan_w = va[:, 8]
    else:
        normal = geo_n
        uv = torch.zeros((tri.shape[0], 2), dtype=torch.float32,
                         device=tri.device)

    if gpu.tex_pages is not None and full_shading:
        with pass_scope("tex_fetch"):
            from .scene.textures import sample_pages

            lod_base = None
            if cone_width is not None:
                cos_in = torch.abs(dot3(geo_n, ray_dir))
                lod_base = (ta[:, 34]
                            + torch.log2(torch.clamp(torch.abs(cone_width),
                                                     min=1e-12))
                            - torch.log2(torch.clamp(cos_in, 1e-2, 1.0)))
            slots = gpu.mat_tex[gpu.tri_mat[tri].long()]    # (R, 4)

            def fetch(slot, **kw):
                return sample_pages(gpu.tex_pages, gpu.page_sub,
                                    slots[:, slot], uv, mip=mip,
                                    lod_base=lod_base, **kw)

            # base colour and emissive are sRGB; metallic-roughness (G
            # roughness, B metallic) and normal maps are linear
            bc = fetch(0, srgb=True)
            mr = fetch(1, nearest=True)
            em = fetch(3, nearest=True, srgb=True)
            base_color = base_color * bc[:, :3]
            roughness = torch.clamp(roughness * mr[:, 1], 1e-3, 1.0)
            metallic = torch.clamp(metallic * mr[:, 2], 0.0, 1.0)
            emissive = emissive * em[:, :3]
            # tangent-space normal mapping; lanes without a normal texture
            # or a tangent keep the interpolated normal
            nm = fetch(2, nearest=True)
            tnorm = nm[:, :3] * 2.0 - 1.0
            t_len = torch.sqrt(dot3(tangent, tangent))
            t_ok = (t_len > 1e-4) & (slots[:, 2] > 0)
            t = tangent / torch.clamp(t_len, min=1e-8)[:, None]
            b = cross(normal, t) * tan_w[:, None]
            n_mapped = (t * tnorm[:, 0:1] + b * tnorm[:, 1:2]
                        + normal * tnorm[:, 2:3])
            n_mapped = n_mapped / torch.clamp(
                torch.sqrt(dot3(n_mapped, n_mapped)), min=1e-12)[:, None]
            if not no_normal_maps:
                normal = torch.where(t_ok[:, None], n_mapped, normal)

    out = dict(
        pos=v0_t + e1_t * u_l + e2_t * v_l,
        normal=normal,
        geo_normal=geo_n,
        uv=uv,
        base_color=base_color,
        metallic=metallic,
        roughness=roughness,
        emissive=emissive,
        material=gpu.tri_mat[tri],
    )
    if with_prev_pos:
        e1p, e2p, v0p = ta[:, 18:21], ta[:, 21:24], ta[:, 24:27]
        out["pos_prev"] = v0p + e1p * u_l + e2p * v_l
    return out
