"""The port's multi-device layer (kajiya_tpu_torch/parallel/) on the CPU:
four gloo ranks, spawned once for the module with `parallel.launch.spawn`
(a file:// rendezvous in a fresh temporary directory, so concurrent test
workers never meet), run every sharded case; rank 0 writes what they
gathered, and the tests hold it against the port's single-device frame.

The model is tests/test_parallel.py (JAX, 8 virtual devices, GSPMD): a
sharded frame equals the single-device frame, the state stays sharded, no
collective moves a replicated state, halo traffic exists and stays under one
plane, the sample-sharded path tracer equals the single-device one, and a
(2, 2) multi-host frame equals the tile-sharded one. The configurations: the
raster + shadow frame, the diffuse-GI frame (64x128 and the uneven 72 rows),
and the default frame (every default flag on: the irradiance cache, RTR
with mesh-light specular as `Renderer` turns it on for cornell, TAA and
motion blur; the small cache of test_torch_frame_default.py) on a moving,
jittered camera, three frames at 128 and at 72 rows: frame 0 validates the
reservoirs and the cache, frames 1-2 run TAA, RTR's temporal reuse and
motion blur on history; the options frame (the default frame plus the
traced g-buffer, the world radiance cache, its atlas split over the ranks'
probes, and depth of field over halo rows; the atmosphere sky), two
jittered frames at 128 rows; and temporal super-resolution (the default
frame rendered at 64x72 and output at 96x108, factor 1.5), three jittered
frames, whose output bands (32 / 16 / 32 / 28 rows) are not its render bands
(16 / 16 / 16 / 24) scaled. Every rank holds the same irradiance-cache pool,
checked by a digest per rank. JAX's contract is
sharded == single device; test_torch_parallel_jax.py holds the sharded port
frames against JAX's single-device frame.

Tolerance: bit for bit. Every band computes its pixels with the operations
the whole frame uses on them, the halo windows clamp where the frame does,
and the RNG, blue noise and pixel lattices take screen rows."""
import hashlib
import os

import numpy as np
import pytest
import torch

from kajiya_tpu_torch import convert
from kajiya_tpu_torch.core.camera import camera_rays
from kajiya_tpu_torch.core.camera import make_view_constants as view_t
from kajiya_tpu_torch.frame import RenderConfig, check_supported
from kajiya_tpu_torch.frame import (init_frame_state, jitter_for_frame,
                                    render_frame)
from kajiya_tpu_torch.parallel import (check_sharding_quality,
                                       collective_summary,
                                       compile_frame_sharded,
                                       distribute_scene, frame_state_sharding,
                                       make_mesh, make_multihost_mesh,
                                       render_frame_multihost,
                                       render_frame_sharded, shard_rays_pt)
from kajiya_tpu_torch.parallel import launch
from kajiya_tpu_torch.parallel.comm import (Collective, CollectiveLog,
                                            even_slices)
from kajiya_tpu_torch.parallel.mesh import band_rows, gather_frame
from kajiya_tpu_torch.renderers.ircache import IrcacheConfig
from kajiya_tpu_torch.renderers.wrc import WrcConfig

N_RANKS = 4
W, H = 64, 16 * 8
H_UNEVEN = 72          # 16-row units 16 / 16 / 16 / 24 over four ranks
GI = dict(width=W, height=H, primary="raster", sun_soft_shadows=True,
          use_ssao=True, use_rtdgi=True, use_restir_gi=True,
          secondary_full_shading=True, use_rtr=False, use_ircache=False,
          use_taa=False, use_motion_blur=False)
RASTER = {**GI, "use_ssao": False, "use_rtdgi": False,
          "use_restir_gi": False}
# the default RenderConfig with the small cache of
# tests/test_torch_frame_default.py, as `Renderer` resolves it for cornell
SMALL_IRCACHE = dict(max_entries=4096, active_budget=1024)
DEFAULT = dict(width=W, height=H, ircache=IrcacheConfig(**SMALL_IRCACHE),
               use_mesh_light_specular=True)
# the options frame: the default frame with the traced g-buffer, the world
# radiance cache (the small grid of test_torch_frame_options_frame.py: 2 x 2
# x 2 probes of 8^2 texels, so the probe axis divides by four and JAX's plan
# shards it) and depth of field
WRC = dict(grid=(2, 2, 2), probe_res=8, grid_spacing=1.0,
           grid_origin=(-0.5, -0.5, -0.5))
OPTIONS = dict(DEFAULT, primary="trace", use_wrc=True, use_dof=True,
               wrc=WrcConfig(**WRC))
# temporal super-resolution: the default frame rendered at 64x72 and output
# at 96x108 (bands 16/16/16/24 and 32/16/32/28: not one another scaled)
SUPERRES = dict(DEFAULT, temporal_upsampling=1.5)
H_SUPERRES = 72
# camera step of tests/test_torch_frame_gi.py (no reprojection knife edge)
EYE, FWD, STEP = (0.0, 0.0, 2.4), (0.0, 0.0, -1.0), (0.04, 0.013, 0.0)
N_FRAMES = 2
OUTPUTS = ("final", "lit", "shadow", "ssao", "diffuse_gi", "reflections",
           "exposure", "taa")
GBUFFER = ("depth", "normal", "albedo", "pos", "hit")
# the sharded cases: (name, config, frame height)
CASES = (("gi", GI, H), ("raster", RASTER, H), ("uneven", GI, H_UNEVEN),
         ("default", DEFAULT, H), ("uneven_default", DEFAULT, H_UNEVEN),
         ("options", OPTIONS, H), ("superres", SUPERRES, H_SUPERRES))
# the cases of the default frame and its options: jittered as the
# Renderer's views are, 3 frames (a validation frame, then two on history;
# the options frame 2)
DEFAULT_CASES = ("default", "uneven_default", "options", "superres")
PT_BOUNCES = 2


def n_frames(case):
    if case == "options":
        return 2
    return 3 if case in DEFAULT_CASES else N_FRAMES


def case_frames(cases=CASES):
    return [(c[0], k) for c in cases for k in range(n_frames(c[0]))]


def port_views(h, n=N_FRAMES, jitter=False):
    views, prev = [], None
    for k in range(n):
        e = tuple(np.asarray(EYE) + k * np.asarray(STEP))
        j = tuple(float(x) for x in jitter_for_frame(k, jitter))
        prev = view_t(e, FWD, fov_y_deg=55.0, width=W, height=h, jitter=j,
                      prev=prev, device="cpu")
        views.append(prev)
    return views


def case_views(name, h):
    jit = name in DEFAULT_CASES
    return port_views(h, n_frames(name), jitter=jit)


def ircache_digest(state):
    """sha256 over the bytes of a state's irradiance-cache tables."""
    h = hashlib.sha256()
    for k in sorted(state):
        if k.startswith("ircache_"):
            h.update(k.encode())
            h.update(state[k].contiguous().view(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def cornell_scene():
    from kajiya_tpu_torch.scene import procedural
    from kajiya_tpu_torch.scene.scene import build_gpu_scene
    from kajiya_tpu_torch.world import build_trace_scene

    gpu = build_gpu_scene(procedural.cornell_box(), device="cpu")
    return build_trace_scene(gpu, device="cpu")[0]


def scene_digest(tree):
    """sha256 over every tensor of a scene tree, in field order."""
    from kajiya_tpu_torch.parallel.mesh import _skeleton

    leaves = []
    sk = _skeleton(tree, leaves)
    h = hashlib.sha256(repr([(s.shape, s.dtype) for s in leaves]).encode())
    for t in leaves:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes() if t.numel() else b"")
    return h.hexdigest(), len(leaves), sk[0]


def _outputs(out):
    return {**{k: out[k] for k in OUTPUTS},
            "gbuffer": {k: out["gbuffer"][k] for k in GBUFFER}}


def run_ranks(mesh_args, spec):
    """One rank of the sharded cases in `spec` (see `sharded_runs`); rank 0
    saves what was gathered to spec["out"]."""
    torch.set_num_threads(1)
    rank = mesh_args[0]
    mesh = make_mesh(device="cpu")
    if spec["scene"] is None:
        ts0 = cornell_scene() if rank == 0 else None
    else:
        ts0 = (convert.trace_scene_from_numpy(
            torch.load(spec["scene"], weights_only=False), device="cpu")
            if rank == 0 else None)
    ts = distribute_scene(ts0, mesh)
    res = {"backend": mesh.backend,
           "digest_sent": scene_digest(ts0)[0] if rank == 0 else None,
           "digests": mesh.comm.gather_objects(scene_digest(ts)[0])}
    views = {k: [convert.view_from_numpy(v, device="cpu") for v in vs]
             for k, vs in spec["views"].items()}
    for name, cfg_kw in spec["frames"]:
        cfg = RenderConfig(**cfg_kw)
        st = init_frame_state(cfg, device="cpu")
        if name in spec.get("log", ()):
            res[f"log_{name}"] = list(compile_frame_sharded(
                ts, st, views[name][0], cfg, None, mesh))
            res[f"plan_{name}"] = frame_state_sharding(st, mesh)
        frames, digests = [], []
        for v in views[name]:
            st, out = render_frame_sharded(ts, st, v, cfg, None, mesh)
            frames.append(gather_frame({"out": _outputs(out), "state": st},
                                       mesh, cfg))
            digests.append(mesh.comm.gather_objects(ircache_digest(st)))
        res[name] = frames
        res[f"{name}_ircache_digests"] = digests
        res[f"{name}_shapes"] = mesh.comm.gather_objects(
            {k: tuple(v.shape) for k, v in st.items()})
    if spec.get("multihost"):
        name = spec["multihost"]
        cfg = RenderConfig(**dict(spec["frames"])[name])
        mh = make_multihost_mesh(shape=(2, 2), device="cpu")
        with mh.comm.recording() as log:
            st, out = render_frame_multihost(
                ts, init_frame_state(cfg, device="cpu"), views[name][0], cfg,
                None, mh)
        res["multihost"] = gather_frame({"out": _outputs(out), "state": st},
                                        mh, cfg)
        res["multihost_log"] = [e for part in mh.comm.gather_objects(
            list(log)) for e in part]
        res["multihost_shapes"] = mh.comm.gather_objects(
            {k: tuple(v.shape) for k, v in st.items()})
        res["multihost_shape"] = mh.shape
        res["multihost_plan"] = frame_state_sharding(
            init_frame_state(cfg, device="cpu"), mh)
    if spec.get("pt"):
        name = spec["pt"]
        h = dict(spec["frames"])[name]["height"]
        org, d = camera_rays(views[name][0], W, h)
        seed = torch.arange(org.shape[0] * org.shape[1], dtype=torch.int64)
        res["pt"] = shard_rays_pt(ts, org.reshape(-1, 3), d.reshape(-1, 3),
                                  seed, mesh, num_bounces=PT_BOUNCES)
    if rank == 0:
        torch.save(res, spec["out"])


def sharded_runs(out_dir, scene_path=None, views=None, cases=CASES,
                 log=("gi", "default", "options", "superres"),
                 multihost="gi", pt="gi"):
    """Spawn N_RANKS gloo ranks over `cases` and return rank 0's results.
    views: {case name: [view numpy dicts]} (default: the port's views);
    `log`: the cases whose first frame is also run by
    `compile_frame_sharded`."""
    if views is None:
        views = {name: [convert.to_numpy_dict(v)
                        for v in case_views(name, h)]
                 for name, _cfg, h in cases}
    spec = dict(out=os.path.join(out_dir, "ranks.pt"), scene=scene_path,
                views=views,
                frames=[(name, {**cfg, "height": h})
                        for name, cfg, h in cases],
                log=tuple(log or ()), multihost=multihost, pt=pt)
    launch.spawn(run_ranks, N_RANKS, args=(spec,), timeout_s=600)
    return torch.load(spec["out"], weights_only=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return sharded_runs(str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def single():
    """The port's single-device frames of every case, and its path trace."""
    ts = cornell_scene()
    out = {"ts": ts}
    for name, cfg_kw, h in CASES:
        cfg = RenderConfig(**{**cfg_kw, "height": h})
        st = init_frame_state(cfg, device="cpu")
        frames = []
        for v in case_views(name, h):
            st, o = render_frame(ts, st, v, cfg)
            frames.append({"out": _outputs(o), "state": st})
        out[name] = frames
    org, d = camera_rays(port_views(H)[0], W, H)
    seed = torch.arange(H * W, dtype=torch.int64)
    from kajiya_tpu_torch.renderers.reference import path_trace

    out["pt"] = path_trace(ts, org.reshape(-1, 3), d.reshape(-1, 3), seed,
                           num_bounces=PT_BOUNCES)
    return out


def assert_equal_trees(a, b, where):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], dict):
            assert_equal_trees(a[k], b[k], f"{where}/{k}")
            continue
        assert a[k].shape == b[k].shape, (where, k)
        assert a[k].dtype == b[k].dtype, (where, k)
        assert torch.equal(a[k], b[k]), (
            where, k, float((a[k].float() - b[k].float()).abs().max()))


def test_band_rows():
    assert band_rows(1080, 4) == ((0, 272), (272, 544), (544, 816),
                                  (816, 1080))
    assert band_rows(H_UNEVEN, 4) == ((0, 16), (16, 32), (32, 48), (48, 72))
    assert band_rows(H, 4) == ((0, 32), (32, 64), (64, 96), (96, 128))
    assert band_rows(540, 1) == ((0, 540),)
    with pytest.raises(ValueError):
        band_rows(64, 5)


def test_ranks_ran_gloo(ranks):
    assert ranks["backend"] == "gloo"


@pytest.mark.parametrize("case,frame", case_frames())
def test_sharded_frame_equals_single_device(ranks, single, case, frame):
    """Gathered outputs and every state plane, bit for bit (the replicated
    irradiance-cache tables as rank 0 holds them)."""
    assert_equal_trees(ranks[case][frame], single[case][frame],
                       f"{case}/{frame}")


@pytest.mark.parametrize("case", DEFAULT_CASES)
def test_ircache_pool_is_the_same_on_every_rank(ranks, single, case):
    """After every frame, every rank holds the single-device frame's
    irradiance-cache tables bit for bit; the cache is live and was
    validated (frame 0) and traced on history (frames 1, 2)."""
    for k, per_rank in enumerate(ranks[f"{case}_ircache_digests"]):
        want = ircache_digest(single[case][k]["state"])
        assert per_rank == [want] * N_RANKS, (case, k)
    st = single[case][-1]["state"]
    assert int(st["ircache_valid"].sum()) > 0
    assert float(st["ircache_life"].max()) >= 2.0


def held_rows(key, shape, cfg, r):
    """The leading extent rank r holds of a whole state plane of `shape`:
    its band's rows (TAA's planes on the output frame's bands, the world
    radiance cache's atlas its slice of the probes), or all of it for a
    replicated table."""
    if key.startswith("taa_"):
        a, b = band_rows(cfg.out_height, N_RANKS)[r]
        return b - a
    if key == "wrc_atlas":
        a, b = even_slices(shape[0], N_RANKS)[r]
        return b - a
    if len(shape) >= 2 and shape[1] in (W, W // 2) \
            and not key.startswith("ircache_"):
        k = W // shape[1]
        a, b = band_rows(cfg.height, N_RANKS)[r]
        return b // k - a // k
    return shape[0] if shape else None


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_state_stays_banded(ranks, case):
    """No rank holds another band's rows: each plane of each rank's state
    has its band's rows (at its plane's resolution; TAA's planes on the
    output frame's bands, the radiance cache's atlas its probes)."""
    name, cfg_kw, h = next(c for c in CASES if c[0] == case)
    cfg = RenderConfig(**{**cfg_kw, "height": h})
    full = init_frame_state(cfg, device="cpu")
    for r, shapes in enumerate(ranks[f"{case}_shapes"]):
        n_planes = 0
        for k, shape in shapes.items():
            whole = tuple(full[k].shape)
            rows = held_rows(k, whole, cfg, r)
            want = whole if not whole else (rows,) + whole[1:]
            n_planes += int(want != whole)
            assert shape == want, (case, r, k, shape, want)
        assert n_planes >= 10
        if case == "options":
            assert shapes["wrc_atlas"] == (2, 8, 8, 3)
        if case == "superres":
            assert shapes["taa_history"][:2] == (
                (32, 16, 32, 28)[r], 96)
            assert shapes["prev_lit"][0] == (16, 16, 16, 24)[r]


def test_multihost_frame_equals_four_tiles(ranks):
    """(2 hosts x 2 ranks), host-major: the same bands as the four-tile
    mesh, so the same frame bit for bit; the halo messages between ranks of
    different hosts (1 and 2 at the seam, and the SSAO taps' reach from 0 to
    2 and 1 to 3) are counted as crossing it, no others."""
    assert ranks["multihost_shape"] == {"host": 2, "tile": 2}
    assert_equal_trees(ranks["multihost"], ranks["gi"][0], "multihost")
    rows = band_rows(H, N_RANKS)
    for r, shapes in enumerate(ranks["multihost_shapes"]):
        assert shapes["prev_lit"] == (rows[r][1] - rows[r][0], W, 3)
    summary = collective_summary(ranks["multihost_log"])
    halos = [e for e in ranks["multihost_log"] if e.kind == "halo"]
    seam = [e for e in halos if (e.rank // 2) != (e.peer // 2)]
    assert seam and any({e.rank, e.peer} == {1, 2} for e in seam)
    assert all(e.inter_host_bytes == (e.nbytes if e in seam else 0)
               for e in halos)
    assert summary["halo"]["inter_host_bytes"] == sum(
        e.nbytes for e in seam) < summary["halo"]["bytes"]
    assert summary["all_reduce"]["inter_host_bytes"] > 0
    # the tile-sharded frame has one host: nothing crosses a seam
    assert all(e.inter_host_bytes == 0 for e in ranks["log_gi"])


def test_shard_rays_pt_equals_single_device(ranks, single):
    assert ranks["pt"].shape == (H * W, 3)
    assert torch.equal(ranks["pt"], single["pt"])
    assert float(ranks["pt"].sum()) > 0.0


def test_distribute_scene_is_bit_exact(ranks, single):
    """Rank 0's trace scene arrives on every rank bit for bit (and equals
    the scene the same build makes here)."""
    sent = ranks["digest_sent"]
    assert ranks["digests"] == [sent] * N_RANKS
    assert scene_digest(single["ts"])[0] == sent
    digest, n_tensors, kind = scene_digest(single["ts"])
    assert kind == "dataclass" and n_tensors >= 20


@pytest.mark.parametrize("case", ["gi", "default", "options", "superres"])
def test_collective_accounting(ranks, case):
    """The sharded frame's log: the JAX contract holds (no element above
    24 planes, no irradiance-cache element above 8 MiB), halo messages
    exist and each is under one plane, the histogram is all-reduced, every
    rank logged. The GI frame has no cache; the default frame's cache
    collectives are its two gathers per rank (the query points and the
    entry wavefront's radiance), booked as the cache's. The options frame
    adds one all-gather of the whole radiance-cache atlas per rank and the
    depth of field's halo rows; super-resolution the windows of its
    resizes and of its 27-channel fetch."""
    name, cfg_kw, h = next(c for c in CASES if c[0] == case)
    cfg = RenderConfig(**{**cfg_kw, "height": h})
    log = ranks[f"log_{case}"]
    # planes are counted at the output size, the frame's largest
    ho, wo = cfg.out_height, cfg.out_width
    summary, problems = check_sharding_quality(log, ho, wo)
    assert not problems, problems
    assert "halo" in summary and summary["halo"]["count"] > 0
    assert summary["halo"]["max_bytes"] < ho * wo * 4
    assert summary["all_reduce"]["count"] == N_RANKS
    assert summary["all_gather"]["plane_max_bytes"] <= 24 * ho * wo * 4
    assert {e.rank for e in log} == set(range(N_RANKS))
    assert all(e.staged_bytes == 0 for e in log)      # CPU ranks: no staging
    labels = {kind: ent["labels"] for kind, ent in summary.items()}
    assert sum(sum(v.values()) for v in labels.values()) == sum(
        e.nbytes for e in log)
    cache = [e for e in log if e.ircache]
    if case == "gi":
        assert not cache
        return
    assert sorted(e.label for e in cache) == sorted(
        ["ircache queries", "ircache radiance"] * N_RANKS)
    assert all(e.kind == "all_gather" and e.nbytes <= 8 << 20
               for e in cache)
    # the queries (stride 4: (h / 4) x 16 points x 4 floats) and the
    # wavefront's radiance (1024 entries x 4 rays x 3 floats)
    sizes = {e.label: e.nbytes for e in cache}
    assert sizes == {"ircache queries": (h // 4) * (W // 4) * 16,
                     "ircache radiance": 1024 * 4 * 12}
    assert not any("ircache" in e.label for e in log if not e.ircache)
    atlas = [e for e in log if e.label == "wrc atlas"]
    dof = [e for e in log if e.label == "dof halo"]
    windows = [e for e in log if e.label.startswith("taa super-res")
               or e.label == "taa resize window"]
    if case == "options":
        # the 8 probes' 8 x 8 x 3 floats, gathered whole on every rank
        assert len(atlas) == N_RANKS and all(
            e.kind == "all_gather" and e.nbytes == 8 * 8 * 8 * 3 * 4
            for e in atlas)
        assert dof and all(e.kind == "halo" for e in dof)
        # 13 rows each way of colour + CoC, from each neighbour that has
        # them (the inner ranks two, the outer ones one)
        assert labels["halo"]["dof halo"] == 6 * 13 * W * 4 * 4
    else:
        assert not atlas and not dof
    if case == "superres":
        assert {e.label for e in windows} == {"taa super-res source",
                                              "taa resize window"}
        assert all(e.kind == "halo" for e in windows)
    else:
        assert not windows


def test_quality_check_flags_replication_and_empty_logs():
    plane = H * W * 4
    state_sized = CollectiveLog([Collective("all_gather", 40 * plane, 0)])
    _, problems = check_sharding_quality(state_sized, H, W)
    assert problems and "24 planes" in problems[0]
    _, problems = check_sharding_quality(CollectiveLog(), H, W)
    assert problems and "no collectives" in problems[0]
    halo = CollectiveLog([Collective("halo", plane, 0, peer=1)])
    _, problems = check_sharding_quality(halo, H, W)
    assert problems and "halo" in problems[0]
    cache = CollectiveLog([Collective("all_reduce", 9 << 20, 0,
                                      ircache=True)])
    _, problems = check_sharding_quality(cache, H, W)
    assert problems and "ircache" in problems[0]


@pytest.mark.parametrize("case", ["gi", "default", "options", "superres"])
def test_frame_state_sharding_matches_jax(ranks, case):
    """The port's plan equals JAX's `frame_state_sharding` / multi-host
    `_spec_for_multihost` on the same `init_frame_state` (JAX builds only
    the NamedShardings, on 4 of the 8 virtual CPU devices). On the default
    state: TAA's planes row-sharded, every irradiance-cache table
    replicated; on the options state the radiance cache's atlas sharded
    over its probes; under super-resolution the output-size TAA planes
    row-sharded."""
    import jax

    from kajiya_tpu.frame import RenderConfig as CfgJ
    from kajiya_tpu.frame import init_frame_state as init_j
    from kajiya_tpu.parallel.mesh import (_spec_for_multihost,
                                          frame_state_sharding as plan_j,
                                          make_mesh as mesh_j,
                                          make_multihost_mesh as mh_j)
    from kajiya_tpu.renderers.ircache import IrcacheConfig as IrcJ
    from kajiya_tpu.renderers.wrc import WrcConfig as WrcJ

    name, cfg_kw, h = next(c for c in CASES if c[0] == case)
    kw = {**cfg_kw, "height": h}
    if "ircache" in kw:
        kw["ircache"] = IrcJ(**SMALL_IRCACHE)
    if "wrc" in kw:
        kw["wrc"] = WrcJ(**WRC)
    sj = init_j(CfgJ(**kw))
    want = {k: tuple(s.spec) for k, s in plan_j(sj, mesh_j(N_RANKS)).items()}
    assert ranks[f"plan_{case}"] == want
    assert any(want.values()) and not all(want.values())
    if case != "gi":
        assert all(want[k] == ("tile", None) + (None,) * (sj[k].ndim - 2)
                   for k in ("taa_history", "taa_coverage", "taa_smooth_var",
                             "taa_velocity", "rtr_history", "rtr_res_dir"))
        cache = [k for k in sj if k.startswith("ircache_")]
        assert len(cache) == 7 and all(want[k] == () for k in cache)
        if case == "options":
            assert want["wrc_atlas"] == ("tile", None, None, None)
        if case == "superres":
            assert sj["taa_history"].shape == (108, 96, 3)
        return
    mh = mh_j(shape=(2, 2))
    want_mh = {k: tuple(_spec_for_multihost(v, mh).spec)
               for k, v in sj.items()}
    assert ranks["multihost_plan"] == want_mh
    assert len(jax.devices()) >= N_RANKS


def test_one_rank_mesh_is_the_single_device_frame():
    """Without a process group the mesh is this process alone: its band is
    the whole frame, the sharded frame is `render_frame` bit for bit, it
    issues no collective (a log the quality check refuses), and the scene
    distribution is the identity."""
    cfg = RenderConfig(**{**GI, "width": 64, "height": 48})
    ts = cornell_scene()
    mesh = make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.backend == "none"
    assert distribute_scene(ts, mesh) is ts
    v = port_views(48, 1)[0]
    log = compile_frame_sharded(ts, init_frame_state(cfg, device="cpu"), v,
                                cfg, None, mesh)
    assert len(log) == 0
    assert check_sharding_quality(log, 48, 64)[1]
    s1, o1 = render_frame_sharded(ts, init_frame_state(cfg, device="cpu"),
                                  v, cfg, None, mesh)
    s2, o2 = render_frame(ts, init_frame_state(cfg, device="cpu"), v, cfg)
    assert_equal_trees({"out": _outputs(o1), "state": s1},
                       {"out": _outputs(o2), "state": s2}, "one rank")


@pytest.mark.parametrize("option", ["primary", "use_wrc", "use_dof",
                                    "temporal_upsampling", "all"])
def test_options_are_supported_sharded(option):
    """The traced g-buffer, the world radiance cache, depth of field and
    temporal super-resolution run row-banded, alone and together."""
    kw = {"primary": "trace", "use_wrc": True, "use_dof": True,
          "temporal_upsampling": 1.5}
    cfg = RenderConfig(**({**DEFAULT, **kw} if option == "all"
                          else {**DEFAULT, option: kw[option]}))
    check_supported(cfg, sharded=True)
    check_supported(cfg, None, sharded=True)


@pytest.mark.parametrize("option", ["ibl"])
def test_options_of_the_next_slice_raise(option):
    """The one option the banded frame refuses, an IBL env map, raises
    NotImplementedError naming JAX's sharded API, which renders without
    one, from `check_supported` and from the banded frame before any work;
    the single-device frame takes it."""
    cfg = RenderConfig(**DEFAULT)
    ibl = torch.zeros((8, 8, 3))
    check_supported(cfg, ibl)                      # the single-device frame
    with pytest.raises(NotImplementedError, match="JAX's sharded entry "
                                                  "points"):
        check_supported(cfg, ibl, sharded=True)
    mesh = make_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="render_frame_sharded"):
        render_frame(None, {}, None, cfg, ibl_env=ibl,
                     band=mesh.band(cfg.height, cfg.width))


def test_default_frame_is_supported_sharded():
    """The default `RenderConfig`, and the one `Renderer` resolves for a
    scene with emissive triangles, run row-banded."""
    from dataclasses import replace

    check_supported(RenderConfig(), sharded=True)
    check_supported(replace(RenderConfig(), use_mesh_light_specular=True),
                    sharded=True)
    check_supported(RenderConfig(**DEFAULT), sharded=True)
