"""Zurich-capacity smoke: a 1000-slot map, hundreds of slots filled.

The port's copy of the JAX package's ``tools/zurich_scale_smoke.py`` (numpy
and torch only; nothing of the JAX package). It allocates the full
Zurich-capacity ``MapState`` (``max_keyframes`` 1000, the capacity of every
shipped ``configs/*.cfg``) at 640x480, fills ``--kf`` of its keyframe slots
with real rendered views of a ``PlaneScene`` (their pyramids in the uint8
store, the plane points they see, each observation 0.3 px off), then

* serves against the filled map (:func:`serve_smoke`): a localize-only
  ``SdvlStream`` started LOST near keyframe 8, its relocalization step cold
  and warm, 64 steady frames, 4 chunks of 32 frames, and the standalone
  relocalizer at 16, 64 and 256 lanes;
* perturbs the poses and points and pulls them back with the whole-map
  bundle adjustment (:func:`run_global_ba`): ``mapper.global_ba`` on the
  matrix-free block-Jacobi PCG path (above ``ba.CG_KF_THRESHOLD`` slots), on
  the card one replay of a CUDA graph.

Prints one JSON line with the JAX tool's keys, each with its meaning, and
the port's own (:func:`main`). Where the JAX tool compiles, the port
captures CUDA graphs: ``serve_compile_s`` is the cold relocalization step
(the capture of the step's graph and one replay), ``ba_s_compile+run`` is
global BA's first call (its graph's warm-up passes, capture and one replay)
and ``ba_s_warm`` its replay alone (the first call less the capture, as
each call captures anew). Every time is the host's wall clock with the card
synchronised; ``serve_chunk_ms_per_frame`` (the timed chunks' device time
per frame) and ``reloc_lane_ms`` on the card are CUDA-event spans.

    python -m sdvl_tpu_torch.tools.zurich_scale_smoke [--kf 320] [--pts 4096]
        [--stage-iters 4 6] [--no-serve] [--device cuda|cpu]
        [--draws NPZ] [--json out.json]

``--draws`` reads the perturbation (``pose_noise``, ``pt_noise``) from an
npz (``tests/data/torch_zurich_record.npz`` holds the JAX tool's); without
it the tool draws its own from a ``torch.Generator``. On the CPU cut the
sizes (``--kf-cap``, ``--height``, ``--width``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import time

import numpy as np
import torch

from .long_run import default_workers

# the JAX tool's defaults
KF_CAP, KF, PTS, HEIGHT, WIDTH, LEVELS = 1000, 320, 4096, 480, 640, 5
STAGE_ITERS = (4, 6)
LANES = (16, 64, 256)


def zurich_camera(height: int = HEIGHT, width: int = WIDTH) -> dict:
    """The JAX tool's pinhole (``tools/zurich_scale_smoke.py:52-57``), its
    focal lengths and principal point scaled with the width."""
    s = width / WIDTH
    return dict(fx=517.3 * s, fy=516.5 * s, cx=318.6 * s, cy=255.3 * s,
                width=width, height=height)


def zurich_config(height: int = HEIGHT, width: int = WIDTH,
                  kf_cap: int = KF_CAP, pts: int = PTS):
    """(intrinsics, scene, serving ``Config``): the JAX tool's ``:52-57``
    and ``:192-199``."""
    from ..core import camera
    from ..io.synthetic import PlaneScene
    from ..pipeline.config import CameraConfig, Config, SdvlConfig

    c = zurich_camera(height, width)
    intr = camera.Intrinsics.create(c["fx"], c["fy"], c["cx"], c["cy"],
                                    width=width, height=height)
    scene = PlaneScene(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                       width=width, height=height, plane_z=4.0)
    cfg = Config(
        camera=CameraConfig(width=width, height=height, fx=c["fx"],
                            fy=c["fy"], u0=c["cx"], v0=c["cy"],
                            dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(max_keyframes=kf_cap, max_points=pts,
                        max_candidates=8, localize_only=True,
                        reloc_max_keyframes=64, map_scale=4.0,
                        min_avg_shift=10.0),
    )
    return intr, scene, cfg


def render_all(fn, items, workers: int) -> list:
    """``[fn(x) for x in items]``, in ``workers`` threads where > 0 (the
    renderer's array work releases the GIL; a pool of processes ran the
    card machine's host out of memory)."""
    items = list(items)
    if workers <= 0 or len(items) < 2:
        return [fn(x) for x in items]
    first = fn(items[0])    # builds the scene's ray grid, then only read
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return [first] + list(pool.map(fn, items[1:]))


def keyframe_views(scene, kf: int, workers: int = 0):
    """The JAX tool's keyframe trajectory (``scene.trajectory(kf,
    translation_amp=1.5)``) as (kf, 7) float32 and its views rendered and
    clipped to [0, 255] as (kf, H, W) float32 (``:66-94``)."""
    poses = np.stack(scene.trajectory(kf, translation_amp=1.5)
                     ).astype(np.float32)
    imgs = np.stack(render_all(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.float32),
        poses, workers))
    return poses, imgs


def plane_points(pts: int) -> np.ndarray:
    """The JAX tool's world points on the plane z = 4 (``:62-65``, drawn
    from ``np.random.default_rng(0)``)."""
    rs = np.random.default_rng(0)
    return np.concatenate([
        rs.uniform([-3.5, -2.5], [3.5, 2.5], (pts, 2)),
        np.full((pts, 1), 4.0),
    ], axis=1).astype(np.float32)


def images_sha256(imgs) -> str:
    """SHA-256 over float32 images, in order."""
    h = hashlib.sha256()
    for im in imgs:
        h.update(np.ascontiguousarray(im, np.float32).tobytes())
    return h.hexdigest()


def fill_map(intr, kf_poses: torch.Tensor, pts_w: torch.Tensor,
             imgs: torch.Tensor, kf_cap: int = KF_CAP,
             levels: int = LEVELS, n_cand: int = 8):
    """The JAX tool's ``fill`` (``:72-104``) in batched ops on the device of
    the inputs: an empty map of ``kf_cap`` keyframe slots whose first
    ``len(kf_poses)`` hold the keyframes (pose, frame id, the uint8 pyramid
    of their (H, W) float32 views), every point of ``pts_w`` valid (anchored
    at slot 0, found 3 times), seen where in front of the camera and 8 px
    inside the image, observed 0.3 px off its projection."""
    from ..core import camera, se3
    from ..ops import pyramid
    from ..state.map_state import empty_map, store_pyramid

    Kn, H, W = imgs.shape
    P = pts_w.shape[0]
    dev = imgs.device
    m = empty_map(n_kf=kf_cap, n_pts=P, n_cand=n_cand, img_shape=(H, W),
                  levels=levels, device=dev)
    p_cam = se3.transform(kf_poses[:, None], pts_w[None])       # (Kn, P, 3)
    px = camera.project(intr, p_cam)
    vis = (p_cam[..., 2] > 0.1) & camera.in_bounds(intr, px, margin=8)
    pyrs = store_pyramid(pyramid.build_pyramid(imgs, levels))
    kf_pyr = tuple(torch.cat([p, lvl[Kn:]]) for lvl, p in zip(m.kf_pyr,
                                                               pyrs))

    def head(t, v):
        return torch.cat([v.to(t.dtype), t[Kn:]])

    return m._replace(
        kf_pose=head(m.kf_pose, kf_poses),
        kf_valid=head(m.kf_valid, torch.ones(Kn, dtype=torch.bool,
                                             device=dev)),
        kf_frame_id=head(m.kf_frame_id, torch.arange(Kn, device=dev)),
        kf_pyr=kf_pyr,
        n_keyframes=torch.tensor(Kn, dtype=torch.int32, device=dev),
        pt_pos=pts_w.clone(),
        pt_valid=torch.ones(P, dtype=torch.bool, device=dev),
        pt_found=torch.full((P,), 3, dtype=torch.int32, device=dev),
        obs_mask=head(m.obs_mask, vis),
        obs_px=head(m.obs_px, px + 0.3),
    )


def state_bytes(m) -> tuple:
    """(the port's bytes of a ``MapState``, the bytes of the JAX package's
    layout, whose index fields and ORB words are 4-byte where the port's
    are int64)."""
    leaves = [t for v in m for t in (v if isinstance(v, tuple) else (v,))]
    own = sum(t.numel() * t.element_size() for t in leaves)
    jax = sum(t.numel() * (4 if t.dtype == torch.int64 else
                           t.element_size()) for t in leaves)
    return own, jax


def draws(kf_cap: int, pts: int, device, seed: int = 1):
    """The perturbation's two draws from a ``torch.Generator`` of the
    tool's own: pose noise (kf_cap, 6), 0.01 x standard normal with rows 0
    and 1 zeroed (the BA's gauge fixes them), and point noise (pts, 3),
    0.02 x standard normal (the JAX tool's scales, ``:126-131``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pose = 0.01 * torch.randn((kf_cap, 6), generator=gen, device=device)
    pose[:2] = 0.0
    return pose, 0.02 * torch.randn((pts, 3), generator=gen, device=device)


def perturb(m, pose_noise: torch.Tensor, pt_noise: torch.Tensor):
    """The JAX tool's ``perturb`` (``:122-135``) given its draws: each
    keyframe pose composed with ``exp`` of its row of ``pose_noise``, the
    points moved by ``pt_noise``."""
    from ..core import se3

    return m._replace(kf_pose=se3.compose(se3.exp(pose_noise), m.kf_pose),
                      pt_pos=m.pt_pos + pt_noise)


def reproj_err(m, intr) -> torch.Tensor:
    """Mean reprojection error in px over the valid observations of valid
    keyframes and points (``:137-143``), a () device tensor."""
    from ..core import camera, se3

    p_cam = se3.transform(m.kf_pose[:, None], m.pt_pos[None])
    e = torch.linalg.norm(camera.project(intr, p_cam) - m.obs_px, dim=-1)
    w = m.obs_mask & m.kf_valid[:, None] & m.pt_valid[None, :]
    return torch.where(w, e, 0.0).sum() / w.sum().clamp(min=1)


def camera_centres(poses: torch.Tensor) -> torch.Tensor:
    """Camera centres in the world of (..., 7) world->camera poses."""
    from ..core import se3

    return se3.translation(se3.inverse(poses))


# observation counts that split a spread: a point seen by 0, 1 or 2
# keyframes is far less constrained than one seen by twenty
OBS_GROUPS = ((0, 0), (1, 1), (2, 2), (3, 4), (5, 9), (10, 19), (20, None))
# a distance this many float32 ulps of the largest coordinate is float32's
# resolution, however close the reference's two runs came: a pose one ulp
# apart in each component moves its camera centre by up to about 8 ulps of
# the centre's size (the rotation's ulp times the translation's lever arm,
# and the translation's own, over three axes); a point global BA leaves
# out (seen by fewer than 2 keyframes, mapper.extract_global_ba) keeps its
# perturbed position, equal in the reference's two runs and rounded apart
# from the JAX tool's fused perturbation in any other; a small map's BA
# converges to within an ulp or two (configs/euroc.cfg's: the reference's
# two runs' centres 3.6e-7 apart)
FLOOR_ULPS = 8


def spread(d, n_obs=None) -> dict:
    """The distribution of per-row distances ``d`` (points, or camera
    centres): median, 99th percentile and largest, and with ``n_obs``
    (each row's observation count) the largest in each ``OBS_GROUPS``
    group (``"lo-hi"``; ``None`` where the group is empty) and the group's
    rows."""
    d = np.asarray(d, np.float64)
    out = dict(median=float(np.median(d)), p99=float(np.quantile(d, 0.99)),
               max=float(d.max()))
    if n_obs is not None:
        n_obs = np.asarray(n_obs)
        out["max_by_obs"], out["rows_by_obs"] = {}, {}
        for lo, hi in OBS_GROUPS:
            sel = (n_obs >= lo) & (n_obs <= (n_obs.max() if hi is None
                                              else hi))
            name = f"{lo}-{'' if hi is None else hi}"
            out["max_by_obs"][name] = (float(d[sel].max()) if sel.any()
                                       else None)
            out["rows_by_obs"][name] = int(sel.sum())
    return out


def spread_against(pt_pos, kf_pose, obs_mask, rec, share: float = 1.0
                   ) -> dict:
    """A global BA's result (points (P, 3), the filled slots' poses (K, 7),
    their packed gated observations) against a record of the reference's
    own two evaluations of it (``ba_*`` jitted, ``ba_eager_*`` op by op;
    ``tests/data/torch_zurich_record.npz``, ``torch_euroc_record.npz``).
    Each point and camera centre is taken at its distance from the nearer
    of the two; ``own`` is the reference's spread, its two runs' distance
    to each other. Points are grouped by their observations after the
    jitted BA. ``apart`` lists what lies beyond ``share`` of the
    reference's own largest distance, or ``FLOOR_ULPS`` float32 ulps of the
    largest coordinate where that is more: each ``OBS_GROUPS`` group of
    points, the centres (``floor`` holds both floors). ``obs_apart``
    counts gated observations that differ from the jitted run's."""
    n_pts = rec["ba_pt_pos"].shape[0]
    n_obs = np.unpackbits(rec["ba_obs_mask"], axis=1)[:, :n_pts].sum(0)

    def distance(a, b):
        return np.linalg.norm(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64), axis=-1)

    def centres(q):
        return camera_centres(torch.as_tensor(np.asarray(q, np.float32))
                              ).numpy()

    c, c_j, c_e = (centres(q) for q in (kf_pose, rec["ba_kf_pose"],
                                        rec["ba_eager_kf_pose"]))
    near_p = np.minimum(distance(pt_pos, rec["ba_pt_pos"]),
                        distance(pt_pos, rec["ba_eager_pt_pos"]))
    near_c = np.minimum(distance(c, c_j), distance(c, c_e))
    own = dict(points=spread(distance(rec["ba_eager_pt_pos"],
                                      rec["ba_pt_pos"]), n_obs),
               centres=spread(distance(c_e, c_j)))
    floor = {k: FLOOR_ULPS * float(np.spacing(np.float32(np.abs(v).max())))
             for k, v in (("points", rec["ba_pt_pos"]), ("centres", c_j))}
    out = dict(points=spread(near_p, n_obs), centres=spread(near_c),
               own=own, share=share, floor=floor,
               obs_apart=int(np.unpackbits(np.asarray(obs_mask)
                                           ^ rec["ba_obs_mask"]).sum()),
               own_obs_apart=int(np.unpackbits(rec["ba_eager_obs_mask"]
                                               ^ rec["ba_obs_mask"]).sum()))
    bound = {g: max(share * v, floor["points"]) for g, v in
             own["points"]["max_by_obs"].items() if v is not None}
    bound["centres"] = max(share * own["centres"]["max"], floor["centres"])
    got = dict(out["points"]["max_by_obs"], centres=out["centres"]["max"])
    out["apart"] = [(g, v, bound[g]) for g, v in got.items()
                    if v is not None and v > bound[g]]
    return out


def recorded_ba_map(rec, cfg, device="cuda"):
    """A map as a record keeps it for global BA (``map_<field>``: the
    fields ``mapper.extract_global_ba`` reads, of the filled keyframe
    slots and every point slot; ``tests/data/torch_euroc_record.npz``) in
    an empty map of ``cfg``'s capacities on ``device``."""
    from ..state.map_state import empty_map

    s = cfg.sdvl
    m = empty_map(n_kf=s.max_keyframes, n_pts=s.max_points,
                  n_cand=s.max_candidates,
                  img_shape=(cfg.camera.height, cfg.camera.width),
                  levels=s.pyramid_levels, device=device)

    def put(name):
        t = getattr(m, name)
        v = torch.from_numpy(np.ascontiguousarray(rec["map_" + name])).to(
            t.device, t.dtype)
        return torch.cat([v, t[len(v):]])

    return m._replace(**{k[4:]: put(k[4:]) for k in rec
                         if k.startswith("map_")})


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_global_ba(m, intr, pose_noise, pt_noise, stage_iters=STAGE_ITERS,
                  graphs=None) -> dict:
    """The JAX tool's perturbation and global BA (``:122-168``): ``m``
    perturbed by the two draws, ``mapper.global_ba`` over it (on the card
    one replay of a CUDA graph unless ``graphs=False``), the mean
    reprojection error before and after, and the tool's assertion ``e1 <
    0.35 * e0``. Returns the map after BA (``map``), the perturbed map
    (``noisy``), ``e0``, ``e1``, the call's seconds, the CG iterations of
    each LM step, the synchronisations inside the call and on the graph
    path the graph's capture seconds, pool and replays."""
    from ..pipeline import mapper
    from ..utils.trace import sync_sites

    dev = m.kf_pose.device
    noisy = perturb(m, pose_noise, pt_noise)
    e0 = float(reproj_err(noisy, intr))
    stats, res = {}, []
    synchronize(dev)
    t0 = time.perf_counter()
    sites = sync_sites(lambda: res.append(mapper.global_ba(
        noisy, intr, stage_iters=tuple(stage_iters), graphs=graphs,
        stats=stats)))
    synchronize(dev)
    seconds = time.perf_counter() - t0
    m_ba = res[0]
    e1 = float(reproj_err(m_ba, intr))
    out = dict(map=m_ba, noisy=noisy, e0=e0, e1=e1, seconds=seconds,
               cg_iterations=stats["cg_iterations"].tolist(),
               sync_sites=sites)
    if "capture_s" in stats:
        out.update(capture_s=stats["capture_s"],
                   pool_mib=stats["pool_bytes"] / 2 ** 20,
                   replays=stats["replays"],
                   replay_s=seconds - stats["capture_s"])
    assert e1 < 0.35 * e0, (e0, e1)
    return out


def query_views(scene, kf_poses: np.ndarray, n: int = 130,
                workers: int = 0) -> list:
    """The serving phase's uint8 query frames (``:211-214``): keyframe poses
    10 .. 10 + n - 1 rendered again, clipped and truncated as the JAX tool
    casts."""
    return render_all(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.uint8),
        [kf_poses[10 + i] for i in range(n)], workers)


class Spans:
    """Device time of the work issued between :meth:`start` and
    :meth:`stop`: CUDA events on the card, the wall clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []

    def start(self):
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._a = time.perf_counter()

    def stop(self):
        if self.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self.spans.append((self._a, b))
        else:
            self.spans.append((self._a, time.perf_counter()))

    def ms(self) -> float:
        """Their sum in ms (reads the events: call after the last)."""
        if self.cuda:
            return sum(a.elapsed_time(b) for a, b in self.spans)
        return 1e3 * sum(b - a for a, b in self.spans)


def serve_smoke(m, intr, cfg, kf_poses: np.ndarray, q_frames: list,
                device="cuda", gumbel_provider=None, graphs=None,
                lanes=LANES, chunk: int = 32, steady: int = 64,
                n_chunks: int = 4, on_feed=None) -> tuple:
    """Localize-only serving against the filled map, the JAX tool's
    ``serve_smoke`` (``:175-277``): a ``SdvlStream`` made for ``cfg``
    adopts ``m`` (``stream.m = m``), is sent LOST near keyframe 8
    (``lost_frames`` 3, the pose of keyframe 8, no motion model) and fed
    query frame 0 (cold: on the card the capture of the step's graph);
    sent LOST again in place (:meth:`SdvlStream.write_carry`, so that the
    warm step replays the graph the cold step captured) and fed frame 0
    again; then ``steady`` frames one ``feed`` each; a first chunk of
    ``chunk`` frames (the chunk graph's capture) and ``n_chunks`` chunks
    timed, the first fed again as the JAX tool does; then the standalone
    relocalizer on frame 0's pyramid from keyframe 8's pose at each lane
    budget of ``lanes`` (on the card each a replay of a graph of its own,
    8 timed), and ``result()`` last.

    ``on_feed(stream, feed)``, where given, is called for each ``feed`` and
    ``feed_chunk`` in place of ``feed()``, which makes it.

    Returns (stats, result, {lanes: RelocResult}): the JAX tool's serving
    keys and the port's own (``serve_frames``, ``serve_replays``,
    ``serve_captures``, ``serve_capture_s``, ``serve_pool_mib``,
    ``serve_chunk_ms_per_frame``, ``reloc_lane_replays``)."""
    from .. import require_device
    from ..ops import pyramid as pyr_ops
    from ..pipeline import relocalize as reloc_mod
    from ..pipeline.device_fsm import STATE_LOST, StageGraph, StepState
    from ..pipeline.stream import SdvlStream

    dev = require_device(device)
    slam = SdvlStream(cfg, seed=0, device=dev,
                      gumbel_provider=gumbel_provider, graphs=graphs)
    slam.m = m

    def go_lost(near_kf: int):
        slam.write_carry(state=STATE_LOST, lost_frames=3,
                         pose=kf_poses[near_kf], xi_model=np.zeros(6))

    def run(feed):
        if on_feed is None:
            feed()
        else:
            on_feed(slam, feed)

    go_lost(8)
    synchronize(dev)
    t0 = time.perf_counter()
    run(lambda: slam.feed(q_frames[0]))
    slam.block()
    t_cold = time.perf_counter() - t0

    go_lost(8)
    synchronize(dev)
    t0 = time.perf_counter()
    run(lambda: slam.feed(q_frames[0]))
    slam.block()
    reloc_ms = 1e3 * (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for f in q_frames[1:1 + steady]:
        run(lambda f=f: slam.feed(f))
    slam.block()
    steady_ms = 1e3 * (time.perf_counter() - t0) / steady

    starts = [1 + chunk * i for i in range(n_chunks)]
    chunks = [np.stack(q_frames[i:i + chunk]) for i in starts]
    run(lambda: slam.feed_chunk(chunks[0]))
    slam.block()
    span = Spans(dev)
    t0 = time.perf_counter()
    for c in chunks:
        span.start()
        run(lambda c=c: slam.feed_chunk(c))
        span.stop()
    slam.block()
    chunk_fps = chunk * n_chunks / (time.perf_counter() - t0)
    chunk_ms = span.ms() / (chunk * n_chunks)

    img = torch.from_numpy(np.ascontiguousarray(
        q_frames[0][: slam.crop_h, : slam.crop_w])).to(dev).float()
    pyr = tuple(pyr_ops.build_pyramid(img, len(m.kf_pyr)))
    guess = torch.from_numpy(np.asarray(kf_poses[8], np.float32)).to(dev)
    lane_ms, lane_replays, by_lanes = {}, {}, {}
    for n in lanes:
        def reloc(st, pyr_, guess_, _n=n):
            return reloc_mod.relocalize(st.m, intr, pyr_, guess_, level=4,
                                        max_kf=_n)

        st = StepState(m, None, inplace=True)
        graph = (StageGraph(f"relocalize_{n}", reloc, st, (pyr, guess),
                            shared_map=True) if slam.graphs else None)
        fn = graph or (lambda p, g, _f=reloc, _s=st: _f(_s, p, g))
        fn(pyr, guess)
        span = Spans(dev)
        for _ in range(8):
            span.start()
            r = fn(pyr, guess)
            span.stop()
        synchronize(dev)
        lane_ms[n] = span.ms() / 8
        lane_replays[n] = graph.replays if graph else 0
        by_lanes[n] = reloc_mod.RelocResult(*(t.clone() for t in r))
        del fn, graph

    res = slam.result()
    states = np.asarray(res.states)
    runner = slam.runner
    stats = {
        "serve_compile_s": t_cold,
        "serve_reloc_step_ms": reloc_ms,
        "serve_steady_step_ms": steady_ms,
        "serve_chunked_fps": chunk_fps,
        "serve_relocalized": bool((states == 2).any()),
        "serve_final_state": res.state_name(),
        "serve_tracked_frames": int((states == 2).sum()),
        "reloc_lane_ms": lane_ms,
        "reloc_lane_replays": lane_replays,
        "serve_frames": int(res.n_frames),
        "serve_replays": runner.replays,
        "serve_captures": (runner.graph is not None)
        + len(runner.chunk_graphs),
        "serve_capture_s": runner.capture_s,
        "serve_pool_mib": (None if runner.pool_bytes is None
                           else runner.pool_bytes / 2 ** 20),
        "serve_chunk_ms_per_frame": chunk_ms,
    }
    return stats, res, by_lanes


def memory_gb(device) -> dict:
    """``hbm_in_use_gb`` (``torch.cuda.memory_allocated``) and the peak
    since the process began or the last reset; None off the card."""
    if torch.device(device).type != "cuda":
        return {"hbm_in_use_gb": None, "hbm_peak_gb": None}
    return {"hbm_in_use_gb": torch.cuda.memory_allocated(device) / 1e9,
            "hbm_peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}


def build_map(kf: int = KF, pts: int = PTS, kf_cap: int = KF_CAP,
              height: int = HEIGHT, width: int = WIDTH, device="cuda",
              workers=None):
    """The filled map with its set-up: (intr, scene, serving cfg, map,
    keyframe poses (kf, 7), SHA-256 of the keyframe views)."""
    from .. import require_device

    dev = require_device(device)
    if workers is None:
        workers = default_workers(dev)
    intr, scene, cfg = zurich_config(height, width, kf_cap, pts)
    kf_poses, imgs = keyframe_views(scene, kf, workers)
    sha = images_sha256(imgs)
    m = fill_map(intr, torch.from_numpy(kf_poses).to(dev),
                 torch.from_numpy(plane_points(pts)).to(dev),
                 torch.from_numpy(imgs).to(dev), kf_cap=kf_cap,
                 levels=LEVELS)
    return intr, scene, cfg, m, kf_poses, sha


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kf", type=int, default=KF,
                    help="keyframe slots to fill (of --kf-cap)")
    ap.add_argument("--kf-cap", type=int, default=KF_CAP)
    ap.add_argument("--pts", type=int, default=PTS)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--stage-iters", type=int, nargs=2, default=STAGE_ITERS)
    ap.add_argument("--no-serve", dest="serve", action="store_false",
                    help="skip the localize-only serving phase")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--draws", default=None,
                    help="npz with the perturbation's pose_noise and "
                         "pt_noise (else drawn here)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from .. import require_device

    dev = require_device(args.device)
    t_all = time.perf_counter()
    intr, scene, cfg, m, kf_poses, sha = build_map(
        args.kf, args.pts, args.kf_cap, args.height, args.width, dev)
    own, jax_layout = state_bytes(m)
    out = {"kf_capacity": args.kf_cap, "kf_filled": args.kf,
           "points": args.pts, "state_gb": own / 1e9,
           "state_gb_jax_layout": jax_layout / 1e9,
           "kf_images_sha256": sha}
    if args.serve:
        q = query_views(scene, kf_poses, workers=default_workers(dev))
        serve, _, lanes = serve_smoke(m, intr, cfg, kf_poses, q, device=dev)
        serve["reloc_lane_kf"] = {n: int(r.kf) for n, r in lanes.items()}
        out.update(serve)
    if args.draws:
        with np.load(args.draws) as z:
            pose_noise, pt_noise = (torch.from_numpy(z[k]).to(dev)
                                    for k in ("pose_noise", "pt_noise"))
    else:
        pose_noise, pt_noise = draws(args.kf_cap, args.pts, dev)
    ba = run_global_ba(m, intr, pose_noise, pt_noise, args.stage_iters)
    out.update({
        "reproj_px_before": ba["e0"],
        "reproj_px_after": ba["e1"],
        "ba_s_compile+run": ba["seconds"],
        "ba_s_warm": ba.get("replay_s", ba["seconds"]),
        "ba_capture_s": ba.get("capture_s"),
        "ba_replay_ms": (1e3 * ba["replay_s"] if "replay_s" in ba
                         else None),
        "ba_pool_mib": ba.get("pool_mib"),
        "ba_replays": ba.get("replays"),
        "ba_cg_iterations": ba["cg_iterations"],
        "ba_syncs_before_result": len(ba["sync_sites"]),
    })
    out.update(memory_gb(dev))
    out["seconds"] = time.perf_counter() - t_all
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print("zurich_scale_smoke OK")


if __name__ == "__main__":
    main()
