"""Long live-mapping run: thousands of frames filling and recycling the map.

The port's copy of the JAX package's ``tools/long_run.py`` (numpy and torch
only; nothing of the JAX package). A multi-thousand-frame tracking sequence
goes through ``SdvlStream.feed_chunk`` (on the card one graph replay per
chunk) with the full mapper in the loop: a K-slot keyframe store filled past
capacity (eviction of the furthest keyframe), redundancy pruning with anchor
re-homing, weak-point reaping, point and candidate slots recycled, and a
5-frame blackout of black frames that forces LOST, so that recovery has to
be a relocalization against map structure the run built itself.

The frames are rendered with ``io.synthetic`` (bit-identical to the JAX
package's ``cv2.remap`` frames, 0.1-0.2 s a 640x480 frame on one core), by a
pool of threads that works ahead of the feed. Two rates are reported, kept
apart:

* ``harness_fps``: frames after the first chunk over the wall clock of the
  loop that feeds them, waiting for the renderer included (the JAX tool's
  figure of the same name includes its host rendering);
* ``replay_fps``: frames after the first chunk over the time of their chunk
  replays alone (on the card the CUDA-event span of each ``feed_chunk`` on
  the stream, on the CPU the wall clock of each call), frames already
  rendered.

Asserts (``main``): finishes RUNNING, tracked ratio > 0.9, a LOST->RUNNING
relocalization after the blackout, live keyframes <= K, insertions >= 3K,
evictions and prunes > 0, a finite Sim(3) ATE over the tracked frames.

    python -m sdvl_tpu_torch.tools.long_run [--frames 13000] [--kf 100]
        [--device cuda|cpu] [--seed 0] [--json out.json]

The port's CPU test (``tests/test_torch_long_run.py``) calls
:func:`run_protocol` at the JAX package's CI scale and holds it against the
JAX tool frame by frame.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..io.synthetic import _np_se3_exp, _np_se3_inverse


def long_trajectory(n_frames: int, span: float = 8.0, y_amp: float = 0.4,
                    yaw_amp: float = 0.06, legs: int = 2,
                    loiter=None, loiter_r: float = 1.5,
                    loiter_laps: int = 3):
    """Multi-leg traveling sweep (world->cam poses, frame 0 identity).

    x sweeps [0, span] ``legs`` times with a cosine profile (a smooth
    velocity reversal at the ends), so a span longer than the live map's
    corridor keeps creating keyframes over territory the capacity cap
    already evicted. ``loiter=(t0, t1)`` pauses the sweep over that time
    fraction and orbits a circle of radius ``loiter_r`` instead
    (``loiter_laps`` laps, cosine-ramped), re-observing the same ground at
    the same scale, which is what redundancy pruning needs.
    """
    l0, l1 = loiter if loiter else (1.0, 1.0)
    d = l1 - l0
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        dx = dy = 0.0
        if loiter and l0 <= t < l1:
            tau = l0 / max(1.0 - d, 1e-9)
            lt = (t - l0) / d
            ang = 2 * np.pi * loiter_laps * 0.5 * (1 - np.cos(np.pi * lt))
            dx = loiter_r * np.sin(ang)
            dy = loiter_r * (1.0 - np.cos(ang))
        else:
            tau = (t if t < l0 else t - d) / max(1.0 - d, 1e-9)
        sweep = 0.5 * (1.0 - np.cos(np.pi * legs * tau))
        ph = i / 90.0
        xi = np.array([
            span * sweep + dx,
            y_amp * np.sin(2 * np.pi * ph) + dy,
            0.2 * np.sin(2 * np.pi * t),
            yaw_amp * np.sin(2 * np.pi * ph),
            yaw_amp * np.cos(2 * np.pi * ph * 0.25) - yaw_amp,
            0.5 * yaw_amp * np.sin(2 * np.pi * ph * 0.33),
        ], np.float32)
        poses.append(_np_se3_inverse(_np_se3_exp(xi)))
    return poses


def lawnmower_trajectory(n_frames: int, ax: float = 30.0,
                         y0: float = -28.0, y1: float = 28.0,
                         k: int = 12, legs: int = 2,
                         yaw_amp: float = 0.05):
    """Boustrophedon sweep inside the textured extent (world->cam poses).

    x oscillates sinusoidally over [-ax, ax] ``k`` times while y advances
    across [y0, y1] and back (``legs`` passes, cosine profile): a path of
    about 4 ax k + |y1 - y0| legs world units. Adjacent rows overlap, so
    revisited points gain same-scale co-observers.
    """
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        x = ax * np.sin(2 * np.pi * k * t)
        y = y0 + (y1 - y0) * 0.5 * (1.0 - np.cos(np.pi * legs * t))
        ph = i / 90.0
        xi = np.array([
            x,
            y,
            0.2 * np.sin(2 * np.pi * t),
            yaw_amp * np.sin(2 * np.pi * ph),
            yaw_amp * np.cos(2 * np.pi * ph * 0.25) - yaw_amp,
            0.5 * yaw_amp * np.sin(2 * np.pi * ph * 0.33),
        ], np.float32)
        poses.append(_np_se3_inverse(_np_se3_exp(xi)))
    return poses


def render_frame(scene, pose, black: bool) -> np.ndarray:
    """One uint8 frame of the protocol: black, or ``scene`` rendered at
    ``pose`` and rounded as the JAX tool rounds it."""
    if black:
        return np.zeros((scene.height, scene.width), np.uint8)
    return np.round(np.clip(scene.render(pose), 0, 255)).astype(np.uint8)


# frames the render threads may work ahead of the feed (about 20 MB)
RENDER_AHEAD = 64


def rendered_frames(scene, poses, blackout, workers: int):
    """The protocol's frames in order. With ``workers`` > 0 that many
    threads render at most :data:`RENDER_AHEAD` frames ahead of the
    consumer (numpy releases the GIL in the renderer's array work); with 0
    each frame is rendered when it is asked for."""
    if workers <= 0:
        for i, p in enumerate(poses):
            yield render_frame(scene, p, i in blackout)
        return
    if not len(poses):
        return
    # the first frame here: rendering it builds the scene's ray grid, which
    # the threads then only read
    first = render_frame(scene, poses[0], False)
    yield np.zeros_like(first) if 0 in blackout else first
    pool = concurrent.futures.ThreadPoolExecutor(workers)
    try:
        pending = collections.deque()
        nxt = 1
        for _ in range(1, len(poses)):
            while nxt < len(poses) and len(pending) < RENDER_AHEAD:
                pending.append(pool.submit(render_frame, scene, poses[nxt],
                                           nxt in blackout))
                nxt += 1
            yield pending.popleft().result()
    finally:
        pool.shutdown(cancel_futures=True)


def default_workers(device) -> int:
    """Render threads by default: one less than the CPU cores when the
    stream runs on the card (the feeding thread keeps one), none on the CPU
    (each frame rendered inline, between the steps)."""
    if torch.device(device).type != "cuda":
        return 0
    return max(1, (os.cpu_count() or 2) - 1)


def lost_segments(states: np.ndarray) -> list:
    """[first, last] frame of each run of LOST frames."""
    is_lost = states == 3
    edges = np.diff(is_lost.astype(np.int8))
    seg_start = (np.flatnonzero(edges == 1) + 1).tolist()
    seg_end = np.flatnonzero(edges == -1).tolist()
    if len(is_lost) and is_lost[0]:
        seg_start = [0] + seg_start
    if len(seg_end) < len(seg_start):
        seg_end.append(len(states) - 1)
    return [[int(a), int(b)] for a, b in zip(seg_start, seg_end)]


def run_protocol(cfg, scene, n_frames: int, chunk: int = 16,
                 blackout_frac: float = 0.6, blackout_len: int = 5,
                 span: float = 8.0, legs: int = 2, loiter=None,
                 poses=None, seed: int = 0, device="cuda",
                 gumbel_provider=None, graphs=None, on_chunk=None):
    """Feed a long sweep (``long_trajectory`` unless ``poses`` are given)
    through ``SdvlStream(cfg).feed_chunk`` in chunks of ``chunk`` frames,
    with ``blackout_len`` black frames from ``int(n_frames *
    blackout_frac)`` on, so that recovery must come from relocalization
    against map structure the run built itself.

    ``device``, ``gumbel_provider`` and ``graphs`` go to ``SdvlStream``;
    the frames render in :func:`default_workers` threads ahead of the feed.
    ``on_chunk(stream, feed)``, where given, is called for each chunk in
    place of ``feed()``, which feeds it.

    Returns (result, gt_poses, stats): the JAX tool's ``stats`` keys, plus
    ``replay_fps`` (frames after the first chunk over their chunk replays'
    time), ``frames_sha256`` (the fed uint8 frames in order), ``chunks``,
    ``replays`` (graph replays: one per chunk on the graph path, else 0),
    and on the graph path the chunk graphs' ``capture_s`` and ``pool_mib``.
    No asserts.
    """
    from .. import require_device
    from ..io import evaluate
    from ..pipeline.stream import SdvlStream

    dev = require_device(device)
    if poses is None:
        poses = long_trajectory(n_frames, span=span, legs=legs,
                                loiter=loiter)
    b0 = int(n_frames * blackout_frac)
    blackout = set(range(b0, b0 + blackout_len))

    slam = SdvlStream(cfg, seed=seed, device=dev,
                      gumbel_provider=gumbel_provider, graphs=graphs)
    cuda = dev.type == "cuda"
    digest = hashlib.sha256()
    frames = rendered_frames(scene, poses[:n_frames], blackout,
                             default_workers(dev))
    spans = []       # (start, end) of each chunk's feed: events or seconds
    n_done = 0
    t_comp = None
    t0 = time.perf_counter()
    try:
        while n_done < n_frames:
            n = min(chunk, n_frames - n_done)
            imgs = np.stack([next(frames) for _ in range(n)])
            digest.update(imgs.tobytes())
            if cuda:
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            else:
                marks = [time.perf_counter(), None]

            def feed(imgs=imgs):
                slam.feed_chunk(imgs)

            if on_chunk is None:
                feed()
            else:
                on_chunk(slam, feed)
            if cuda:
                marks[1].record()
            else:
                marks[1] = time.perf_counter()
            spans.append(marks)
            n_done += n
            if t_comp is None:
                slam.block()          # first chunk: capture + bootstrap
                t_comp = time.perf_counter() - t0
                t0 = time.perf_counter()
    finally:
        frames.close()      # stops the render pool
    slam.block()
    wall = time.perf_counter() - t0
    n_steady = n_frames - min(chunk, n_frames)  # first chunk off the clock
    replay_s = sum((a.elapsed_time(b) / 1e3 if cuda else b - a)
                   for a, b in spans[1:])

    r = slam.result()
    states = np.asarray(r.states)
    running = states == 2
    # LOST->RUNNING after the blackout's start: a real relocalization
    after = np.arange(len(states)) >= b0
    reloc_ok = bool(np.any((states[:-1] == 3) & (states[1:] == 2)
                           & after[1:]))
    m = slam.m
    idx = np.flatnonzero(running)
    gt = np.stack(poses[:n_frames])
    ate = None
    if len(idx) > 30:
        p_est = evaluate.positions_from_poses(r.trajectory[idx])
        p_gt = evaluate.positions_from_poses(gt[idx])
        ate = float(evaluate.ate_rmse(p_est, p_gt, with_scale=True))

    lost = np.flatnonzero(states == 3)
    nm = np.asarray(r.n_matches)
    stats = {
        "frames": int(n_frames),
        "tracked_ratio": round(float(running.mean()), 4),
        "first_lost_frame": int(lost[0]) if len(lost) else None,
        "n_lost_frames": int(len(lost)),
        "lost_segments": lost_segments(states),
        "matches_before_first_lost": (
            [int(x) for x in nm[max(0, lost[0] - 12): lost[0]]]
            if len(lost) else []),
        "n_keyframe_frames": int(np.asarray(r.is_keyframe).sum()),
        "final_state": r.state_name(),
        "reloc_after_blackout": reloc_ok,
        "keyframes_live": int(m.kf_valid.sum()),
        "keyframes_total_inserted": int(m.n_keyframes),
        # counted on the device (MapState.n_evicted / n_pruned): eviction
        # by the capacity cap, pruning of redundant keyframes
        "evictions": int(m.n_evicted),
        "prunes": int(m.n_pruned),
        "points_live": int(m.pt_valid.sum()),
        "ate_rmse": None if ate is None else round(ate, 4),
        # the loop's wall clock, waiting for the renderer included
        "harness_fps": round(n_steady / wall, 1),
        # the first chunk: the capture (graph path) and the bootstrap
        "compile_s": round(t_comp, 1),
        # the chunk replays alone, frames already rendered
        "replay_fps": (round(n_steady / replay_s, 2) if replay_s > 0
                       else None),
        "frames_sha256": digest.hexdigest(),
        "chunks": len(spans),
        "replays": slam.runner.replays,
    }
    graphs_ = slam.runner.chunk_graphs
    if graphs_:
        stats["capture_s"] = {int(t): round(g.capture_s, 3)
                              for t, g in graphs_.items()}
        stats["pool_mib"] = {int(t): g.pool_bytes / 2 ** 20
                             for t, g in graphs_.items()}
    return r, gt, stats


def long_run_config(kf: int, points: int):
    """The JAX tool's 640x480 configuration (``main``) at ``kf`` keyframe
    and ``points`` point slots, and its scene: a plane at z = 8 under a
    4096-px texture (about 65 px of image per world unit, as the texture's
    60)."""
    from ..io.synthetic import PlaneScene, make_texture
    from ..pipeline.config import CameraConfig, Config, SdvlConfig

    z = 8.0
    scene = PlaneScene(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                       width=640, height=480, plane_z=z, extent=34.0,
                       texture=make_texture(4096, seed=0))
    cfg = Config(
        camera=CameraConfig(width=640, height=480, fx=517.3, fy=516.5,
                            u0=318.6, v0=255.3, dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(min_avg_shift=10.0, max_keyframes=kf,
                        min_keyframe_its=10, min_init_corners=40,
                        max_points=points, max_candidates=512,
                        map_scale=z),
    )
    return cfg, scene


def check_stats(stats: dict, kf: int) -> None:
    """The JAX tool's assertions on a run's ``stats``."""
    assert stats["final_state"] == "RUNNING", stats
    assert stats["tracked_ratio"] > 0.9, stats
    assert stats["reloc_after_blackout"], stats
    assert stats["keyframes_live"] <= kf, stats
    assert stats["keyframes_total_inserted"] >= 3 * kf, stats
    assert stats["evictions"] > 0 and stats["prunes"] > 0, stats
    assert stats["ate_rmse"] is not None and np.isfinite(stats["ate_rmse"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=13000)
    ap.add_argument("--kf", type=int, default=100)
    ap.add_argument("--rows", type=int, default=12,
                    help="lawnmower x-periods (path ~ 4*30*rows units; "
                         "must exceed the live corridor, ~kf*4.6 units, "
                         "for eviction churn)")
    ap.add_argument("--legs", type=int, default=2)
    ap.add_argument("--points", type=int, default=None,
                    help="point-slot capacity; defaults to 160*kf (points "
                         "are recycled only when their observers die, so "
                         "the store must grow with the keyframe store)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.points is None:
        args.points = 160 * args.kf
    cfg, scene = long_run_config(args.kf, args.points)
    poses = lawnmower_trajectory(args.frames, k=args.rows, legs=args.legs)
    _, _, stats = run_protocol(cfg, scene, args.frames, poses=poses,
                               seed=args.seed, device=args.device)
    print(json.dumps(stats, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=1)
    check_stats(stats, args.kf)
    print("LONG_RUN_OK")


if __name__ == "__main__":
    main()
