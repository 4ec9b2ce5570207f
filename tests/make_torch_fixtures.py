"""Build the fixtures that the PyTorch port's GPU smoke run loads.

The GPU machine that runs ``chip_smoke.py`` has neither JAX nor OpenCV, so
the reference runs are made once, on a CPU, with the JAX package, and
committed under ``tests/data/``:

* ``torch_localize_map.npz`` -- a ``FORMAT_VERSION 1`` stream snapshot
  (``sdvl_tpu.io.snapshot.save_stream_snapshot``) of a SLAM stream over 40
  rendered ``PlaneScene`` frames, at the tum_f1 preset shape (640x480,
  ``use_orb``, 1000 features, 200 matches, 100 keyframe slots, 4096 point
  slots, 512 candidate slots).
* ``torch_localize_query.npz`` -- the uint8 query frames ``frames[8:32]``,
  their ground-truth poses, the JAX localizer's own per-frame result on them
  (fused detection off, ``seed=1``) and the Gumbel noise its pose RANSAC drew
  for each frame, so that the port can be fed the same draws.
* ``torch_slam_record.npz`` (``--slam-record``, which writes this file
  only) -- the JAX SLAM stream in full SLAM mode over 85 frames of the same
  trajectory (its first 40 are the map's frames: ``PlaneScene.trajectory``
  is a prefix for any length) at the same preset, past the first keyframe
  after the bootstrap, with ``use_pallas_detect`` on (the Pallas kernel in
  interpret mode), so that the card's Pallas border rule is held to the
  same detection function: the SHA-256 of the uint8 frames (the GPU run
  renders them itself), the ground-truth poses, every random draw of the
  run (the homography and ground-plane RANSAC noise, and the pose-RANSAC
  noise of each frame that tracks), the per-frame record and the final
  map's keyframe count, keyframe frame ids and point count.

* ``torch_long_run_record.npz`` (``--long-record``, which writes this file
  only) -- the JAX package's long live-mapping run (``tools/long_run.py``,
  ``run_protocol``) at the configuration of its ``main`` (640x480, a plane
  at z = 8 under a 4096-px texture, a lawnmower path, a 5-frame blackout)
  cut to ``LONG_KF`` keyframe slots and ``LONG_FRAMES`` frames, once per
  seed of ``LONG_SEEDS``: the SHA-256 of the uint8 frames, the protocol's
  numbers (so that the card run reads them from here), and per seed the
  per-frame states, keyframe flags, match counts and trajectory, and the
  tool's ``stats``. The per-frame RANSAC noise is not stored: the card run
  draws its own, and the seeds measure the reference's own spread.

Run from the repository root (CPU is enough, a few minutes of XLA compile;
``--long-record`` about 5 minutes a seed):

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --slam-record
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --long-record
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

N_MAP_FRAMES = 40
N_RECORD_FRAMES = 85
QUERY = slice(8, 32)


def preset_setup():
    """Scene and config of the tum_f1 preset shape (the benchmark's
    ``preset=True`` setup)."""
    from sdvl_tpu.io.synthetic import PlaneScene
    from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig

    scene = PlaneScene(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                       width=640, height=480, plane_z=4.0)
    sdvl = SdvlConfig(use_orb=True, num_features=1000, max_matches=200,
                      max_keyframes=100, max_points=4096,
                      fast_threshold=10.0, cell_size=32,
                      min_avg_shift=10.0, min_keyframe_its=15,
                      min_init_corners=40, map_scale=4.0, max_candidates=512)
    cfg = Config(
        camera=CameraConfig(width=640, height=480, fx=517.3, fy=516.5,
                            u0=318.6, v0=255.3, dist=(0, 0, 0, 0, 0)),
        sdvl=sdvl,
    )
    return scene, cfg


def ransac_gumbel(key, frame_id: int, n_hyp: int, n_lanes: int) -> np.ndarray:
    """The (n_hyp, n_lanes) Gumbel noise that ``solvers.pose.ransac`` draws
    on frame ``frame_id`` of a stream whose carry holds ``key``."""
    import jax

    k = jax.random.fold_in(key, frame_id)
    keys = jax.random.split(k, n_hyp)
    g = jax.vmap(
        lambda kk: jax.random.gumbel(kk, (n_lanes,), jax.numpy.float32)
    )(keys)
    return np.asarray(g)


def homography_gumbel(key, n_corners: int, n_hyp: int = 128) -> np.ndarray:
    """The (n_hyp, n_corners) Gumbel noise of the two-view bootstrap's
    homography RANSAC on a stream whose carry holds ``key`` (the same on
    every SECOND-state attempt)."""
    import jax

    keys = jax.random.split(jax.random.fold_in(key, 0), n_hyp)
    g = jax.vmap(
        lambda kk: jax.random.gumbel(kk, (n_corners,), jax.numpy.float32)
    )(keys)
    return np.asarray(g)


def plane_gumbel(key, n_points: int, iters: int = 64) -> np.ndarray:
    """The (iters, n_points) Gumbel noise of the ground-plane RANSAC that
    aligns the freshly seeded map."""
    import jax

    k1, _ = jax.random.split(jax.random.fold_in(key, 1))
    keys = jax.random.split(k1, iters)
    g = jax.vmap(
        lambda kk: jax.random.gumbel(kk, (n_points,), jax.numpy.float32)
    )(keys)
    return np.asarray(g)


def frames_sha256(frames) -> str:
    """SHA-256 over the uint8 frames, in order."""
    import hashlib

    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f, np.uint8).tobytes())
    return h.hexdigest()


def slam_record(out_dir: str) -> str:
    """Write ``torch_slam_record.npz``; returns its path."""
    import dataclasses
    import functools

    import sdvl_tpu.ops.pallas.detect as pallas_detect
    from sdvl_tpu.pipeline.stream import SdvlStream

    # the Pallas kernel on the CPU: interpret mode (ops/fast.py imports the
    # function at call time)
    pallas_detect.fast_shi_tomasi_map = functools.partial(
        pallas_detect.fast_shi_tomasi_map, interpret=True)

    scene, cfg = preset_setup()
    cfg = dataclasses.replace(cfg, sdvl=dataclasses.replace(
        cfg.sdvl, use_pallas_detect=True))
    poses_gt = scene.trajectory(N_RECORD_FRAMES, translation_amp=1.0)
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses_gt]

    slam = SdvlStream(cfg, seed=0, donate=False)
    for f in frames:
        slam.feed(f)
    r = slam.result()
    assert r.is_keyframe[3:].any(), "no keyframe after the bootstrap"
    print("slam record: states", r.states.tolist())
    print("slam record: keyframes", r.is_keyframe.astype(int).tolist())
    print("slam record: matches", r.n_matches.tolist())

    key = slam.carry.key
    s = cfg.sdvl
    n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
    n_lanes = int(slam.carry.last_idx.shape[0])
    n_corners = int(slam.carry.c1_xy.shape[0])
    # frames that track (state before the frame RUNNING or LOST) draw
    # pose-RANSAC noise from fold_in(key, frame_id)
    before = np.concatenate([[0], r.states[:-1]])
    pose_frames = np.nonzero(before >= 2)[0].astype(np.int32)
    pose_noise = np.stack([ransac_gumbel(key, int(i), n_hyp, n_lanes)
                           for i in pose_frames])
    # the per-frame world re-basing (non-identity at ground-plane alignment)
    world_tf = np.asarray(np.concatenate(
        [i.world_tf[None] for _, i in slam._infos]))

    path = os.path.join(out_dir, "torch_slam_record.npz")
    np.savez_compressed(
        path,
        frames_sha256=np.frombuffer(frames_sha256(frames).encode(),
                                    dtype=np.uint8),
        frame_shape=np.asarray(frames[0].shape, np.int32),
        poses_gt=np.stack(poses_gt).astype(np.float32),
        homography_gumbel=homography_gumbel(key, n_corners),
        plane_gumbel=plane_gumbel(key, s.max_points),
        pose_frames=pose_frames,
        pose_gumbel=pose_noise.astype(np.float32),
        jax_pose=r.poses_raw.astype(np.float32),
        jax_world_tf=world_tf.astype(np.float32),
        jax_trajectory=r.trajectory.astype(np.float32),
        jax_state=r.states.astype(np.int32),
        jax_quality=r.quality.astype(np.int32),
        jax_n_matches=r.n_matches.astype(np.int32),
        jax_n_attempts=r.n_attempts.astype(np.int32),
        jax_is_keyframe=r.is_keyframe,
        jax_n_corners=r.n_corners.astype(np.int32),
        jax_median_shift=r.median_shift.astype(np.float32),
        jax_n_keyframes=np.asarray(slam.m.n_keyframes, np.int32),
        jax_kf_frame_id=np.asarray(slam.m.kf_frame_id, np.int32),
        jax_n_points=np.asarray(np.sum(np.asarray(slam.m.pt_valid)),
                                np.int32),
    )
    print(path, os.path.getsize(path) / 1e6, "MB")
    return path


# The long run's protocol at the card's depth: the JAX tool's 640x480
# configuration (tools/long_run.py main) cut from 100 keyframe slots and
# 13000 frames to these, the lawnmower shrunk with it so that the image
# moves about as far per frame as at the tool's defaults
LONG_KF = 12
LONG_FRAMES = 2400
LONG_PATH = dict(ax=12.0, y0=-6.0, y1=6.0, k=5, legs=2)
LONG_CHUNK = 16
LONG_BLACKOUT = (0.6, 5)      # fraction of the run, frames
LONG_SEEDS = (0, 1, 2)


def long_setup(kf: int = LONG_KF):
    """Scene and config of the JAX tool's ``main`` (``tools/long_run.py``)
    at ``kf`` keyframe slots (160 point slots each)."""
    from sdvl_tpu.io.synthetic import PlaneScene, make_texture
    from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig

    z = 8.0
    scene = PlaneScene(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                       width=640, height=480, plane_z=z, extent=34.0,
                       texture=make_texture(4096, seed=0))
    cfg = Config(
        camera=CameraConfig(width=640, height=480, fx=517.3, fy=516.5,
                            u0=318.6, v0=255.3, dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(min_avg_shift=10.0, max_keyframes=kf,
                        min_keyframe_its=10, min_init_corners=40,
                        max_points=160 * kf, max_candidates=512,
                        map_scale=z),
    )
    return scene, cfg


def long_record(out_dir: str) -> str:
    """Write ``torch_long_run_record.npz``; returns its path."""
    import json

    from tools.long_run import lawnmower_trajectory, run_protocol

    scene, cfg = long_setup()
    poses = lawnmower_trajectory(LONG_FRAMES, **LONG_PATH)
    frac, length = LONG_BLACKOUT
    b0 = int(LONG_FRAMES * frac)
    black = set(range(b0, b0 + length))
    frames = [np.zeros((scene.height, scene.width), np.uint8) if i in black
              else np.round(np.clip(scene.render(p), 0, 255)).astype(np.uint8)
              for i, p in enumerate(poses)]
    runs = []
    for seed in LONG_SEEDS:
        r, _, stats = run_protocol(cfg, scene, LONG_FRAMES,
                                   chunk=LONG_CHUNK, blackout_frac=frac,
                                   blackout_len=length, poses=poses,
                                   seed=seed)
        print(f"long record, seed {seed}:", json.dumps(stats))
        runs.append((r, stats))
    path = os.path.join(out_dir, "torch_long_run_record.npz")
    np.savez_compressed(
        path,
        frames_sha256=np.frombuffer(frames_sha256(frames).encode(),
                                    dtype=np.uint8),
        protocol=np.frombuffer(json.dumps(dict(
            kf=LONG_KF, points=160 * LONG_KF, frames=LONG_FRAMES,
            path=LONG_PATH, chunk=LONG_CHUNK, blackout_frac=frac,
            blackout_len=length)).encode(), dtype=np.uint8),
        seeds=np.asarray(LONG_SEEDS, np.int32),
        jax_state=np.stack([r.states for r, _ in runs]).astype(np.int8),
        jax_is_keyframe=np.stack([r.is_keyframe for r, _ in runs]),
        jax_n_matches=np.stack([r.n_matches for r, _ in runs]
                               ).astype(np.int16),
        jax_trajectory=np.stack([r.trajectory for r, _ in runs]
                                ).astype(np.float32),
        jax_stats=np.frombuffer(json.dumps([s for _, s in runs]).encode(),
                                dtype=np.uint8),
    )
    print(path, os.path.getsize(path) / 1e6, "MB")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data"))
    ap.add_argument("--slam-record", action="store_true",
                    help="write torch_slam_record.npz only")
    ap.add_argument("--long-record", action="store_true",
                    help="write torch_long_run_record.npz only")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.slam_record or args.long_record:
        os.makedirs(args.out, exist_ok=True)
        (slam_record if args.slam_record else long_record)(args.out)
        return

    from sdvl_tpu.io.snapshot import save_stream_snapshot
    from sdvl_tpu.pipeline.stream import SdvlStream

    os.makedirs(args.out, exist_ok=True)
    scene, cfg = preset_setup()
    poses_gt = scene.trajectory(N_MAP_FRAMES, translation_amp=1.0)
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses_gt]

    slam = SdvlStream(cfg, seed=0, donate=False)
    for f in frames:
        slam.feed(f)
    r_map = slam.result()
    print("mapping: final state", r_map.state_name(),
          "keyframes", int(np.sum(r_map.is_keyframe)),
          "matches", r_map.n_matches.tolist())
    map_path = os.path.join(args.out, "torch_localize_map.npz")
    save_stream_snapshot(slam, map_path)

    loc = SdvlStream.localizer(cfg, map_path, seed=1, donate=False)
    key = loc.carry.key
    frame_id0 = int(loc.carry.frame_id)
    s = cfg.sdvl
    n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
    n_lanes = int(loc.carry.last_idx.shape[0])
    query = frames[QUERY]
    gumbel = np.stack([
        ransac_gumbel(key, frame_id0 + i, n_hyp, n_lanes)
        for i in range(len(query))
    ])
    for f in query:
        loc.feed(f)
    r = loc.result()
    print("localizer: states", r.states.tolist())
    print("localizer: matches", r.n_matches.tolist())

    query_path = os.path.join(args.out, "torch_localize_query.npz")
    np.savez_compressed(
        query_path,
        frames=np.stack(query),
        poses_gt=np.stack(poses_gt[QUERY]).astype(np.float32),
        gumbel=gumbel.astype(np.float32),
        jax_pose=r.poses_raw.astype(np.float32),
        jax_trajectory=r.trajectory.astype(np.float32),
        jax_state=r.states.astype(np.int32),
        jax_quality=r.quality.astype(np.int32),
        jax_n_matches=r.n_matches.astype(np.int32),
        jax_n_attempts=r.n_attempts.astype(np.int32),
    )
    for p in (map_path, query_path):
        print(p, os.path.getsize(p) / 1e6, "MB")


if __name__ == "__main__":
    main()
