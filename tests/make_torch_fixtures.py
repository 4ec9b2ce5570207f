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
* ``torch_zurich_record.npz`` (``--zurich-record``, which writes this file
  only) -- the JAX package's Zurich-capacity smoke
  (``tools/zurich_scale_smoke.py``) at its defaults, composed from
  ``sdvl_tpu`` functions line by line (``jax_zurich_fill``,
  ``jax_zurich_serve``, ``jax_zurich_draws``, ``jax_zurich_ba``), and its
  capacity probe's sequence (``tools/capacity_probe.py``): the SHA-256 of
  the float32 keyframe views, the perturbation draws, the reprojection
  error before and after global BA (one call), the filled slots' poses, the
  points, the gated observations and the CG iterations of each LM step
  after it; the serving run's states, match counts and poses; each lane
  budget's relocalizer result; and the probe's per-frame states, keyframe
  flags, match counts and trajectories at K = 100, 300 and 1000, and at K =
  100 under seeds 1 and 2. No images and no RANSAC draws: the card renders
  and draws its own.

Run from the repository root (CPU is enough, a few minutes of XLA compile;
``--long-record`` about 5 minutes a seed, ``--zurich-record`` about 30
minutes on 8 cores):

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --slam-record
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --long-record
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --zurich-record
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


# tools/zurich_scale_smoke.py's defaults: 320 of 1000 keyframe slots filled,
# 4096 points, 640x480, 5 levels, global BA's stage iterations, the lane
# budgets of its standalone relocalizer; tools/capacity_probe.py's sequence
ZURICH = dict(kf_cap=1000, kf=320, pts=4096, height=480, width=640,
              levels=5, stage_iters=(4, 6))
ZURICH_LANES = (16, 64, 256)
PROBE_FRAMES, PROBE_CHUNK, PROBE_KS = 320, 16, (100, 300, 1000)
# the probe at K = 100 again under other random draws: the reference's own
# spread, against which a run that draws its own noise is held
PROBE_SEEDS = (1, 2)


def render_threads(fn, items) -> list:
    """``[fn(x) for x in items]`` in a pool of threads (the renderers'
    array work releases the GIL), as the port's tools render."""
    from sdvl_tpu_torch.tools.zurich_scale_smoke import render_all

    return render_all(fn, items, workers=os.cpu_count() or 1)


def jax_zurich_fill(kf_cap, kf, pts, height, width, levels):
    """``tools/zurich_scale_smoke.py:59-107`` with the JAX package at these
    sizes. Returns (intr, scene, map, keyframe poses (kf, 7), the float32
    keyframe images)."""
    import jax
    import jax.numpy as jnp

    from sdvl_tpu.core import camera, se3
    from sdvl_tpu.io.synthetic import PlaneScene
    from sdvl_tpu.ops import pyramid
    from sdvl_tpu.state.map_state import empty_map, store_pyramid
    from sdvl_tpu_torch.tools.zurich_scale_smoke import zurich_camera

    c = zurich_camera(height, width)
    intr = camera.Intrinsics.create(c["fx"], c["fy"], c["cx"], c["cy"],
                                    width=width, height=height)
    scene = PlaneScene(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                       width=width, height=height, plane_z=4.0)
    m = empty_map(n_kf=kf_cap, n_pts=pts, n_cand=8,
                  img_shape=(height, width), levels=levels)
    rs = np.random.default_rng(0)
    pts_w = np.concatenate([
        rs.uniform([-3.5, -2.5], [3.5, 2.5], (pts, 2)),
        np.full((pts, 1), 4.0),
    ], axis=1).astype(np.float32)
    Kn = kf
    kf_poses = np.stack(scene.trajectory(Kn, translation_amp=1.5)
                        ).astype(np.float32)

    @jax.jit
    def fill(m, kf_poses, pts_w, imgs):
        p_cam = se3.transform(kf_poses[:, None], pts_w[None])
        px = jax.vmap(lambda pc: camera.project(intr, pc))(p_cam)
        vis = ((p_cam[..., 2] > 0.1)
               & jax.vmap(lambda q: camera.in_bounds(intr, q, margin=8))(px))
        kf_ids = jnp.arange(Kn, dtype=jnp.int32)
        pyrs = jax.vmap(lambda im: tuple(
            store_pyramid(pyramid.build_pyramid(im, levels))))(imgs)
        kf_pyr = tuple(lvl.at[:Kn].set(p) for lvl, p in zip(m.kf_pyr, pyrs))
        return m._replace(
            kf_pose=m.kf_pose.at[:Kn].set(kf_poses),
            kf_valid=m.kf_valid.at[:Kn].set(True),
            kf_frame_id=m.kf_frame_id.at[:Kn].set(kf_ids),
            kf_pyr=kf_pyr,
            n_keyframes=jnp.asarray(Kn, jnp.int32),
            pt_pos=jnp.asarray(pts_w),
            pt_valid=jnp.ones(pts, bool),
            pt_anchor_kf=jnp.zeros(pts, jnp.int32),
            pt_found=jnp.full(pts, 3, jnp.int32),
            obs_mask=m.obs_mask.at[:Kn].set(vis),
            obs_px=m.obs_px.at[:Kn].set(px + 0.3),
        )

    imgs = np.stack(render_threads(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.float32),
        kf_poses))
    m = fill(m, jnp.asarray(kf_poses), jnp.asarray(pts_w), jnp.asarray(imgs))
    jax.block_until_ready(m.kf_pose)
    return intr, scene, m, kf_poses, imgs


def jax_zurich_draws(kf_cap: int, pts: int):
    """The Zurich tool's perturbation draws (``:122-135``): pose noise
    (kf_cap, 6), rows 0 and 1 zeroed, and point noise (pts, 3), as the
    tool's jitted ``perturb`` computes them from ``PRNGKey(1)``."""
    import jax

    dk, pk = jax.random.split(jax.random.PRNGKey(1))

    @jax.jit
    def draws(dk, pk):
        noise = 0.01 * jax.random.normal(dk, (kf_cap, 6))
        noise = noise.at[:2].set(0.0)
        return noise, 0.02 * jax.random.normal(pk, (pts, 3))

    return tuple(np.array(a, np.float32) for a in draws(dk, pk))


def jax_zurich_ba(intr, m, stage_iters):
    """The Zurich tool's perturbation, reprojection error and global BA
    (``:122-168``) with the JAX package. Returns (perturbed map, map after
    BA, e0, e1, the CG iterations of each LM step)."""
    import jax
    import jax.numpy as jnp

    from sdvl_tpu.core import camera, se3
    from sdvl_tpu.pipeline import mapper

    K_CAP = m.kf_pose.shape[0]
    dk, pk = jax.random.split(jax.random.PRNGKey(1))

    @jax.jit
    def perturb(m, dk, pk):
        noise = 0.01 * jax.random.normal(dk, (K_CAP, 6))
        noise = noise.at[:2].set(0.0)
        poses = jax.vmap(lambda p, x: se3.compose(se3.exp(x), p))(
            m.kf_pose, noise)
        pts = m.pt_pos + 0.02 * jax.random.normal(pk, m.pt_pos.shape)
        return m._replace(kf_pose=poses, pt_pos=pts)

    @jax.jit
    def reproj_err(m):
        p_cam = se3.transform(m.kf_pose[:, None], m.pt_pos[None])
        px = jax.vmap(lambda pc: camera.project(intr, pc))(p_cam)
        e = jnp.linalg.norm(px - m.obs_px, axis=-1)
        w = m.obs_mask & m.kf_valid[:, None] & m.pt_valid[None, :]
        return jnp.sum(jnp.where(w, e, 0)) / jnp.maximum(jnp.sum(w), 1)

    m_noisy = perturb(m, dk, pk)
    e0 = float(reproj_err(m_noisy))
    # the PCG's while_loop reports its iteration count (its carry's last
    # leaf) through a callback, which reads and changes nothing
    cg = []
    while_loop = jax.lax.while_loop

    def counted(cond, body, init):
        out = while_loop(cond, body, init)
        jax.debug.callback(lambda i: cg.append(int(i)), out[-1])
        return out

    jax.lax.while_loop = counted
    try:
        m_ba = jax.jit(lambda mm: mapper.global_ba(
            mm, intr, stage_iters=tuple(stage_iters)))(m_noisy)
        jax.block_until_ready(m_ba.kf_pose)
    finally:
        jax.lax.while_loop = while_loop
    e1 = float(reproj_err(m_ba))
    return m_noisy, m_ba, e0, e1, cg


def serve_config_jax(height, width, kf_cap, pts):
    """The Zurich tool's serving ``Config`` (``:192-199``)."""
    from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig
    from sdvl_tpu_torch.tools.zurich_scale_smoke import zurich_camera

    c = zurich_camera(height, width)
    return Config(
        camera=CameraConfig(width=width, height=height, fx=c["fx"],
                            fy=c["fy"], u0=c["cx"], v0=c["cy"],
                            dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(max_keyframes=kf_cap, max_points=pts,
                        max_candidates=8, localize_only=True,
                        reloc_max_keyframes=64, map_scale=4.0,
                        min_avg_shift=10.0),
    )


def query_frames(scene, kf_poses, n: int = 130) -> list:
    """The serving phase's uint8 query frames: keyframe poses 10 .. 10 + n
    - 1 rendered again (``:211-214``; truncated, as the tool casts)."""
    return render_threads(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.uint8),
        [kf_poses[10 + i] for i in range(n)])


def jax_zurich_serve(cfg, m, intr, kf_poses, q_frames, lanes=ZURICH_LANES,
                     chunk: int = 32, steady: int = 64, n_chunks: int = 4):
    """The Zurich tool's serving phase (``:200-260``) with the JAX
    package: the localize-only stream over ``m`` started LOST near keyframe
    8, the reloc step twice, ``steady`` feeds, the chunk program's first
    chunk then ``n_chunks`` chunks of ``chunk`` frames (the first fed
    again, as the tool does), and the standalone relocalizer at each lane
    budget. Returns (stream, result, {lanes: RelocResult as numpy})."""
    import jax
    import jax.numpy as jnp

    from sdvl_tpu.ops import pyramid as pyr_ops
    from sdvl_tpu.pipeline import relocalize as reloc_mod
    from sdvl_tpu.pipeline.device_fsm import STATE_LOST
    from sdvl_tpu.pipeline.stream import SdvlStream

    slam = SdvlStream(cfg, seed=0, donate=False)
    slam.m = m

    def go_lost(near_kf: int):
        slam.carry = slam.carry._replace(
            state=jnp.asarray(STATE_LOST, jnp.int32),
            lost_frames=jnp.asarray(3, jnp.int32),
            pose=jnp.asarray(kf_poses[near_kf]),
            xi_model=jnp.zeros(6, jnp.float32),
        )

    go_lost(8)
    slam.feed(q_frames[0], block=True)
    go_lost(8)
    slam.feed(q_frames[0], block=True)
    for f in q_frames[1:1 + steady]:
        slam.feed(f)
    starts = [1 + chunk * i for i in range(n_chunks)]
    chunks = [np.stack(q_frames[i:i + chunk]) for i in starts]
    slam.feed_chunk(chunks[0])
    for c in chunks:
        slam.feed_chunk(c)
    slam.block()
    img = jnp.asarray(q_frames[0][: slam.crop_h, : slam.crop_w], jnp.float32)
    pyr = tuple(pyr_ops.build_pyramid(img, len(m.kf_pyr)))
    guess = jnp.asarray(kf_poses[8])
    by_lanes = {}
    for n in lanes:
        r = jax.jit(lambda mm, py, po, _l=n: reloc_mod.relocalize(
            mm, intr, py, po, level=4, max_kf=_l))(m, pyr, guess)
        by_lanes[n] = {k: np.asarray(v) for k, v in r._asdict().items()}
    return slam, slam.result(), by_lanes


def probe_setup(frames: int = PROBE_FRAMES):
    """``tools/capacity_probe.py:90-107``: scene, the preset-shaped config
    (100 slots), ground-truth poses and the uint8 frames (truncated, as the
    tool casts)."""
    scene, cfg = preset_setup()
    poses = scene.trajectory(frames, translation_amp=1.0)
    imgs = render_threads(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.uint8), poses)
    return scene, cfg, poses, imgs


def zurich_record(out_dir: str) -> str:
    """Write ``torch_zurich_record.npz``; returns its path."""
    import dataclasses
    import json
    import time

    import jax

    from sdvl_tpu.pipeline.stream import SdvlStream
    from sdvl_tpu_torch.tools.zurich_scale_smoke import images_sha256

    z = ZURICH
    t0 = time.perf_counter()
    intr, scene, m, kf_poses, imgs = jax_zurich_fill(
        z["kf_cap"], z["kf"], z["pts"], z["height"], z["width"],
        z["levels"])
    sha = images_sha256(imgs)
    del imgs
    print(f"zurich record: filled in {time.perf_counter() - t0:.1f} s")
    cfg = serve_config_jax(z["height"], z["width"], z["kf_cap"], z["pts"])
    q_frames = query_frames(scene, kf_poses)
    slam, rs, lanes = jax_zurich_serve(cfg, m, intr, kf_poses, q_frames)
    del slam
    print("zurich record: serving states", rs.states.tolist())
    print("zurich record: lanes", {k: int(v["kf"]) for k, v in lanes.items()})
    print(f"zurich record: served at {time.perf_counter() - t0:.1f} s")
    pose_noise, pt_noise = jax_zurich_draws(z["kf_cap"], z["pts"])
    _, m_ba, e0, e1, cg = jax_zurich_ba(intr, m, z["stage_iters"])
    print(f"zurich record: e0 {e0} e1 {e1} cg {cg} at "
          f"{time.perf_counter() - t0:.1f} s")
    assert e1 < 0.35 * e0, (e0, e1)

    _, pcfg, poses_gt, frames = probe_setup()
    probes = []
    for k, seed in [(k, 0) for k in PROBE_KS] + [(PROBE_KS[0], s)
                                                  for s in PROBE_SEEDS]:
        slam = SdvlStream(dataclasses.replace(pcfg, sdvl=dataclasses.replace(
            pcfg.sdvl, max_keyframes=k)), seed=seed)
        for i in range(0, len(frames), PROBE_CHUNK):
            slam.feed_chunk(np.ascontiguousarray(np.stack(
                frames[i:i + PROBE_CHUNK])))
        rp = slam.result()
        del slam
        probes.append(rp)
        at = f"K = {k}, seed {seed}"
        print(f"probe record, {at}: states", rp.states.tolist())
        print(f"probe record, {at}: keyframes",
              np.flatnonzero(rp.is_keyframe).tolist())
        print(f"probe record, {at}: matches", rp.n_matches.tolist())

    kn = z["kf"]
    path = os.path.join(out_dir, "torch_zurich_record.npz")
    np.savez_compressed(
        path,
        protocol=np.frombuffer(json.dumps(dict(
            z, lanes=ZURICH_LANES, probe_frames=PROBE_FRAMES,
            probe_chunk=PROBE_CHUNK, probe_ks=PROBE_KS,
            probe_seeds=PROBE_SEEDS)).encode(),
            dtype=np.uint8),
        kf_images_sha256=np.frombuffer(sha.encode(), dtype=np.uint8),
        pose_noise=pose_noise,
        pt_noise=pt_noise,
        reproj_px_before=np.float64(e0),
        reproj_px_after=np.float64(e1),
        ba_kf_pose=np.asarray(m_ba.kf_pose[:kn], np.float32),
        ba_pt_pos=np.asarray(m_ba.pt_pos, np.float32),
        ba_obs_mask=np.packbits(np.asarray(m_ba.obs_mask[:kn]), axis=1),
        ba_cg_iterations=np.asarray(cg, np.int32),
        serve_state=rs.states.astype(np.int8),
        serve_n_matches=rs.n_matches.astype(np.int16),
        serve_is_keyframe=rs.is_keyframe,
        serve_pose=rs.poses_raw.astype(np.float32),
        lane_budgets=np.asarray(ZURICH_LANES, np.int32),
        lane_kf=np.asarray([int(lanes[n]["kf"]) for n in ZURICH_LANES],
                           np.int32),
        lane_pose=np.stack([lanes[n]["pose"] for n in ZURICH_LANES]
                           ).astype(np.float32),
        lane_error=np.asarray([lanes[n]["error"] for n in ZURICH_LANES],
                              np.float32),
        probe_frames_sha256=np.frombuffer(frames_sha256(frames).encode(),
                                          dtype=np.uint8),
        probe_poses_gt=np.stack(poses_gt).astype(np.float32),
        probe_ks=np.asarray(PROBE_KS + (PROBE_KS[0],) * len(PROBE_SEEDS),
                            np.int32),
        probe_seeds=np.asarray((0,) * len(PROBE_KS) + PROBE_SEEDS, np.int32),
        probe_state=np.stack([r.states for r in probes]).astype(np.int8),
        probe_is_keyframe=np.stack([r.is_keyframe for r in probes]),
        probe_n_matches=np.stack([r.n_matches for r in probes]
                                 ).astype(np.int16),
        probe_pose=np.stack([r.poses_raw for r in probes]
                            ).astype(np.float32),
        probe_trajectory=np.stack([r.trajectory for r in probes]
                                  ).astype(np.float32),
        jax_version=np.frombuffer(jax.__version__.encode(), dtype=np.uint8),
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
    ap.add_argument("--zurich-record", action="store_true",
                    help="write torch_zurich_record.npz only")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.slam_record or args.long_record or args.zurich_record:
        os.makedirs(args.out, exist_ok=True)
        (slam_record if args.slam_record else long_record
         if args.long_record else zurich_record)(args.out)
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
