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

* ``torch_long_run_lanes_record.npz`` (also ``--long-record``) -- the same
  run with the relocalizer's lane budget below its keyframe slots
  (``LONG_LANES``, in the protocol's ``sdvl``), so that its LOST frames
  sweep the nearest lanes and then every slot; and the JAX version.
* ``torch_test_jax_runs.npz`` and ``torch_long_twin_record.npz``
  (``--test-runs``, which writes these two only) -- deterministic JAX runs
  that port tests hold the port against, recorded so that tier-1 does not
  compile and run them, each with the configuration the test checks and
  the JAX version: the capacity probe at 72 slots, the Zurich serving run
  at 256 slots, the device-resident step's sequence, the full-SLAM stream
  under both detection routes and through a distorted lens
  (``tests/test_torch_{capacity_probe,zurich_serve,graph_step,slam,
  distortion}.py``), the ``MultiStream`` runs, live and frozen, with the
  snapshot the frozen streams served
  (``tests/test_torch_multi_stream{,_frozen}.py``), the localizers with
  the snapshot they served (``tests/test_torch_localize.py``), the
  command-line program's two drivers (``tests/test_torch_cli_parity.py``),
  and the long run's CI twin with
  its map and carry before every chunk (``tests/test_torch_long_run.py``).

One mode writes no fixture: ``--long-spread SEED`` runs the JAX tool at
its defaults (K = 100, 13000 frames) under SEED into ``--out`` (the
reference's own spread at K = 100).

Run from the repository root (CPU is enough, a few minutes of XLA compile;
``--long-record`` about 5 minutes a seed and configuration,
``--zurich-record`` about 30 minutes on 8 cores, ``--long-spread`` about
two hours on 3 cores):

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --slam-record
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --long-record
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --zurich-record
    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py --test-runs
"""

from __future__ import annotations

import argparse
import contextlib
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


def frames_sha256(frames, dtype=np.uint8) -> str:
    """SHA-256 over the frames as ``dtype``, in order."""
    import hashlib

    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f, dtype).tobytes())
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
# the same run with a relocalizer lane budget below its keyframe slots, so
# that a LOST frame sweeps the nearest lanes first and every slot after
# reloc_escalate_after failed frames, as at every shipped config's K; the
# shipped escalation (8) leaves the first real frames after the blackout
# to the nearest lanes
LONG_LANES = dict(reloc_max_keyframes=4, reloc_escalate_after=8)


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


def long_record(out_dir: str, lanes: dict | None = None) -> str:
    """Write ``torch_long_run_record.npz``, or with ``lanes`` (the
    relocalizer's lane budget, ``LONG_LANES``)
    ``torch_long_run_lanes_record.npz``; returns its path."""
    import dataclasses
    import json

    import jax

    from tools.long_run import lawnmower_trajectory, run_protocol

    scene, cfg = long_setup()
    if lanes:
        cfg = dataclasses.replace(cfg, sdvl=dataclasses.replace(
            cfg.sdvl, **lanes))
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
    path = os.path.join(out_dir, "torch_long_run_lanes_record.npz" if lanes
                        else "torch_long_run_record.npz")
    extra = {"sdvl": lanes} if lanes else {}
    np.savez_compressed(
        path,
        frames_sha256=np.frombuffer(frames_sha256(frames).encode(),
                                    dtype=np.uint8),
        protocol=np.frombuffer(json.dumps(dict(
            kf=LONG_KF, points=160 * LONG_KF, frames=LONG_FRAMES,
            path=LONG_PATH, chunk=LONG_CHUNK, blackout_frac=frac,
            blackout_len=length, **extra)).encode(), dtype=np.uint8),
        seeds=np.asarray(LONG_SEEDS, np.int32),
        jax_state=np.stack([r.states for r, _ in runs]).astype(np.int8),
        jax_is_keyframe=np.stack([r.is_keyframe for r, _ in runs]),
        jax_n_matches=np.stack([r.n_matches for r, _ in runs]
                               ).astype(np.int16),
        jax_trajectory=np.stack([r.trajectory for r, _ in runs]
                                ).astype(np.float32),
        jax_stats=np.frombuffer(json.dumps([s for _, s in runs]).encode(),
                                dtype=np.uint8),
        jax_version=np.frombuffer(jax.__version__.encode(), dtype=np.uint8),
    )
    print(path, os.path.getsize(path) / 1e6, "MB")
    return path


def long_spread(out_dir: str, seed: int, kf: int = 100,
                n: int = 13000) -> str:
    """The JAX tool's ``main`` at its defaults (K = 100, 13000 frames) under
    ``seed``: writes ``long_spread_seed<seed>.npz`` (per-frame states,
    keyframe flags, match counts, trajectory, the tool's ``stats`` and the
    relocalizing frames by sweep) and returns its path."""
    import json

    import jax

    from sdvl_tpu_torch.tools.long_run import reloc_sweeps
    from tools.long_run import lawnmower_trajectory, run_protocol

    scene, cfg = long_setup(kf)
    poses = lawnmower_trajectory(n, k=12, legs=2)
    r, _, stats = run_protocol(cfg, scene, n, poses=poses, seed=seed)
    sweeps = reloc_sweeps(r.states, cfg.sdvl)
    print(f"long spread, seed {seed}:", json.dumps(stats),
          "all-slot sweeps:", sweeps["all_slots"])
    path = os.path.join(out_dir, f"long_spread_seed{seed}.npz")
    np.savez_compressed(
        path, seed=seed, state=r.states.astype(np.int8),
        is_keyframe=r.is_keyframe, n_matches=r.n_matches.astype(np.int16),
        trajectory=r.trajectory.astype(np.float32),
        stats=_blob(stats), sweeps=_blob(sweeps),
        jax_version=np.frombuffer(jax.__version__.encode(), dtype=np.uint8))
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


def jax_zurich_ba(intr, m, stage_iters, op_by_op: bool = False):
    """The Zurich tool's perturbation, reprojection error and global BA
    (``:122-168``) with the JAX package; with ``op_by_op`` the global BA
    alone is evaluated op by op (``jax.disable_jit``), the perturbation and
    the errors jitted as before. Returns (perturbed map, map after BA, e0,
    e1, the CG iterations of each LM step)."""
    import contextlib

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
        with jax.disable_jit() if op_by_op else contextlib.nullcontext():
            m_ba = jax.jit(lambda mm: mapper.global_ba(
                mm, intr, stage_iters=tuple(stage_iters)))(m_noisy)
            jax.block_until_ready(m_ba.kf_pose)
    finally:
        jax.lax.while_loop = while_loop
    e1 = float(reproj_err(m_ba))
    return m_noisy, m_ba, e0, e1, cg


def zurich_ba_spread(intr, m, kf: int, stage_iters) -> dict:
    """The Zurich tool's global BA (``jax_zurich_ba``) twice on the same
    filled map and draws, jitted (the recorded run) and op by op
    (``jax.disable_jit`` around the BA alone; the perturbation and the
    errors jitted in both, so nothing else changes between the two): the
    reference's own float32 spread after BA at this size. Returns the
    record's arrays: the jitted run's (``reproj_px_before``,
    ``reproj_px_after``, ``ba_kf_pose`` of the ``kf`` filled slots,
    ``ba_pt_pos``, the packed ``ba_obs_mask``, ``ba_cg_iterations``) and
    the op-by-op run's under ``ba_eager_``; prints the spread
    (``zurich_scale_smoke.spread_against``'s ``own``) and each run's
    seconds."""
    import json
    import time

    from sdvl_tpu_torch.tools.zurich_scale_smoke import spread_against

    out = {}
    for name, op_by_op in (("ba_", False), ("ba_eager_", True)):
        t0 = time.perf_counter()
        _, m_ba, e0, e1, cg = jax_zurich_ba(intr, m, stage_iters, op_by_op)
        print(f"zurich record: {name} e0 {e0} e1 {e1} cg {cg} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        assert e1 < 0.35 * e0, (e0, e1)
        if not op_by_op:
            out["reproj_px_before"] = np.float64(e0)
        out.update({
            ("reproj_px_after" if name == "ba_" else name
             + "reproj_px_after"): np.float64(e1),
            name + "kf_pose": np.asarray(m_ba.kf_pose[:kf], np.float32),
            name + "pt_pos": np.asarray(m_ba.pt_pos, np.float32),
            name + "obs_mask": np.packbits(np.asarray(m_ba.obs_mask[:kf]),
                                           axis=1),
            name + "cg_iterations": np.asarray(cg, np.int32)})
    got = spread_against(out["ba_eager_pt_pos"], out["ba_eager_kf_pose"],
                         out["ba_eager_obs_mask"], out)
    print("zurich record: the reference's own spread after BA",
          json.dumps(dict(got["own"], obs_apart=got["own_obs_apart"])),
          flush=True)
    return out


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
    pose_noise, pt_noise = jax_zurich_draws(z["kf_cap"], z["pts"])
    ba = zurich_ba_spread(intr, m, z["kf"], z["stage_iters"])
    print(f"zurich record: global BA twice at {time.perf_counter() - t0:.1f}"
          " s")
    cfg = serve_config_jax(z["height"], z["width"], z["kf_cap"], z["pts"])
    q_frames = query_frames(scene, kf_poses)
    slam, rs, lanes = jax_zurich_serve(cfg, m, intr, kf_poses, q_frames)
    del slam
    print("zurich record: serving states", rs.states.tolist())
    print("zurich record: lanes", {k: int(v["kf"]) for k, v in lanes.items()})
    print(f"zurich record: served at {time.perf_counter() - t0:.1f} s")

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
        **ba,
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


# configs/euroc.cfg end to end: the shipped file as loaded (752x480, its
# radial-tangential lens, 1000 keyframe slots, the plain detection route),
# PlaneScene frames rendered through that lens along its trajectory at this
# amplitude: the shipped knobs insert a keyframe once 30 % of the matches
# are lost (or 10 % after 30 frames), and the wide lens keeps the map in
# view longer than the tum_f1 sequence's; at 3.0 the JAX stream bootstraps
# on frame 1 and inserts keyframes at 15, 55 and 77 (at 1.0 none in 120
# frames, at 2.0 two in 85)
EUROC_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         os.pardir, "configs", "euroc.cfg")
EUROC_FRAMES = 85
EUROC_AMP = 3.0


def euroc_setup(n: int = EUROC_FRAMES, amp: float = EUROC_AMP):
    """(JAX config of ``configs/euroc.cfg``, ground-truth poses, uint8
    frames rendered through its lens, truncated as the smoke's
    ``write_cli_sequence`` casts)."""
    from sdvl_tpu.io.synthetic import PlaneScene
    from sdvl_tpu.pipeline.config import load_cfg

    cfg = load_cfg(EUROC_CFG)
    c = cfg.camera
    scene = PlaneScene(fx=c.fx, fy=c.fy, cx=c.u0, cy=c.v0, width=c.width,
                       height=c.height, plane_z=4.0, dist=c.dist)
    poses = scene.trajectory(n, translation_amp=amp)
    frames = render_threads(
        lambda p: np.clip(scene.render(p), 0, 255).astype(np.uint8), poses)
    return cfg, poses, frames


def jax_stream(cfg, frames, op_by_op=()):
    """The JAX SLAM stream over ``frames``, the frames in ``op_by_op``
    stepped op by op (``jax.disable_jit``: the step's branches as Python
    control flow, every op dispatched alone) and the others through the
    stream's jitted step: the same program and numbers under another
    float32 summation order. With the bootstrap frame (the SECOND frame
    that seeds the map: homography, triangulation, ground-plane alignment)
    in ``op_by_op`` it is the reference's own witness for the world's yaw,
    as ``tests/test_torch_cli_witness.py`` evaluates the host driver's
    bootstrap. Returns the stream, with the keyframe policy's inputs after
    each frame (the carry's ``kf_matches`` and ``frames_since_kf``) as
    ``kf_policy``, (frames, 2)."""
    import jax

    from sdvl_tpu.pipeline.device_fsm import make_step
    from sdvl_tpu.pipeline.stream import SdvlStream

    js = SdvlStream(cfg, seed=0, donate=False)
    eager = make_step(cfg, js._undistort)
    policy = []
    for i, f in enumerate(frames):
        if i in op_by_op:
            with jax.disable_jit():
                js.m, js.carry, info = eager(js.m, js.carry, js._prep(f),
                                             js._grid)
            js._infos.append((False, info))
        else:
            js.feed(f)
        policy.append((int(js.carry.kf_matches),
                       int(js.carry.frames_since_kf)))
    js.kf_policy = np.asarray(policy, np.int32)
    return js


def bootstrap_frame(r) -> int:
    """The frame whose step seeded the map (its keyframe flag is the
    stream's first)."""
    return int(np.argmax(r.is_keyframe))


# the fields of a map that global BA reads (mapper.extract_global_ba), kept
# for the keyframe slots a stream filled
BA_MAP_FIELDS = ("kf_pose", "kf_valid", "kf_frame_id", "obs_mask", "obs_px")
BA_PT_FIELDS = ("pt_pos", "pt_valid")


def euroc_record(out_dir: str) -> str:
    """Write ``torch_euroc_record.npz``; returns its path."""
    import time

    import jax

    from sdvl_tpu.pipeline import mapper
    from sdvl_tpu.pipeline.config import intrinsics

    t0 = time.perf_counter()
    cfg, poses_gt, frames = euroc_setup()
    runs = {}
    for name in ("jax", "witness"):
        js = jax_stream(cfg, frames, op_by_op=(
            (bootstrap_frame(runs["jax"][1]),) if runs else ()))
        r = js.result()
        runs[name] = (js, r)
        print(f"euroc record, {name}: states", r.states.tolist())
        print(f"euroc record, {name}: keyframes",
              np.flatnonzero(r.is_keyframe).tolist())
        print(f"euroc record, {name}: matches", r.n_matches.tolist(),
              f"at {time.perf_counter() - t0:.1f} s", flush=True)
    slam, r = runs["jax"]
    w = runs["witness"][1]
    assert (r.states == 2)[3:].all(), "not RUNNING after the bootstrap"
    assert r.is_keyframe.sum() >= 4, "fewer than 3 keyframes after the " \
                                     "bootstrap"
    np.testing.assert_array_equal(w.states, r.states)

    key = slam.carry.key
    s = cfg.sdvl
    n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
    n_lanes = int(slam.carry.last_idx.shape[0])
    n_corners = int(slam.carry.c1_xy.shape[0])
    before = np.concatenate([[0], r.states[:-1]])
    pose_frames = np.nonzero(before >= 2)[0].astype(np.int32)
    pose_noise = np.stack([ransac_gumbel(key, int(i), n_hyp, n_lanes)
                           for i in pose_frames])
    world_tf = np.asarray(np.concatenate(
        [i.world_tf[None] for _, i in slam._infos]))

    # global BA over the final map at its 1000 slots (PCG), as the CLI
    # runs it, jitted and op by op
    m = slam.m
    n_slots = int(np.flatnonzero(np.asarray(m.kf_valid)).max()) + 1
    intr = intrinsics(cfg)
    ba = {}
    for name, op_by_op in (("ba_", False), ("ba_eager_", True)):
        t1 = time.perf_counter()
        with jax.disable_jit() if op_by_op else contextlib.nullcontext():
            m_ba = jax.jit(lambda mm: mapper.global_ba(mm, intr))(m)
            jax.block_until_ready(m_ba.kf_pose)
        print(f"euroc record: global BA {name} in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        ba.update({name + "kf_pose": np.asarray(m_ba.kf_pose[:n_slots]),
                   name + "pt_pos": np.asarray(m_ba.pt_pos),
                   name + "obs_mask": np.packbits(np.asarray(
                       m_ba.obs_mask[:n_slots]), axis=1)})

    path = os.path.join(out_dir, "torch_euroc_record.npz")
    with open(EUROC_CFG) as f:
        cfg_text = f.read()
    np.savez_compressed(
        path,
        protocol=_blob(dict(cfg=cfg_text, frames=EUROC_FRAMES,
                            translation_amp=EUROC_AMP, plane_z=4.0)),
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
        jax_is_keyframe=r.is_keyframe,
        jax_n_corners=r.n_corners.astype(np.int32),
        jax_kf_policy=slam.kf_policy,
        jax_n_keyframes=np.asarray(m.n_keyframes, np.int32),
        jax_kf_frame_id=np.asarray(m.kf_frame_id, np.int32),
        jax_n_points=np.asarray(np.sum(np.asarray(m.pt_valid)), np.int32),
        witness_trajectory=w.trajectory.astype(np.float32),
        witness_n_matches=w.n_matches.astype(np.int32),
        witness_is_keyframe=w.is_keyframe,
        **{"map_" + k: np.asarray(getattr(m, k))[:n_slots]
           for k in BA_MAP_FIELDS},
        **{"map_" + k: np.asarray(getattr(m, k)) for k in BA_PT_FIELDS},
        **ba,
        jax_version=np.frombuffer(jax.__version__.encode(), dtype=np.uint8),
    )
    print(path, os.path.getsize(path) / 1e6, "MB")
    return path


TEST_RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "torch_test_jax_runs.npz")


def _blob(obj) -> np.ndarray:
    import json

    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def unblob(arr):
    """A JSON object stored by ``_blob``."""
    import json

    return json.loads(bytes(arr).decode())


def probe_test_run() -> dict:
    """The JAX tool's ``probe_one`` at the capacity-probe test's 72 slots
    (``tests/test_torch_capacity_probe.py``): its record, the stream's
    per-frame result and PRNG key."""
    import dataclasses

    import test_torch_capacity_probe as T
    from sdvl_tpu.pipeline import stream as j_stream
    from tools import capacity_probe as jp

    cfg_j, frames, _ = T.jax_setup()
    streams = []
    feed = j_stream.SdvlStream.feed_chunk

    def kept(self, imgs, block=False):
        streams.append(self)
        return feed(self, imgs, block)

    j_stream.SdvlStream.feed_chunk = kept
    try:
        out_j = jp.probe_one(T.KS[1], frames, cfg_j)
    finally:
        j_stream.SdvlStream.feed_chunk = feed
    js = streams[-1]
    r = js.result()
    return {"probe.protocol": _blob(dict(
                cfg=dataclasses.asdict(cfg_j), k=T.KS[1],
                frames_sha256=frames_sha256(frames))),
            "probe.out": _blob(out_j),
            "probe.key": np.asarray(js.carry.key),
            "probe.state": r.states.astype(np.int8),
            "probe.is_keyframe": r.is_keyframe,
            "probe.n_matches": r.n_matches.astype(np.int16),
            "probe.trajectory": r.trajectory.astype(np.float32)}


def serve_test_run() -> dict:
    """The JAX tool's serving phase at the Zurich serving test's size
    (``tests/test_torch_zurich_serve.py``): the stream's per-frame result
    and PRNG key, and each lane budget's relocalizer result."""
    import dataclasses

    import test_torch_zurich_serve as T

    intr_j, scene_j, mj, kf_poses, _ = jax_zurich_fill(
        T.KF_CAP, T.KF, T.PTS, T.H, T.W, 5)
    q = T.serve_frames(scene_j, kf_poses)
    cfg_j = serve_config_jax(T.H, T.W, T.KF_CAP, T.PTS)
    js, r, lanes = jax_zurich_serve(cfg_j, mj, intr_j, kf_poses, q,
                                    lanes=T.LANES, **T.PHASE)
    out = {"serve.protocol": _blob(dict(
               cfg=dataclasses.asdict(cfg_j), lanes=list(T.LANES),
               phase=T.PHASE, frames_sha256=frames_sha256(q))),
           "serve.key": np.asarray(js.carry.key),
           "serve.state": r.states.astype(np.int8),
           "serve.is_keyframe": r.is_keyframe,
           "serve.n_matches": r.n_matches.astype(np.int16),
           "serve.poses_raw": r.poses_raw.astype(np.float32)}
    for n, rl in lanes.items():
        for k, v in rl.items():
            out[f"serve.lanes{n}.{k}"] = v
    return out


def step_test_run() -> dict:
    """The JAX stream over the device-resident step's test sequence
    (``tests/test_torch_graph_step.py``, ``graph_step_scene``): its
    per-frame result and PRNG key."""
    import dataclasses

    from sdvl_tpu.pipeline.stream import SdvlStream
    from torch_port_helpers import graph_step_scene, jax_config

    cfg_t, frames = graph_step_scene()
    cfg = jax_config(cfg_t)
    js = SdvlStream(cfg, seed=0, donate=False)
    for f in frames:
        js.feed(f)
    r = js.result()
    return {"step.protocol": _blob(dict(
                cfg=dataclasses.asdict(cfg),
                frames_sha256=frames_sha256(frames))),
            "step.key": np.asarray(js.carry.key),
            "step.state": r.states.astype(np.int8),
            "step.is_keyframe": r.is_keyframe,
            "step.quality": r.quality.astype(np.int8),
            "step.n_matches": r.n_matches.astype(np.int32),
            "step.trajectory": r.trajectory.astype(np.float32)}


def slam_stream_run(prefix: str, cfg, frames, route: str) -> dict:
    """The JAX SLAM stream over ``frames`` with ``cfg`` set to the
    detection ``route`` (``with_route``, ``detect_route``), as
    ``torch_port_helpers.slam_pair`` runs it: its per-frame result, final
    map counters and PRNG key, under ``prefix``."""
    import dataclasses

    from sdvl_tpu.pipeline.stream import SdvlStream
    from torch_port_helpers import detect_route, with_route

    cfg = with_route(cfg, route)
    with detect_route(route):
        js = SdvlStream(cfg, seed=0, donate=False)
        for f in frames:
            js.feed(f)
        r = js.result()
    p = prefix + "."
    return {
        p + "protocol": _blob(dict(
            cfg=dataclasses.asdict(cfg),
            frames_sha256=frames_sha256(frames, np.float32))),
        p + "key": np.asarray(js.carry.key),
        **{p + k: np.asarray(getattr(r, k)) for k in (
            "states", "is_keyframe", "n_corners", "quality", "n_matches",
            "n_attempts", "trajectory", "poses_raw", "median_shift")},
        **{p + "m." + k: np.asarray(getattr(js.m, k)) for k in (
            "n_keyframes", "kf_valid", "kf_frame_id", "pt_valid")}}


def slam_test_runs() -> dict:
    """The JAX SLAM streams of ``tests/test_torch_slam.py`` (``small_scene``
    under each detection route) and ``tests/test_torch_distortion.py``
    (through its distorted lens)."""
    import test_torch_distortion as D
    import test_torch_slam as T
    from torch_port_helpers import small_scene

    cfg_j, _, frames, _ = small_scene(T.N_FRAMES)
    cfg_d, _, frames_d, _ = D.setup()
    return {**slam_stream_run("slam_plain", cfg_j, frames, "plain"),
            **slam_stream_run("slam_pallas", cfg_j, frames, "pallas"),
            **slam_stream_run("distorted", cfg_d, frames_d, "pallas")}


def euroc_test_runs() -> dict:
    """The JAX SLAM streams of ``tests/test_torch_euroc.py``'s small case
    (``configs/euroc.cfg``'s lens at half its size, plain route): as
    compiled (``euroc``), and with the bootstrap frame stepped op by op
    (``euroc_witness``, ``jax_stream``: the reference's own world yaw)."""
    import dataclasses

    import test_torch_euroc as E

    cfg_j, _, frames, _ = E.setup()
    out = slam_stream_run("euroc", cfg_j, frames, "plain")
    w = jax_stream(cfg_j, frames, op_by_op=(bootstrap_frame(as_result(
        {k[len("euroc."):]: v for k, v in out.items()})),))
    r = w.result()
    out.update({
        "euroc_witness.protocol": _blob(dict(
            cfg=dataclasses.asdict(cfg_j),
            frames_sha256=frames_sha256(frames, np.float32))),
        **{"euroc_witness." + k: np.asarray(getattr(r, k)) for k in (
            "states", "is_keyframe", "n_matches", "trajectory")}})
    return out


def _infos(name: str, infos) -> dict:
    """A JAX ``FrameInfo`` (its leaves stacked, where a list of them) as
    arrays under ``name``."""
    if isinstance(infos, list):
        infos = type(infos[0])(*(np.stack([np.asarray(x) for x in xs])
                                 for xs in zip(*infos)))
    return {f"{name}.{k}": np.asarray(v) for k, v in infos._asdict().items()}


def recorded_infos(rec: dict, name: str):
    """The JAX ``FrameInfo`` stored under ``name`` in a record of
    ``recorded_run`` (numpy leaves)."""
    from sdvl_tpu.pipeline.device_fsm import FrameInfo

    return FrameInfo(**{k: rec[f"{name}.{k}"] for k in FrameInfo._fields})


def _snapshot(name: str, path: str) -> dict:
    """The arrays of the snapshot file ``path`` under ``name``."""
    with np.load(path) as z:
        return {f"{name}.{k}": z[k] for k in z.files}


def multi_stream_test_runs() -> dict:
    """The JAX ``MultiStream`` runs of ``tests/test_torch_multi_stream.py``
    (2 streams fed the 18 batches one by one; 6 of them, then a chunk of 6)
    and ``tests/test_torch_multi_stream_frozen.py`` (4 streams serving the
    port's lone stream's snapshot, stored with them: the query as one
    chunk, and its first frame as one feed): every ``FrameInfo`` they
    returned."""
    import tempfile

    import test_torch_multi_stream as T
    import test_torch_multi_stream_frozen as F
    from sdvl_tpu.dist.mesh import make_mesh
    from sdvl_tpu.dist.multi_stream import MultiStream
    from sdvl_tpu_torch.io.snapshot import save_stream_snapshot

    cfg_j, cfg_t = T._configs()
    _, batches = T.scene_batches()

    def multi(n, seed, **kw):
        return MultiStream(cfg_j, make_mesh(n, axis="stream"), n_streams=n,
                           seed=seed, **kw)

    jm = multi(2, 0)
    infos = [jm.feed(b) for b in batches]
    jc = multi(2, 0)
    for b in batches[:6]:
        jc.feed(b)
    out = {"multi.protocol": _blob(T.jax_protocol(cfg_j, batches)),
           **_infos("multi.infos", infos),
           **_infos("multi.chunk", jc.feed_chunk(np.stack(batches[6:12])))}

    frames, _ = F.scene_frames()
    query = np.stack(frames[F.QUERY])
    batch = np.repeat(query[:, None], 4, axis=1)
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "lane0.npz")
        save_stream_snapshot(F.lone_stream(cfg_t, frames), snap)
        out.update(_snapshot("frozen.snap", snap))
        out.update(_infos("frozen.chunk",
                          multi(4, 7, frozen_map=snap).feed_chunk(batch)))
        out.update(_infos("frozen.feed",
                          multi(4, 7, frozen_map=snap).feed(batch[0])))
    out["frozen.protocol"] = _blob(F.jax_protocol(cfg_j, query))
    return out


def localize_test_runs() -> dict:
    """The JAX runs of ``tests/test_torch_localize.py``: the SLAM stream's
    snapshot, and each localizer's key, first frame id, pose-RANSAC lanes
    and ``FrameInfo``s (``plain``, ``fused``, ``chunk``, ``escalation``)."""
    import tempfile

    import test_torch_localize as L
    from sdvl_tpu.io.snapshot import save_stream_snapshot
    from torch_port_helpers import mapped_stream

    cfg_j, _, frames, _, slam = mapped_stream(L.N_MAP)
    assert slam.result().state_name() == "RUNNING"
    query = frames[L.QUERY]
    runs = {"plain": (query, {}), "fused": (query, dict(fused=True)),
            "chunk": (query, dict(chunk=True)),
            "escalation": (L.escalation_query(frames), L.ESCALATION)}
    out = {"localize.protocol": _blob(L.jax_protocol(cfg_j, frames))}
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "map.npz")
        save_stream_snapshot(slam, snap)
        out.update(_snapshot("localize.snap", snap))
        for name, (q, kw) in runs.items():
            key, fid0, n_lanes, infos = L.jax_serve(cfg_j, snap, q, **kw)
            p = f"localize.{name}"
            out.update({f"{p}.key": key, f"{p}.fid0": np.int64(fid0),
                        f"{p}.n_lanes": np.int64(n_lanes)})
            out.update(_infos(p, infos))
    return out


def cli_test_runs() -> dict:
    """The JAX program's runs of ``tests/test_torch_cli_parity.py`` (the
    stream and the host driver): standard output's lines, the TUM file and
    the ``--viz`` folder's file names."""
    import pathlib
    import tempfile

    import test_torch_cli as C
    import test_torch_cli_parity as P

    out = {}
    with tempfile.TemporaryDirectory() as d:
        (pathlib.Path(d) / "seq").mkdir()
        seq = C.write_seq(pathlib.Path(d) / "seq")
        for driver in ("stream", "host"):
            tmp = pathlib.Path(d) / driver
            tmp.mkdir()
            lines, tum, viz = P.jax_cli(seq, driver, tmp)
            p = f"cli_{driver}."
            out.update({p + "protocol": _blob(P.jax_protocol(seq, driver)),
                        p + "lines": _blob(lines), p + "tum": tum,
                        p + "viz": _blob(viz)})
    return out


def record_test_runs(path: str = TEST_RUNS) -> str:
    """Write ``torch_test_jax_runs.npz``: the JAX runs that port tests hold
    the port against (``probe_test_run``, ``serve_test_run``,
    ``step_test_run``, ``slam_test_runs``, ``multi_stream_test_runs``,
    ``localize_test_runs``, ``cli_test_runs``, ``euroc_test_runs``),
    recorded so that tier-1 does not compile and run them; returns its
    path."""
    import jax

    np.savez_compressed(path, jax_version=np.frombuffer(
        jax.__version__.encode(), dtype=np.uint8),
        **probe_test_run(), **serve_test_run(), **step_test_run(),
        **slam_test_runs(), **multi_stream_test_runs(),
        **localize_test_runs(), **cli_test_runs(), **euroc_test_runs())
    print(path, os.path.getsize(path) / 1e6, "MB")
    return path


# the records' JSON objects (``_blob``)
JSON_NAMES = ("protocol", "out", "lines", "viz")


def recorded_run(prefix: str, protocol: dict) -> dict:
    """The record of ``record_test_runs`` under ``prefix`` (``probe``,
    ``serve``, ``step``, ``slam_plain``, ``slam_pallas``, ``distorted``,
    ``multi``, ``frozen``, ``localize``, ``cli_stream``, ``cli_host``,
    ``euroc``, ``euroc_witness``): its arrays by name (``m.`` for the final map's, ``snap.`` for a
    snapshot file's), JSON objects decoded.
    Raises when
    the recorded ``protocol`` (the configuration and frames' hash the test
    gives) is not ``protocol``: the record is stale."""
    import json

    z = np.load(TEST_RUNS)
    out = {"jax_version": bytes(z["jax_version"]).decode()}
    for k in z.files:
        if k.startswith(prefix + "."):
            name = k[len(prefix) + 1:]
            out[name] = (unblob(z[k]) if name in JSON_NAMES else z[k])
    if out["protocol"] != json.loads(json.dumps(protocol)):
        raise AssertionError(f"stale record {prefix!r} in {TEST_RUNS}: "
                             "tests/make_torch_fixtures.py --test-runs")
    return out


def as_result(rec: dict):
    """A recorded run's per-frame arrays as a JAX ``SlamResult`` shows them
    (``states``, ``n_frames``, ``state_name()``, the fields by name)."""
    import types

    r = types.SimpleNamespace(**rec)
    r.states = rec["state"] if "state" in rec else rec["states"]
    r.n_frames = len(r.states)
    r.state_name = lambda i=-1: ("FIRST", "SECOND", "RUNNING",
                                 "LOST")[int(r.states[i])]
    return r


LONG_TWIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "torch_long_twin_record.npz")


def record_long_twin(path: str = LONG_TWIN) -> str:
    """Write ``torch_long_twin_record.npz``: the JAX tool's ``run_protocol``
    at ``tests/test_torch_long_run.py``'s scale, its map and carry kept
    before every chunk and after the last, its per-frame result, ``stats``
    and PRNG key. Equal arrays are stored once, a keyframe pyramid slot by
    slot, and a float pyramid level holding only integers 0..255 as uint8
    (both exact). Returns the path."""
    import dataclasses
    import hashlib

    import jax

    import test_torch_long_run as T
    from sdvl_tpu.io.synthetic import PlaneScene
    from sdvl_tpu.pipeline import stream as j_stream
    from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig
    from tools import long_run as j_long

    cfg = Config(camera=CameraConfig(**T.CAM), sdvl=SdvlConfig(**T.SDVL))
    states, streams = [], []
    feed = j_stream.SdvlStream.feed_chunk

    def host(tree):
        from torch_port_helpers import tree_to_numpy

        return {k: tuple(np.array(x) for x in v) if isinstance(v, tuple)
                else np.array(v) for k, v in tree_to_numpy(tree).items()}

    def kept(self, imgs, block=False):
        streams.append(self)
        states.append((host(self.m), host(self.carry)))
        return feed(self, imgs, block)

    j_stream.SdvlStream.feed_chunk = kept
    try:
        r, _, stats = j_long.run_protocol(cfg, PlaneScene(**T.SCENE),
                                          **T.PROTOCOL)
    finally:
        j_stream.SdvlStream.feed_chunk = feed
    js = streams[-1]
    states.append((host(js.m), host(js.carry)))

    blobs, index, out = {}, {}, {}

    def put(arr) -> str:
        if (arr.dtype == np.float32 and arr.size and np.all(arr == np.round(
                arr)) and arr.min() >= 0 and arr.max() <= 255
                and not np.signbit(arr).any()):
            arr, kind = arr.astype(np.uint8), "u8f"
        else:
            kind = "raw"
        h = hashlib.sha256(arr.tobytes() + str(arr.shape).encode()
                           + str(arr.dtype).encode()).hexdigest()[:16]
        if h not in index:
            index[h] = f"b{len(index)}"
            blobs[index[h]] = arr
        return f"{index[h]}:{kind}"

    table = []
    for m, c in states:
        row = {}
        for pre, tree in (("m", m), ("c", c)):
            for k, v in tree.items():
                if pre == "m" and k == "kf_pyr":    # slot by slot
                    row[f"m.{k}"] = [[put(lvl[i]) for i in range(len(lvl))]
                                     for lvl in v]
                elif isinstance(v, tuple):
                    row[f"{pre}.{k}"] = [put(x) for x in v]
                else:
                    row[f"{pre}.{k}"] = put(v)
        table.append(row)
    out.update({f"blob.{k}": v for k, v in blobs.items()})
    np.savez_compressed(
        path, table=_blob(table), key=np.asarray(js.carry.key),
        protocol=_blob(dict(cfg=dataclasses.asdict(cfg), scene=T.SCENE,
                            protocol=T.PROTOCOL)),
        stats=_blob(stats), state=r.states.astype(np.int8),
        n_corners=r.n_corners.astype(np.int32), is_keyframe=r.is_keyframe,
        n_matches=r.n_matches.astype(np.int32),
        poses_raw=r.poses_raw.astype(np.float32),
        trajectory=r.trajectory.astype(np.float32),
        jax_version=np.frombuffer(jax.__version__.encode(), dtype=np.uint8),
        **out)
    print(path, os.path.getsize(path) / 1e6, "MB")
    return path


def recorded_long_twin(protocol: dict, path: str = LONG_TWIN) -> dict:
    """``record_long_twin``'s record: ``states`` (a (map, carry) pair of
    dicts of numpy arrays per chunk, and one after the last), the per-frame
    arrays, ``stats``, ``key``, ``jax_version``. Raises when the recorded
    protocol (configuration, scene, protocol) is not ``protocol``."""
    import json

    z = np.load(path)
    if unblob(z["protocol"]) != json.loads(json.dumps(protocol)):
        raise AssertionError(f"stale record {path}: "
                             "tests/make_torch_fixtures.py --test-runs")

    def get(ref):
        name, kind = ref.split(":")
        arr = z[f"blob.{name}"]
        return arr.astype(np.float32) if kind == "u8f" else arr

    states = []
    for row in unblob(z["table"]):
        trees = ({}, {})
        for key, ref in row.items():
            pre, k = key.split(".", 1)
            tree = trees[pre == "c"]
            if pre == "m" and k == "kf_pyr":
                tree[k] = tuple(np.stack([get(x) for x in lvl])
                                for lvl in ref)
            elif isinstance(ref, list):
                tree[k] = tuple(get(x) for x in ref)
            else:
                tree[k] = get(ref)
        states.append(trees)
    out = {k: z[k] for k in ("key", "state", "n_corners", "is_keyframe",
                             "n_matches", "poses_raw", "trajectory")}
    out.update(states=states, stats=unblob(z["stats"]),
               jax_version=bytes(z["jax_version"]).decode())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data"))
    ap.add_argument("--slam-record", action="store_true",
                    help="write torch_slam_record.npz only")
    ap.add_argument("--long-record", action="store_true",
                    help="write torch_long_run_record.npz and "
                         "torch_long_run_lanes_record.npz only")
    ap.add_argument("--zurich-record", action="store_true",
                    help="write torch_zurich_record.npz only")
    ap.add_argument("--euroc-record", action="store_true",
                    help="write torch_euroc_record.npz only")
    ap.add_argument("--test-runs", action="store_true",
                    help="write torch_test_jax_runs.npz and "
                         "torch_long_twin_record.npz only")
    ap.add_argument("--long-spread", type=int, default=None, metavar="SEED",
                    help="run the JAX long-run tool at its defaults under "
                         "SEED into --out (not a fixture: the reference's "
                         "spread at K = 100)")
    args = ap.parse_args(argv)
    if args.test_runs:      # the tests' 8-device CPU mesh (tests/conftest.py)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
            " --xla_force_host_platform_device_count=8")).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.test_runs:
        record_test_runs()
        record_long_twin()
        return
    if args.long_spread is not None:
        os.makedirs(args.out, exist_ok=True)
        long_spread(args.out, args.long_spread)
        return
    if (args.slam_record or args.long_record or args.zurich_record
            or args.euroc_record):
        os.makedirs(args.out, exist_ok=True)
        if args.long_record:
            long_record(args.out)
            long_record(args.out, LONG_LANES)
        elif args.euroc_record:
            euroc_record(args.out)
        else:
            (slam_record if args.slam_record else zurich_record)(args.out)
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
