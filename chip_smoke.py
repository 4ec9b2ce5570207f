#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: full SLAM mode and serving, on one card.

Run from the repository root on a machine with one NVIDIA GPU, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

What it does, each phase printing its own lines and any failure ending the
run with a non-zero exit code:

1. device  -- requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` gives them, and the torch/CUDA versions.
2. build   -- compiles ``sdvl_tpu_torch/csrc/detect.cu`` with ``nvcc`` for
   ``sm_90a`` and loads it.
3. kernel  -- holds the detection kernel (score maps and per-cell winners of
   all levels in one launch) against its plain torch version on the card:
   the three detection levels of the first query frame in one launch (at
   cell 32, then 16 and 64), each level alone, a small 64x96 level and a
   ragged 123x171 one (scalar staging). Maps must have equal finite masks
   and scores to rounding, cell winners must be equal. It times, with CUDA
   events, the device time of one launch (many launches replayed from a
   CUDA graph), one eager call of the launch and of the wrapper with its
   cell decode, the plain version, and one eager ``detect_pyramid`` call on
   the first query frame, plain route against fused.
4. slam    -- ``SdvlStream`` in full SLAM mode at the tum_f1 preset shape
   (640x480, 5 levels, ORB gate, 1000 features, 200 match lanes, 100
   keyframe / 4096 point / 512 candidate slots, fused detection) from an
   empty map over the 40 ``PlaneScene`` frames, rendered here with
   ``sdvl_tpu_torch.io.synthetic`` and checked against the SHA-256 stored
   in ``tests/data/torch_slam_record.npz``, fed the JAX run's random draws
   from that file. Three runs: cold, warm (timed per frame, kernel launches
   counted) and one counting synchronisations. Each is held against the
   recorded JAX run: bootstrap frame, states and keyframe flags equal,
   ``n_matches`` within 2 on at most 15 % of RUNNING frames, camera
   centres within 1 % of the trajectory extent, Sim(3)-aligned ATE under
   3 % of the extent, keyframe count within 1. The preset run makes no
   keyframe after the bootstrap in 40 frames, so the warm and counting
   runs go on over 45 more frames of the same trajectory (pose noise from
   a seeded NumPy generator), which insert keyframes: RUNNING throughout,
   ATE under 3 %. Then the port's own map is saved with
   ``save_stream_snapshot`` and served by ``SdvlStream.localizer`` on
   ``frames[8:32]``: RUNNING within 5 frames and on the last 5, ATE under
   5 %.
5. slice   -- ``SdvlStream.localizer`` at the tum_f1 preset shape (640x480,
   5 levels, ORB gate, 200 match lanes, 100 keyframe / 4096 point slots) on
   the committed map snapshot, the 24 committed query frames through
   ``feed_chunk`` with the recorded RANSAC noise, ``result()``; checks
   relocalization, tracking, accuracy against ground truth, that the map is
   untouched and that every frame launched the kernel exactly once.
6. prints one JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``. The kernel's ``launches``, ``frames``
   and ``frames_per_s`` are the slam phase's warm run; ``launches_by_path``
   and ``frames_by_path`` give each path's count beside its frames.

It imports the port (``sdvl_tpu_torch``) only: no JAX, nothing of
``sdvl_tpu``. The fixtures under ``tests/data/`` are made by
``tests/make_torch_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MAP_NPZ = os.path.join(ROOT, "tests", "data", "torch_localize_map.npz")
QUERY_NPZ = os.path.join(ROOT, "tests", "data", "torch_localize_query.npz")
SLAM_NPZ = os.path.join(ROOT, "tests", "data", "torch_slam_record.npz")

FAST_T, ST_T = 10.0, 50.0

# Peaks of one H100 SXM (NVIDIA data sheet): HBM3 3.35 TB/s, 67 TFLOP/s
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Float operations per pixel of the score map, counted for the cheapest
# formulation: FAST 2 adds + 32 compares; Sobel 2 + 8; 3 products; separable
# 4x4 box sums 3 x 6; min-eigenvalue 11; threshold 1.
OPS_PER_PIXEL = 34 + 10 + 3 + 18 + 11 + 1


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def preset_config(localize_only: bool = True):
    """The tum_f1 preset shape, fused detection on."""
    from sdvl_tpu_torch.pipeline.config import (CameraConfig, Config,
                                                SdvlConfig)

    sdvl = SdvlConfig(
        use_orb=True, num_features=1000, max_matches=200, max_keyframes=100,
        max_points=4096, max_candidates=512, fast_threshold=10.0,
        cell_size=32, pyramid_levels=5, max_fast_levels=3,
        min_avg_shift=10.0, min_keyframe_its=15, min_init_corners=40,
        map_scale=4.0, localize_only=localize_only, use_fused_detect=True,
    )
    return Config(
        camera=CameraConfig(width=640, height=480, fx=517.3, fy=516.5,
                            u0=318.6, v0=255.3, dist=(0, 0, 0, 0, 0)),
        sdvl=sdvl,
    )


def blocky_image(seed: int, shape) -> np.ndarray:
    """Noise plus bright rectangles: plenty of real corners."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 50, shape).astype(np.float32)
    for _ in range(40):
        y = rng.integers(4, shape[0] - 16)
        x = rng.integers(4, shape[1] - 16)
        img[y:y + rng.integers(4, 12), x:x + rng.integers(4, 12)] += \
            rng.uniform(60, 150)
    return np.clip(img, 0, 255)


def time_ms(fn, reps: int = 30, warm: int = 5, inner: int = 20) -> float:
    """Time of one ``fn()`` in ms as the stream sees it: CUDA events around
    ``inner`` back-to-back calls, over ``inner``, median of ``reps`` after
    warm-up. It includes what the host needs to issue a call whenever that
    is longer than the device work. The input stays in L2 between calls, as
    it does in the stream, where the pyramid level was written just before
    it is read."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, launches: int = 200, reps: int = 10) -> float:
    """Device time of one ``fn()`` in ms with the host out of the way:
    ``launches`` calls captured into one CUDA graph, the replay timed with
    CUDA events, median of ``reps``, over ``launches``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def check_map(name: str, got: torch.Tensor, want: torch.Tensor):
    """One level's kernel map against the plain map; raises on
    disagreement. Returns (corners, mask mismatches, max abs error)."""
    H, W = want.shape
    assert got.shape == want.shape == (H, W) and got.dtype == torch.float32
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    # border: all -inf
    inner = torch.zeros_like(fg)
    inner[4:H - 4, 4:W - 4] = True
    assert not bool((fg & ~inner).any()), f"{name}: finite score in border"
    assert bool(((got == float("-inf")) | fg).all()), f"{name}: nan in map"
    # finite masks equal, except where the score sits on the threshold
    diff = fg != fw
    n_diff = int(diff.sum())
    if n_diff:
        v = torch.where(fg, got, want)[diff]
        near = (v - ST_T).abs() <= 1e-3 * ST_T
        assert bool(near.all()), (
            f"{name}: {int((~near).sum())} mask mismatches away from the "
            f"score threshold")
    both = fg & fw
    n_both = int(both.sum())
    assert n_both > 0, f"{name}: no corner found, the check is empty"
    err = (got[both] - want[both]).abs()
    tol = 1e-2 + 1e-4 * want[both].abs()   # summation order may differ
    assert bool((err <= tol).all()), (
        f"{name}: score error {float(err.max())} beyond rtol 1e-4 atol 1e-2")
    return n_both, n_diff, float(err.max())


def check_launch(name: str, levels, cell: int = 32, timed: bool = True) -> dict:
    """One launch of the kernel over ``levels`` against the plain version
    (per-level plain map plus ``grid_best``): maps as in ``check_map``, cell
    winners (position, validity, level) exactly equal, scores to rounding.
    With ``timed``, also the times of the launch, of the wrapper and of the
    plain version, and the bound. Raises on disagreement."""
    from sdvl_tpu_torch.ops.cuda import detect

    shapes = [list(l.shape) for l in levels]
    got = detect.fast_shi_tomasi_cells(levels, cell, FAST_T, ST_T)
    torch.cuda.synchronize()
    want = detect.fast_shi_tomasi_cells_plain(levels, cell, FAST_T, ST_T)
    n_both = n_diff = 0
    max_err = 0.0
    for l, (g, w) in enumerate(zip(got[0], want[0])):
        c, d, e = check_map(f"{name} level {l}", g, w)
        n_both, n_diff, max_err = n_both + c, n_diff + d, max(max_err, e)
    _, xy, score, valid, level = got
    _, pxy, pscore, pvalid, plevel = want
    assert torch.equal(valid, pvalid), f"{name}: cell validity differs"
    assert torch.equal(xy, pxy), f"{name}: cell winners differ"
    assert torch.equal(level, plevel), f"{name}: cell levels differ"
    n_cells = int(valid.numel())
    cell_err = float((score - pscore).abs().max()) if n_cells else 0.0
    assert cell_err <= 1e-2 + 1e-4 * float(pscore.abs().max()), (
        f"{name}: cell score error {cell_err}")
    max_err = max(max_err, cell_err)
    out = dict(shape=shapes, cell=cell, levels_per_launch=len(levels),
               n_cells=n_cells, n_valid_cells=int(valid.sum()),
               max_abs_err=max_err, n_corners=n_both,
               n_mask_mismatch=n_diff)
    msg = (f"{name} {shapes} cell {cell}: corners {n_both}, mask mismatches "
           f"{n_diff}, cells {n_cells} ({out['n_valid_cells']} valid, "
           f"winners equal), max_abs_err {max_err:.3g}")
    if timed:
        def run_kernel():
            return detect._launch(levels, cell, FAST_T, ST_T)

        def run_wrapper():
            return detect.fast_shi_tomasi_cells(levels, cell, FAST_T, ST_T)

        def run_plain():
            return detect.fast_shi_tomasi_cells_plain(levels, cell, FAST_T,
                                                      ST_T)

        ms, plain_ms = graph_ms(run_kernel), graph_ms(run_plain, launches=10)
        call_ms, wrapper_ms = time_ms(run_kernel), time_ms(run_wrapper)
        plain_call_ms = time_ms(run_plain, inner=2)
        px = sum(h * w for h, w in shapes)
        bytes_ms = (2 * px * 4 + 8 * n_cells) / PEAK_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_PIXEL * px / PEAK_F32_OPS_PER_S * 1e3
        out.update(ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                   wrapper_call_ms=wrapper_ms, plain_call_ms=plain_call_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        msg += (f"; device time (graph replay) kernel {ms:.5f} ms, plain "
                f"{plain_ms:.4f} ms; per eager call kernel {call_ms:.4f} ms, "
                f"wrapper with cell decode {wrapper_ms:.4f} ms, plain "
                f"{plain_call_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.5f} "
                f"ms (bytes {bytes_ms:.5f}, operations {ops_ms:.5f})")
    say("kernel", msg)
    return out


def time_detect_pyramid(cfg, pyr) -> dict:
    """One eager ``detect_pyramid`` call as the step makes it (no lock),
    plain route against fused, in turns: plain, fused, fused, plain."""
    from sdvl_tpu_torch.ops import fast

    s = cfg.sdvl

    def run(use_fused):
        return lambda: fast.detect_pyramid(
            pyr, levels=s.max_fast_levels, cell=s.cell_size,
            fast_threshold=s.fast_threshold,
            st_threshold=s.min_feature_score, max_features=s.num_features,
            use_fused=use_fused)

    t = [time_ms(run(f), reps=10, inner=5) for f in (False, True, True, False)]
    out = dict(plain_ms=[t[0], t[3]], fused_ms=[t[1], t[2]])
    say("kernel", f"detect_pyramid on the first query frame, ms per eager "
                  f"call: plain route {t[0]:.4f} / {t[3]:.4f}, fused "
                  f"{t[1]:.4f} / {t[2]:.4f}")
    return out


def umeyama_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of ``est`` against ``gt`` (N, 3) after the best similarity
    (rotation, translation, scale) alignment of est onto gt."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = g.T @ e / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_e = (e ** 2).sum() / est.shape[0]
    scale = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    aligned = scale * (R @ e.T).T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


def camera_centres(poses: np.ndarray) -> np.ndarray:
    from sdvl_tpu_torch.core import se3

    p = torch.from_numpy(np.asarray(poses, np.float32))
    return se3.translation(se3.inverse(p)).numpy().astype(np.float64)


def map_leaves(m):
    out = []
    for v in m:
        out.extend(v if isinstance(v, tuple) else [v])
    return out


SLAM_EXTRA_FRAMES = 45


def render_preset_frames(rec):
    """The recorded run's 40 preset frames, rendered by the port's copy of
    the synthetic scene from the recorded ground-truth poses, then the
    ``SLAM_EXTRA_FRAMES`` that follow on the same trajectory, as uint8.
    Fails unless the first 40 frames' SHA-256 equals the recorded one (the
    JAX run's frames). Returns (frames, ground-truth poses)."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene

    scene = PlaneScene(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                       width=640, height=480, plane_z=4.0)
    rec_poses = rec["poses_gt"]
    n = len(rec_poses)
    traj = np.stack(scene.trajectory(n + SLAM_EXTRA_FRAMES,
                                     translation_amp=1.0))
    d_traj = float(np.abs(traj[:n] - rec_poses).max())
    assert d_traj <= 1e-6, f"trajectory differs from the record by {d_traj}"
    poses = np.concatenate([rec_poses, traj[n:]])
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses]
    h = hashlib.sha256()
    for f in frames[:n]:
        h.update(np.ascontiguousarray(f).tobytes())
    want = bytes(rec["frames_sha256"]).decode()
    assert h.hexdigest() == want, (
        f"rendered frames differ from the recorded run's: SHA-256 "
        f"{h.hexdigest()} != {want}")
    return frames, poses


def slam_draws(rec, n_hyp: int = 64, n_lanes: int = 200):
    """The recorded JAX run's random draws as a ``Draws`` provider. A
    recorded frame the JAX run did not track has no pose noise: asking for
    it means the port's states diverged. Frames past the record draw
    standard Gumbel noise from a NumPy generator seeded by the frame
    index."""
    from sdvl_tpu_torch.pipeline.stream import Draws

    n_rec = len(rec["jax_state"])
    recorded = {int(i): g for i, g in zip(rec["pose_frames"],
                                          rec["pose_gumbel"])}

    def pose(i):
        if i < n_rec:
            return recorded.get(i)
        rng = np.random.default_rng(i)
        return rng.gumbel(size=(n_hyp, n_lanes)).astype(np.float32)

    return Draws(pose=pose, homography=rec["homography_gumbel"],
                 plane=rec["plane_gumbel"])


def prefix(r, n: int):
    """The first ``n`` frames of a ``SlamResult`` (the trajectory is in the
    final world frame, which the bootstrap set once)."""
    import copy

    out = copy.copy(r)
    for name in ("poses_raw", "states", "quality", "n_matches", "n_attempts",
                 "is_keyframe", "n_corners", "median_shift", "trajectory"):
        setattr(out, name, getattr(r, name)[:n])
    return out


def first_divergence(r, rec) -> str:
    """The first frame where the run's state, keyframe flag or match count
    (beyond 2) departs from the recorded JAX run."""
    n = min(r.n_frames, len(rec["jax_state"]))
    for i in range(n):
        diffs = []
        if r.states[i] != rec["jax_state"][i]:
            diffs.append(f"state {r.states[i]} vs {rec['jax_state'][i]}")
        if r.is_keyframe[i] != rec["jax_is_keyframe"][i]:
            diffs.append(f"keyframe {r.is_keyframe[i]} vs "
                         f"{rec['jax_is_keyframe'][i]}")
        if abs(int(r.n_matches[i]) - int(rec["jax_n_matches"][i])) > 2:
            diffs.append(f"n_matches {r.n_matches[i]} vs "
                         f"{rec['jax_n_matches'][i]}")
        if diffs:
            return f"frame {i}: " + ", ".join(diffs)
    return "none"


def check_slam_run(r, rec) -> dict:
    """Hold one SLAM run against the recorded JAX run (the criteria of
    ``tests/test_stream_fsm.py``); raises on disagreement."""
    from sdvl_tpu_torch.io import evaluate

    n = len(rec["jax_state"])
    r = prefix(r, n)
    div = first_divergence(r, rec)
    assert r.n_frames == n and r.poses_raw.shape == (n, 7), r.n_frames
    assert np.isfinite(r.trajectory).all(), "non-finite pose"
    boot_j = int(np.argmax(rec["jax_is_keyframe"]))
    boot_t = int(np.argmax(r.is_keyframe))
    assert boot_t == boot_j, f"bootstrap at {boot_t}, JAX {boot_j}; {div}"
    assert (r.states == rec["jax_state"]).all(), f"states differ; {div}"
    assert (r.is_keyframe == rec["jax_is_keyframe"]).all(), (
        f"keyframe flags differ; {div}")
    running = rec["jax_state"] == 2
    dm = np.abs(r.n_matches - rec["jax_n_matches"])[running]
    assert dm.max() <= 2 and (dm > 0).mean() <= 0.15, (
        f"n_matches differ: {dm.tolist()}; {div}")
    c_gt = evaluate.positions_from_poses(rec["poses_gt"])
    c_j = evaluate.positions_from_poses(rec["jax_trajectory"])
    c_t = evaluate.positions_from_poses(r.trajectory)
    start = int(np.argmax(running))
    extent = float(np.linalg.norm(np.ptp(c_gt[start:], axis=0)))
    d_cent = float(np.linalg.norm(c_t - c_j, axis=1)[start:].max())
    assert d_cent <= 0.01 * extent, (
        f"camera centres {d_cent} from JAX's, extent {extent}")
    ate = evaluate.ate_rmse(c_t[start:], c_gt[start:], with_scale=True)
    assert ate < 0.03 * extent, f"ATE {ate} vs extent {extent}"
    n_kf = int(r.is_keyframe.sum()) + 1   # the bootstrap inserts two
    assert abs(n_kf - int(rec["jax_n_keyframes"])) <= 1, (
        n_kf, int(rec["jax_n_keyframes"]))
    return dict(bootstrap_frame=boot_t, n_keyframes=n_kf,
                max_centre_dist=d_cent, extent=extent, ate=ate,
                ate_pct=100 * ate / extent,
                frames_with_match_diff=int((dm > 0).sum()),
                max_match_diff=int(dm.max()))


def check_extension(r, stream, poses, n_rec: int) -> dict:
    """The frames past the record: RUNNING throughout, keyframes inserted,
    ATE under 3 % of the extent over every tracked frame."""
    from sdvl_tpu_torch.io import evaluate

    assert (r.states[n_rec:] == 2).all(), r.states[n_rec:].tolist()
    kf_ext = int(r.is_keyframe[n_rec:].sum())
    assert kf_ext >= 1, "no keyframe inserted past the record"
    start = int(np.argmax(r.states == 2))
    c_gt = evaluate.positions_from_poses(poses[start:])
    c_t = evaluate.positions_from_poses(r.trajectory[start:])
    extent = float(np.linalg.norm(np.ptp(c_gt, axis=0)))
    ate = evaluate.ate_rmse(c_t, c_gt, with_scale=True)
    assert ate < 0.03 * extent, f"ATE {ate} vs extent {extent}"
    return dict(frames=r.n_frames, keyframes_past_record=kf_ext,
                n_keyframes=int(stream.m.n_keyframes),
                n_points=int(stream.m.pt_valid.sum()),
                ate_pct=100 * ate / extent, extent=extent)


def run_slam(cfg, frames, rec, time_frames: bool, count_syncs: bool = False):
    """One full-SLAM stream over the frames, frame by frame. Returns
    (result, stream, per-frame seconds, per-frame synchronisation counts,
    kernel launches)."""
    from sdvl_tpu_torch.ops.cuda import detect
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    st = SdvlStream(cfg, seed=0, device="cuda", gumbel_provider=slam_draws(rec))
    torch.cuda.synchronize()
    seconds, syncs = [], []
    detect.launch_count = 0
    try:
        for f in frames:
            t0 = time.perf_counter()
            if count_syncs:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        st.feed(f)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                # the Python line that synchronised, per sync
                syncs.append([
                    f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message)])
            else:
                st.feed(f)
            if time_frames:
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    except Exception:
        if st._infos:
            say("slam", "stopped; first divergence from the JAX record: "
                + first_divergence(st.result(), rec))
        raise
    launches = detect.launch_count
    return st.result(), st, seconds, syncs, launches


def state_groups(r) -> dict:
    """Frame masks by what the frame ran: FIRST, SECOND (waiting or
    bootstrapping), RUNNING without and with a keyframe."""
    before = np.concatenate([[0], r.states[:-1]])
    return {
        "first": before == 0,
        "second": before == 1,
        "running": (before >= 2) & ~r.is_keyframe,
        "keyframe": (before >= 2) & r.is_keyframe,
    }


def per_state(r, values) -> dict:
    """Mean of per-frame ``values`` by :func:`state_groups`."""
    v = np.asarray(values, np.float64)
    return {k: {"frames": int(m.sum()),
                "mean": float(v[m].mean()) if m.any() else None}
            for k, m in state_groups(r).items()}


def run_slam_phase(card: str) -> dict:
    """Phase 4 (see the module docstring)."""
    from sdvl_tpu_torch.io import evaluate
    from sdvl_tpu_torch.io.snapshot import save_stream_snapshot
    from sdvl_tpu_torch.ops.cuda import detect
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    rec = dict(np.load(SLAM_NPZ))
    n_rec = len(rec["jax_state"])
    t0 = time.perf_counter()
    frames, poses = render_preset_frames(rec)
    say("slam", f"rendered {len(frames)} frames at {frames[0].shape} in "
                f"{time.perf_counter() - t0:.1f} s, SHA-256 of the first "
                f"{n_rec} equal to the recorded run's")
    cfg = preset_config(localize_only=False)
    n = len(frames)

    r0, _, s0, _, _ = run_slam(cfg, frames[:n_rec], rec, time_frames=True)
    c0 = check_slam_run(r0, rec)
    say("slam", f"cold run: first frame {1e3 * s0[0]:.1f} ms, {n_rec} frames "
                f"in {sum(s0):.2f} s; {c0}")
    r, st, secs, _, launches = run_slam(cfg, frames, rec, time_frames=True)
    chk = check_slam_run(r, rec)
    ext = check_extension(r, st, poses, n_rec)
    assert launches == n, f"kernel launches {launches} != one per frame ({n})"
    ms = per_state(r, [1e3 * x for x in secs])
    say("slam", f"states {r.states.tolist()}")
    say("slam", f"keyframes {r.is_keyframe.astype(int).tolist()}")
    say("slam", f"n_matches {r.n_matches.tolist()}")
    say("slam", f"JAX n_matches {rec['jax_n_matches'].tolist()}")
    say("slam", f"warm run, first {n_rec} frames against the record: {chk}")
    say("slam", f"warm run, all {n} frames: {ext}; kernel launches "
                f"{launches} = 1 x {n}")
    say("slam", f"ms per frame by state (warm, synchronised per frame): "
                + ", ".join(f"{k} {v['mean']:.1f} ({v['frames']} frames)"
                            for k, v in ms.items() if v["frames"])
                + f"; first frame of the cold run {1e3 * s0[0]:.1f} ms; "
                  f"{n / sum(secs):.3f} frames/s on {card}")
    r2, st2, _, sites, _ = run_slam(cfg, frames, rec, time_frames=False,
                                    count_syncs=True)
    check_slam_run(r2, rec)
    check_extension(r2, st2, poses, n_rec)
    syncs = [len(x) for x in sites]
    sy = per_state(r2, syncs)
    say("slam", "synchronisations per frame (set_sync_debug_mode): "
                + ", ".join(f"{k} {v['mean']:.2f}" for k, v in sy.items()
                            if v["frames"])
                + f"; {syncs}")
    by_site = {}
    for i in (0, 1, 2, 10):      # FIRST, SECOND, bootstrap, RUNNING frames
        by_site[i] = {x: sites[i].count(x) for x in sorted(set(sites[i]))}
    kf = [i for i in np.nonzero(r2.is_keyframe)[0] if i > n_rec]
    if kf:
        i = int(kf[0])
        by_site[i] = {x: sites[i].count(x) for x in sorted(set(sites[i]))}
    say("slam", f"where they are, by frame: {by_site}")

    # the port's own map, served
    cfg_loc = preset_config(localize_only=True)
    query = frames[8:32]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slam_map.npz")
        save_stream_snapshot(st, path)
        loc = SdvlStream.localizer(cfg_loc, path, seed=1, device="cuda")
        torch.cuda.synchronize()
        detect.launch_count = 0
        t0 = time.perf_counter()
        loc.feed_chunk(np.stack(query), block=True)
        loc_s = time.perf_counter() - t0
        loc_launches = detect.launch_count
    rl = loc.result()
    running = rl.states == 2
    assert np.isfinite(rl.poses_raw).all()
    assert int(np.argmax(running)) <= 5, "no relocalization within 5 frames"
    assert running[-5:].all(), "not RUNNING on the last 5 frames"
    p_gt = evaluate.positions_from_poses(poses[8:32])[running]
    p_est = evaluate.positions_from_poses(rl.trajectory)[running]
    extent = float(np.linalg.norm(np.ptp(p_gt, axis=0)))
    ate = evaluate.ate_rmse(p_est, p_gt, with_scale=True)
    assert ate < 0.05 * extent, f"served ATE {ate} vs extent {extent}"
    assert loc_launches == len(query), loc_launches
    say("slam", f"served the port's own map: states {rl.states.tolist()}, "
                f"ATE {ate:.5f} over {extent:.4f} ({100 * ate / extent:.2f} "
                f"%), {len(query)} frames in {loc_s:.3f} s, kernel launches "
                f"{loc_launches}")
    return dict(launches=launches, loc_launches=loc_launches,
                loc_frames=len(query), check=chk,
                extension=ext, ms_by_state=ms, syncs_by_state=sy,
                sync_sites=by_site, first_frame_ms=1e3 * s0[0], frames=n,
                frames_per_s=n / sum(secs), served_ate_pct=100 * ate / extent)


def run_slice(cfg, query, count_launches: bool):
    """One localizer run over the query frames. Returns (result,
    seconds, launches, stream)."""
    from sdvl_tpu_torch.ops.cuda import detect
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    gumbel = query["gumbel"]
    loc = SdvlStream.localizer(cfg, MAP_NPZ, seed=1, device="cuda",
                               gumbel_provider=lambda i: gumbel[i])
    before = [t.clone() for t in map_leaves(loc.m)]
    torch.cuda.synchronize()
    if count_launches:
        detect.launch_count = 0
    t0 = time.perf_counter()
    loc.feed_chunk(query["frames"], block=True)
    seconds = time.perf_counter() - t0
    launches = detect.launch_count
    r = loc.result()
    after = map_leaves(loc.m)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b), "map changed"
    return r, seconds, launches, loc


def main() -> int:
    # ---------------------------------------------------------- 1 device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"python {sys.version.split()[0]}, "
                  f"devices {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    from sdvl_tpu_torch.ops import pyramid   # the package switches TF32 off
    from sdvl_tpu_torch.ops.cuda import detect

    # ----------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    detect.load_library(verbose=True)
    say("build", f"csrc/detect.cu -> _build/libsdvl_detect.so in "
                 f"{time.perf_counter() - t0:.1f} s ({' '.join(detect.NVCC_FLAGS)})")

    # ---------------------------------------------------------- 3 kernel
    cfg = preset_config()
    query = dict(np.load(QUERY_NPZ))
    frame0 = torch.from_numpy(query["frames"][0]).to(dev)
    pyr = pyramid.build_pyramid(frame0, 5)
    levels = pyr[:cfg.sdvl.max_fast_levels]
    checks = {"pyramid": check_launch("pyramid", levels)}
    for cell in (16, 64):
        check_launch("pyramid", levels, cell=cell, timed=False)
    for l, lev in enumerate(levels):
        checks[f"level{l}"] = check_launch(f"level{l}", [lev])
    checks["small"] = check_launch(
        "small", [torch.from_numpy(blocky_image(0, (64, 96))).to(dev)])
    checks["ragged"] = check_launch(
        "ragged", [torch.from_numpy(blocky_image(1, (123, 171))).to(dev)])
    for bad in (torch.zeros((480, 640), dtype=torch.float64, device=dev),
                torch.zeros((480, 640), device=dev)[:, ::2]):
        for call in (lambda: detect.fast_shi_tomasi_map(bad),
                     lambda: detect.fast_shi_tomasi_cells([levels[0], bad])):
            try:
                call()
            except ValueError:
                pass
            else:
                raise AssertionError("wrapper accepted a tensor it cannot take")
    dp = time_detect_pyramid(cfg, pyr)

    # ------------------------------------------------------------ 4 slam
    slam = run_slam_phase(card)

    # ----------------------------------------------------------- 5 slice
    n = len(query["frames"])
    _, cold_s, _, _ = run_slice(cfg, query, count_launches=False)
    say("slice", f"first run (cold: cuBLAS/cuSOLVER set-up, allocator): "
                 f"{n} frames in {cold_s:.3f} s")
    r, seconds, launches, loc = run_slice(cfg, query, count_launches=True)
    states = r.states.tolist()
    say("slice", f"states {states}")
    say("slice", f"n_matches {r.n_matches.tolist()}")
    running = r.states == 2
    assert r.poses_raw.shape == (n, 7) and np.isfinite(r.poses_raw).all()
    assert int(np.argmax(running)) <= 5, "no relocalization within 5 frames"
    assert running[-5:].all(), "not RUNNING on the last 5 frames"
    min_matches = cfg.sdvl.min_matches
    frac = float((r.n_matches[running] >= min_matches).mean())
    assert frac >= 0.9, f"only {frac:.2f} of RUNNING frames reach min_matches"
    p_gt = camera_centres(query["poses_gt"])[running]
    p_est = camera_centres(r.trajectory)[running]
    extent = float(np.linalg.norm(np.ptp(p_gt, axis=0)))
    ate = umeyama_ate(p_est, p_gt)
    assert ate < 0.05 * max(extent, 1e-6), f"ATE {ate} vs extent {extent}"
    assert launches == n, f"kernel launches {launches} != one per frame ({n})"
    n_corners = int(loc.last_corners.valid.sum())
    assert n_corners > 0, "fused detection found no corner on the last frame"
    d_jax = float(np.linalg.norm(
        camera_centres(r.poses_raw) - camera_centres(query["jax_pose"]),
        axis=1).max())
    same_state = bool((r.states == query["jax_state"]).all())
    dm = int(np.abs(r.n_matches - query["jax_n_matches"]).max())
    say("slice", f"RUNNING from frame {int(np.argmax(running))}, "
                 f"{frac:.2f} of RUNNING frames >= {min_matches} matches, "
                 f"ATE {ate:.5f} over extent {extent:.4f} "
                 f"({100 * ate / extent:.2f} %), map bit-identical, "
                 f"kernel launches {launches} = 1 x {n}, corners on last "
                 f"frame {n_corners}")
    say("slice", f"against the recorded JAX run (CPU, plain detection): "
                 f"states equal {same_state}, max |n_matches diff| {dm}, "
                 f"largest camera-centre distance {d_jax:.3g}")
    say("slice", f"{n} frames in {seconds:.4f} s = {n / seconds:.2f} frames/s "
                 f"(one stream, eager, one host read per frame) on {card}")

    # --------------------------------------------------------- 6 kernels
    p3 = checks["pyramid"]
    kernels = {"kernels": [{
        "name": "fast_shi_tomasi_cells",
        "route": "cuda",
        "source": "sdvl_tpu_torch/csrc/detect.cu",
        "replaces": "sdvl_tpu/ops/pallas/detect.py:211",
        # launches, frames and frames_per_s all come from the SLAM phase's
        # warm run; the other paths' counts are beside it, each with its
        # own frame count
        "launches": slam["launches"],
        "frames": slam["frames"],
        "frames_per_s": slam["frames_per_s"],
        "launches_by_path": {"slam": slam["launches"],
                             "slam_map_served": slam["loc_launches"],
                             "localizer": launches},
        "frames_by_path": {"slam": slam["frames"],
                           "slam_map_served": slam["loc_frames"],
                           "localizer": n},
        "localizer_frames_per_s": n / seconds,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": p3["ms"],
        "plain_ms": p3["plain_ms"],
        "call_ms": p3["call_ms"],
        "wrapper_call_ms": p3["wrapper_call_ms"],
        "plain_call_ms": p3["plain_call_ms"],
        "bound_ms": p3["bound_ms"],
        "bound_by": p3["bound_by"],
        "library_ms": None,
        "shape": p3["shape"],
        "by_shape": checks,
        "detect_pyramid_ms": dp,
        "slam": slam,
        "card": card,
    }]}
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
