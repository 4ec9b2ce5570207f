#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: localization-only serving on one card.

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
4. slice   -- ``SdvlStream.localizer`` at the tum_f1 preset shape (640x480,
   5 levels, ORB gate, 200 match lanes, 100 keyframe / 4096 point slots) on
   the committed map snapshot, the 24 committed query frames through
   ``feed_chunk`` with the recorded RANSAC noise, ``result()``; checks
   relocalization, tracking, accuracy against ground truth, that the map is
   untouched and that every frame launched the kernel exactly once.
5. prints one JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``.

It imports the port (``sdvl_tpu_torch``) only: no JAX, nothing of
``sdvl_tpu``. The map and query fixtures under ``tests/data/`` are made by
``tests/make_torch_fixtures.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MAP_NPZ = os.path.join(ROOT, "tests", "data", "torch_localize_map.npz")
QUERY_NPZ = os.path.join(ROOT, "tests", "data", "torch_localize_query.npz")

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


def preset_config():
    """The tum_f1 preset shape, localization-only, fused detection on."""
    from sdvl_tpu_torch.pipeline.config import (CameraConfig, Config,
                                                SdvlConfig)

    sdvl = SdvlConfig(
        use_orb=True, num_features=1000, max_matches=200, max_keyframes=100,
        max_points=4096, max_candidates=512, fast_threshold=10.0,
        cell_size=32, pyramid_levels=5, max_fast_levels=3,
        min_avg_shift=10.0, min_keyframe_its=15, min_init_corners=40,
        map_scale=4.0, localize_only=True, use_fused_detect=True,
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

    # ----------------------------------------------------------- 4 slice
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

    # --------------------------------------------------------- 5 kernels
    p3 = checks["pyramid"]
    kernels = {"kernels": [{
        "name": "fast_shi_tomasi_cells",
        "route": "cuda",
        "source": "sdvl_tpu_torch/csrc/detect.cu",
        "replaces": "sdvl_tpu/ops/pallas/detect.py:211",
        "launches": launches,
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
        "frames": n,
        "frames_per_s": n / seconds,
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
