#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: full SLAM mode, serving, multi-
stream serving, the command-line program, the sharded bundle adjustment, a
long live-mapping run, a Zurich-capacity map, the step's cost against the
map's capacity and the shipped EuRoC configuration, on one card.

Run from the repository root on a machine with one NVIDIA GPU, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

What it does, each phase printing its own lines and its seconds, any failure
ending the run with a non-zero exit code:

1. device  -- requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` gives them, and the torch/CUDA versions.
2. build   -- compiles ``sdvl_tpu_torch/csrc/detect.cu``,
   ``sdvl_tpu_torch/csrc/graph_if.cu`` (the IF and WHILE nodes of the CUDA
   graphs) and ``sdvl_tpu_torch/csrc/small_eig.cu`` (the bootstrap's small
   eigensolver) with ``nvcc`` for ``sm_90a``, one compiler per source,
   started together, and loads them.
3. kernel  -- holds the detection kernel (score maps and per-cell winners of
   all levels in one launch) against its plain torch version on the card,
   under both border rules (``plain``: the reference's plain route, the
   shipped configs'; ``pallas``: its Pallas kernel's): the three detection
   levels of the first query frame in one launch (at cell 32, then 16 and
   64; at cell 32 also the launch replayed from a CUDA graph, as the graph
   path makes it), the three levels of phase euroc's first frame (752x480:
   23.5, 11.75 and 5.875 cells of 32, a partial cell at every level; timed,
   and replayed from a graph), each level alone, a small 64x96 level and a
   ragged 123x171 one (scalar staging). Maps and cell results must be
   bit-identical. It times, with CUDA events, the device time of one launch
   (many launches replayed from a CUDA graph), one eager call of the launch
   and of the wrapper with its cell decode, the plain version, and one
   eager ``detect_pyramid`` call on the first query frame, through the
   kernel against through its plain version. Then the small eigensolver
   against ``torch.linalg.eigh``/``svd`` on the card at the bootstrap's
   shapes (a RANSAC batch of 128 9x9 ``A^T A``, one weighted 9x9, a 3x3
   covariance, a 3x3 SVD), near-degenerate matrices, 1, 2, 5 and 8 rows, a
   batch of 1000 and exact ties: values within 1e-5 of the largest,
   ``A V = V diag(w)`` within 1e-5 of it, ascending, ties in index order,
   vectors' |cos| >= 1 - 1e-4 where their value stands apart, each launch
   counted by the kernel; the ``-Xptxas -v`` lines of
   ``libsdvl_small_eig.so`` (registers, stack frame, spills); its device
   time, eager call and the library call's (which synchronises), and the
   library call's device time (its kernels, from ``torch.profiler``),
   beside the launch floor: an empty ``<<<1,1>>>`` kernel node (1000 in
   one graph). And the conditional nodes, each replayed from one graph
   with its result and the condition kernel's launches checked, and timed
   beside the same floor: a WHILE node of 1000 iterations with an if/else
   ``device_if`` in its body (one condition launch per pair); 1000 IF nodes
   with empty bodies (the condition kernel's own time per node); 1000
   if/else pairs with empty bodies; a ``device_fori`` of 1000 iterations
   with an empty body (1001 condition launches and no other kernel).
4. slam    -- ``SdvlStream`` in full SLAM mode at the tum_f1 preset shape
   (640x480, 5 levels, ORB gate, 1000 features, 200 match lanes, 100
   keyframe / 4096 point / 512 candidate slots, the Pallas border rule as
   the record was made) from an empty map over the 85 ``PlaneScene`` frames
   of ``tests/data/torch_slam_record.npz``, rendered here with
   ``sdvl_tpu_torch.io.synthetic`` and checked against its SHA-256, fed the
   JAX run's random draws from that file, on the graph path (the stream's
   whole step captured at frame 0, FIRST, SECOND and tracking as IF nodes;
   every frame one replay). Two runs: cold (the first 40 frames) and warm
   (timed per frame,
   synchronised per frame, synchronisations counted per frame, kernel
   launches and graph replays counted). Each is held against the recorded
   JAX run: bootstrap frame, states and keyframe flags equal (a tracked
   keyframe after the bootstrap among them), ``n_matches`` within 2 on at
   most 15 % of RUNNING frames, camera centres within 1 % of the trajectory
   extent, Sim(3)-aligned ATE under 3 % of the extent, keyframe count
   within 1; one replay on every frame and no synchronisation on any after
   the capture frame (0); the SECOND frames' ms, the capture's seconds and
   pool, the small eigensolver's launches. Then the port's own map
   is saved with ``save_stream_snapshot`` and served by
   ``SdvlStream.localizer`` on ``frames[8:32]``: RUNNING within 5 frames and
   on the last 5, ATE under 5 %.
   graph   -- the first 60 of the 85 frames (the bootstrap, tracking and
   the tracked keyframe at frame 56) on the eager card path
   (``graphs=False``), held to the record and to the graph run (every
   frame's packed info bit for bit); prints synchronisations per frame by
   state, graph replays per frame, the capture's time, ms per frame by state and frames/s of both
   paths, the graph path's rate with nothing synchronised between frames,
   one replay's kernels and device time (``torch.profiler``), and the
   device memory of the graph's pool; dropping the stream must give at
   least that pool back to the card.
   chunk   -- the same 85 frames through ``feed_chunk`` in chunks of 16 (the
   tail a chunk of 5) from frame 0: one replay per chunk (a WHILE node over
   the step; one graph per chunk length), no synchronisation in a chunk
   that captures nothing, every frame bit-identical to phase slam's
   per-frame graph run; ms per frame, and the chunks after the first back
   to back against the per-frame path's unsynchronised rate.
   host    -- the host driver ``SDVL`` on the same 85 frames and draws, on
   the graph path (each stage a replay of its own CUDA graph), and on the
   eager card path (``graphs=False``) over the first 60: both held to the
   record; states, match counts, keyframe flags, poses and trajectory
   bit-identical between the two; one synchronisation on each frame that
   captures no graph, FIRST and SECOND included; two or more stage replays on each tracking
   frame, 4 on a SECOND frame (detection, bootstrap, seed map, initial
   match), 1 on a FIRST frame; kernel launches = frames + 2 in each of the
   detection and preprocess graphs' captures;
   prints synchronisations, replays and ms per frame by state, frames/s of
   both paths, each stage graph's pool and capture time; dropping the
   driver must give its pool back.
5. slice   -- ``SdvlStream.localizer`` at the tum_f1 preset shape on the
   committed JAX-built map snapshot, the 24 committed query frames through
   ``feed_chunk`` with the recorded RANSAC noise, ``result()``; checks
   relocalization, tracking, accuracy against ground truth, that the map is
   untouched and that every frame launched the kernel exactly once; prints
   the distance to the recorded JAX run (made with the plain route) for the
   plain border rule beside the pallas rule the earlier slices ran; then the
   query frames one ``feed`` at a time on the graph path and on the eager
   card path: one replay per frame, no synchronisation after the capture
   frame, every frame's packed info bit-identical.
6. multi   -- ``dist.multi_stream.MultiStream``: the JAX-built map, frozen
   and shared, served to 1, 4 and 8 streams on the 24 query frames (stream
   ``i`` seeded ``1 + i``, lane 0 fed the recorded noise), twice: one
   ``feed`` per frame batch (one replay of the batch graph over all
   streams, captured in the first batch), then ``feed_chunk`` in chunks of
   8 (one replay of the chunk graph, a WHILE node over the batch, captured
   in the first chunk). Each run: every stream RUNNING within 5 frames and
   on the last 5, the map bit-identical, one capture, kernel launches =
   streams x frames + streams in each of the capture's two eager passes,
   one replay per feed or per chunk, no synchronisation after the
   capture, lane 0 equal to phase slice; the chunked rows bit-identical to
   the per-frame ones. Prints each graph's capture seconds, the shared
   pool, the peak of allocated memory, aggregate stream-frames/s after the
   first call of each run, the device ms per stream-frame of a chunk
   replay (CUDA events), and the figures of a graph per stream beside
   them. Then 2 full-SLAM streams with a map each over the 85 record
   frames in chunks of 17 (one replay a chunk), lane 0 fed the record's
   draws and held to its criteria, with the pool and peak memory.
7. cli     -- the command-line program, ``sdvl_tpu_torch.cli.run.main``
   in process on the card, over 85 ``PlaneScene`` frames (plus 6 for a
   resumed session) rendered through the lens of ``configs/tum_f1.cfg``
   (its intrinsics and d1..d5) and written as binary PGM files with image
   lists. Runs counting the kernel's launches (one per frame), the
   synchronisations inside each frame's call and printing frames/s:
   (1) ``--stream --global-ba --output --snapshot`` with the config as
   shipped (1000 keyframe slots): RUNNING from the bootstrap on, Sim(3) ATE
   under 3 % of the extent before and after global BA, global BA on the PCG
   path, 85 finite TUM rows, the snapshot loads in ``SdvlStream``; (2) the
   same at 100 slots: states and keyframe flags equal run 1's, centres
   within 1e-4 of the extent; then ``mapper.global_ba`` on its final map
   at 100 slots (Cholesky) and padded to 1000 (PCG): poses within 5e-4,
   points within 5e-3, each one replay of a CUDA graph (WHILE nodes for
   the LM and CG loops) bit-identical to ``graphs=False`` (poses, points,
   masks, CG counts) with no synchronisation, timed against it; (3) the
   host driver (its stages CUDA graph
   replays) with ``--trace --snapshot``: trajectory within 1e-4 of run
   2's, ``n_matches`` within 1 on at most 15 % of RUNNING frames, the trace
   holds ``preprocess`` and ``track``, one synchronisation on each tracking
   frame that captures no graph;
   (3b) the host driver with ``--viz DIR --viz-every 10`` over 30 frames:
   the PNGs exist and decode, and the frames it does not record synchronise
   as run 3's do (without matplotlib: ``--viz`` must stop before the first
   frame with an error naming it, then the recorder runs with its map
   figures off); (3c) the host driver at the shipped capacity: states
   equal run 3's, camera centres within 1e-4 of the extent, one
   synchronisation per tracking frame; (4) ``--async-mapping`` at 100 and
   at 1000 slots: the criteria of ``tests/test_runtime_async.py``, one
   synchronisation per tracking frame; each host run prints frames/s,
   replays per frame and its graphs' pools; (5) ``--resume`` of run 3's snapshot
   over 6 more frames, and ``--stream --localize`` of run 1's map on frames
   8-31 (RUNNING within 5 frames and on the last 5, ATE under 5 %).
8. dist    -- ``torch.distributed`` with nccl at world size 1:
   ``mapper.global_ba(mesh=...)`` as one graph replay (its all-reduces in
   the WHILE bodies of the LM and CG loops, its gather at the top level;
   no synchronisation before the result) and eagerly (``graphs=False``),
   against ``global_ba()`` on run 2's map at 100 slots (Cholesky) and
   padded to 1000 (PCG): poses within 5e-4, points within 5e-3, gated
   observations equal; all timed, the replays apart.
9. long    -- the JAX package's long live-mapping run
   (``sdvl_tpu_torch.tools.long_run.run_protocol``, the port's copy of
   ``tools/long_run.py``) at the depth of
   ``tests/data/torch_long_run_record.npz``: its 640x480 scene and config
   (a plane at z = 8 under a 4096-px texture, ``min_avg_shift`` 10,
   ``min_keyframe_its`` 10, 160 point slots per keyframe slot, 512
   candidate slots) with the record's keyframe slots, frames and lawnmower
   path, 5 black frames at 0.6 of the run, chunks of 16 through
   ``SdvlStream.feed_chunk`` (one replay each), the frames rendered by a
   pool of threads ahead of the feed, the card drawing its own RANSAC
   noise. Checks the frames' SHA-256 against the record's, the JAX tool's
   assertions (final RUNNING, tracked ratio > 0.9, a relocalization after
   the blackout, live keyframes <= K, insertions >= 3K, evictions and
   prunes > 0, a finite ATE), the bootstrap frame against the recorded
   JAX runs', the tracked ratio, insertions, evictions, prunes, LOST frames
   and Sim(3) ATE against the recorded JAX runs' range (one per seed)
   widened on each side by its own width, at least by ``LONG_FLOORS``; one
   replay per chunk, no synchronisation in a chunk that captures nothing,
   kernel launches = frames + 2 per capture. Prints both rates (chunk
   replays alone, CUDA events; the harness's wall clock with rendering
   overlapped), the first chunk's seconds, the capture's and the pool.
   Then the same run again with a relocalizer lane budget below its 12
   slots (path ``long_lanes``, ``tests/data/torch_long_run_lanes_record.npz``:
   ``reloc_max_keyframes`` 4, the shipped ``reloc_escalate_after`` 8, so
   that the first real frames after the blackout take the nearest lanes;
   the record's JAX runs of that configuration), as every shipped config's
   1000 slots have it: held to its own record the same way. Which sweep a
   LOST frame took is decided inside the graph and not observed here: it
   is inferred from the states by ``do_reloc``'s rule, and the run must
   have LOST frames on both sides of the escalation, nearest lanes on
   real frames included (the CPU tests observe the calls themselves; the
   first configuration sweeps every slot on every LOST frame).
10. zurich -- the JAX package's Zurich-capacity smoke
   (``sdvl_tpu_torch.tools.zurich_scale_smoke``, the port's copy of
   ``tools/zurich_scale_smoke.py``) at its defaults: 320 of 1000 keyframe
   slots filled with rendered 640x480 views (their float32 bytes' SHA-256
   equal to ``tests/data/torch_zurich_record.npz``'s), 4096 points.
   Serving first, as the tool does: a localize-only stream over the map
   sent LOST near keyframe 8, its reloc step cold (the capture) and warm
   (the carry written in place: a replay), 64 feeds, a chunk of 32 then 4
   timed: relocalized on frame 0 and final RUNNING as the JAX run, RUNNING
   frames within ``ZURICH_TRACKED`` of its (the card draws its own RANSAC
   noise), captures only at the cold step and the first chunk, one replay
   per call, no synchronisation in a call that captures nothing, kernel
   launches = frames + 2 per capture; the standalone relocalizer at 16, 64
   and 256 lanes (a graph each, replayed 9 times): the JAX run's keyframe,
   its pose within ``ZURICH_LANE_POSE``. Then global BA fed the JAX
   tool's perturbation draws: one replay with no synchronisation before
   its result, the error before within ``ZURICH_E0_REL`` of the record's,
   the tool's ``e1 < 0.35 * e0``, both errors after under
   ``ZURICH_E1_ABS`` px, the filled slots' camera centres within
   ``ZURICH_CENTRES`` of the record's, the points each at its distance from
   the nearer of the reference's two evaluations in the record (jitted, op
   by op) within ``ZURICH_POINTS`` of the reference's own spread between
   them among points seen by as many keyframes (the distribution printed
   beside the reference's); the CG iterations of each LM step beside the
   record's. Prints every key of the tool's JSON, the peak of allocated
   memory and the phase's seconds.
11. capacity -- the JAX package's capacity probe
   (``sdvl_tpu_torch.tools.capacity_probe``) at K = 100, 300 and 1000 over
   its 320 frames (SHA-256 checked) in chunks of 16: each K held to the
   record's JAX run at that K by phase slam's criteria (bootstrap frame,
   states and keyframe flags equal, camera centres within 1 % and Sim(3)
   ATE under 3 % of the extent), ``n_matches`` held as phase long holds its
   counts (the card draws its own RANSAC noise: the record's JAX runs at K
   = 100 under seeds 1 and 2 part from seed 0 on a share of frames, by up
   to a largest difference, and both, widened by their own width, bound
   the card's; at least phase slam's 2 and 15 %); the three against each
   other (states and keyframe flags
   equal, camera centres within 1e-4 of the extent or the record's own
   spread between capacities where that is larger); one replay per chunk,
   no synchronisation after the capture, kernel launches = frames + 2.
   Prints per K the ms per frame, frames/s, the first chunk's seconds, the
   capture's, the pool, the map's MB and the device ms per frame of a
   chunk replay.
12. euroc -- ``configs/euroc.cfg`` as shipped (752x480, its radial-
   tangential lens, 1000 keyframe slots, the plain detection route)
   against ``tests/data/torch_euroc_record.npz`` (the JAX stream on a
   CPU): its 85 ``PlaneScene`` frames rendered through the lens (SHA-256
   checked) and written as PGM files. (1) ``SdvlStream`` on the graph path
   fed the record's draws, held to the record (``check_witnessed_run``) by
   phase slam's criteria (bootstrap frame and states equal, three tracked
   keyframes, centres within 1 % and Sim(3) ATE under 3 % of the extent,
   keyframe count within 1), ``n_matches`` within the bounds of the
   record's witness (its bootstrap frame op by op) widened as phase
   capacity widens its seeds, keyframe flags equal but on a tie
   (``keyframe_tie``), and gauge-free: the world yaw about z against the
   record's within ``EUROC_YAW`` of the witness's (the tilt within
   ``EUROC_TILT``), the camera centres then within ``EUROC_CENTRES`` of
   the extent; one capture
   at frame 0, one replay per frame, no synchronisation after it, kernel
   launches = frames + 2. (2) global BA at the 1000 slots on the recorded
   map (its filled slots and points put into an empty map on the card):
   one replay, no synchronisation, the PCG path, points and centres held
   to the record's two evaluations as phase zurich holds them
   (``EUROC_POINTS``). (3) ``python -m sdvl_tpu_torch.cli.run --config
   configs/euroc.cfg --images DIR --stream --global-ba --output``: RUNNING
   from the bootstrap on, Sim(3) ATE under 3 % of the extent before and
   after global BA, the PCG path, one kernel launch and one replay per
   frame. Prints frames/s, ms per frame by state, the capture's seconds
   and pool, global BA's times.
13. prints one JSON line ``{"kernels": [...]}`` and, last,
   ``{"ok": true, "device": {...}}``. Launches are counted by the kernel
   itself, in a counter on the card that each launch adds 1 to (a launch
   replayed from a CUDA graph included), set to 0 just before a path is
   driven and read just after. The kernel's ``launches``, ``frames`` and
   ``frames_per_s`` are the slam phase's warm run (the graph path: one
   launch per frame, and one in each of the two eager passes before the
   capture); ``launches_by_path``, ``frames_by_path`` and
   ``captures_by_path`` give each path's count beside its frames and its
   graph captures
   (``slam_eager``: the graph phase's eager card run)
   (stream-frames for ``multi_1``, ``multi_4``, ``multi_8``, the chunked
   ``multi_chunk_1``, ``multi_chunk_4``, ``multi_chunk_8``, and
   ``multi_slam``; ``cli_stream``, ``cli_host``, ``cli_host_1000``,
   ``cli_async``, ``cli_async_1000``, ``cli_viz``
   for the cli phase; ``host``, ``host_eager`` for phase host; ``chunk``;
   ``long``, ``long_lanes`` for phase long; ``zurich_serve``; ``capacity_100``,
   ``capacity_300``, ``capacity_1000``; ``euroc``, ``euroc_cli`` for phase
   euroc; the condition kernel also ``zurich_ba`` and ``euroc_ba``, global
   BA's replays).
   ``ms`` is the pallas border rule's device time,
   ``plain_border_ms`` the plain rule's. The entries ``small_eig_eigh``
   and ``small_eig_svd3`` give each kernel's launches by path (counted by
   the kernel, beside ``frames_by_path``; ``small_eig_launches_by_path``
   both together), its times at
   the bootstrap's largest call (the RANSAC batch; the 3x3 SVD), every
   shape in ``by_shape``, and its ``ptxas`` figures;
   ``set_condition_kernel`` gives the condition kernel's launches and
   frames by path and the if/else pairs among them (each pair one launch that sets both
   of its nodes, counted by the kernel: at least one a frame),
   ``per_branch_launches_by_path`` their sum (what a condition per branch
   would launch), the time of one IF node with an empty body beside the
   eager host read it takes the place of, and the times of an if/else
   pair, a counted iteration, a WHILE iteration and the launch floor.

It imports the port (``sdvl_tpu_torch``) only: no JAX, nothing of
``sdvl_tpu``. The fixtures under ``tests/data/`` are made by
``tests/make_torch_fixtures.py``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import hashlib
import json
import os
import re
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
LONG_NPZ = os.path.join(ROOT, "tests", "data", "torch_long_run_record.npz")
LONG_LANES_NPZ = os.path.join(ROOT, "tests", "data",
                              "torch_long_run_lanes_record.npz")
ZURICH_NPZ = os.path.join(ROOT, "tests", "data", "torch_zurich_record.npz")
EUROC_NPZ = os.path.join(ROOT, "tests", "data", "torch_euroc_record.npz")
EUROC_CFG = os.path.join(ROOT, "configs", "euroc.cfg")

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


def preset_config(localize_only: bool = True,
                  use_pallas_detect: bool = False):
    """The tum_f1 preset shape (the plain detection route unless
    ``use_pallas_detect``)."""
    from sdvl_tpu_torch.pipeline.config import (CameraConfig, Config,
                                                SdvlConfig)

    sdvl = SdvlConfig(
        use_orb=True, num_features=1000, max_matches=200, max_keyframes=100,
        max_points=4096, max_candidates=512, fast_threshold=10.0,
        cell_size=32, pyramid_levels=5, max_fast_levels=3,
        min_avg_shift=10.0, min_keyframe_its=15, min_init_corners=40,
        map_scale=4.0, localize_only=localize_only,
        use_pallas_detect=use_pallas_detect,
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


def check_map(name: str, got: torch.Tensor, want: torch.Tensor,
              border: str):
    """One level's kernel map against the plain map, bit for bit (equal
    finite masks, equal scores, -inf elsewhere); under the pallas rule the
    4-px border must be all -inf. Raises on disagreement. Returns (corners,
    max abs error)."""
    H, W = want.shape
    assert got.shape == want.shape == (H, W) and got.dtype == torch.float32
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    assert bool(((got == float("-inf")) | fg).all()), f"{name}: nan in map"
    if border == "pallas":
        inner = torch.zeros_like(fg)
        inner[4:H - 4, 4:W - 4] = True
        assert not bool((fg & ~inner).any()), f"{name}: finite score in border"
    n_diff = int((fg != fw).sum())
    assert n_diff == 0, f"{name}: {n_diff} pixels finite in one map only"
    n_both = int(fg.sum())
    assert n_both > 0, f"{name}: no corner found, the check is empty"
    err = float((got[fg] - want[fg]).abs().max())
    assert torch.equal(got, want), (
        f"{name}: maps not bit-identical, max abs error {err}")
    return n_both, err


def check_launch(name: str, levels, cell: int = 32, timed: bool = True,
                 border: str = "pallas") -> dict:
    """One launch of the kernel over ``levels`` under the ``border`` rule
    against the plain version (per-level plain map plus ``grid_best``):
    maps and cell results (position, score, validity, level) bit-identical.
    With ``timed``, also the times of the launch, of the wrapper and of the
    plain version, and the bound. Raises on disagreement."""
    from sdvl_tpu_torch.ops.cuda import detect

    shapes = [list(l.shape) for l in levels]
    got = detect.fast_shi_tomasi_cells(levels, cell, FAST_T, ST_T, border)
    torch.cuda.synchronize()
    want = detect.fast_shi_tomasi_cells_plain(levels, cell, FAST_T, ST_T,
                                              border)
    n_both = 0
    max_err = 0.0
    for l, (g, w) in enumerate(zip(got[0], want[0])):
        c, e = check_map(f"{name} {border} level {l}", g, w, border)
        n_both, max_err = n_both + c, max(max_err, e)
    _, xy, score, valid, level = got
    _, pxy, pscore, pvalid, plevel = want
    assert torch.equal(valid, pvalid), f"{name}: cell validity differs"
    assert torch.equal(xy, pxy), f"{name}: cell winners differ"
    assert torch.equal(level, plevel), f"{name}: cell levels differ"
    assert torch.equal(score, pscore), f"{name}: cell scores differ"
    n_cells = int(valid.numel())
    out = dict(shape=shapes, cell=cell, border=border,
               levels_per_launch=len(levels), n_cells=n_cells,
               n_valid_cells=int(valid.sum()), max_abs_err=max_err,
               n_corners=n_both)
    msg = (f"{name} {shapes} cell {cell}, {border} border: corners {n_both}, "
           f"cells {n_cells} ({out['n_valid_cells']} valid), maps and cells "
           f"bit-identical to the plain version")
    if timed:
        def run_kernel():
            return detect._launch(levels, cell, FAST_T, ST_T, border=border)

        def run_wrapper():
            return detect.fast_shi_tomasi_cells(levels, cell, FAST_T, ST_T,
                                                border)

        def run_plain():
            return detect.fast_shi_tomasi_cells_plain(levels, cell, FAST_T,
                                                      ST_T, border)

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


def check_graph_launch(levels, border: str, cell: int = 32) -> None:
    """The wrapper called inside a CUDA graph, as the graph path calls it:
    captured once, its outputs cleared, replayed, then held against the
    plain version, maps and cell results bit-identical. Raises on
    disagreement."""
    from sdvl_tpu_torch.ops.cuda import detect

    out = []

    def call():
        out[:] = [detect.fast_shi_tomasi_cells(levels, cell, FAST_T, ST_T,
                                               border)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        call()
    maps, *cells = out[0]
    for t in [*maps, *cells]:
        t.zero_()
    n0 = detect.launches()
    g.replay()
    torch.cuda.synchronize()
    assert detect.launches() == n0 + 1, "the replay did not count its launch"
    want_maps, *want_cells = detect.fast_shi_tomasi_cells_plain(
        levels, cell, FAST_T, ST_T, border)
    for l, (a, b) in enumerate(zip(maps, want_maps)):
        check_map(f"graph launch {border} level {l}", a, b, border)
    for name, a, b in zip(("xy", "score", "valid", "level"), cells,
                          want_cells):
        assert torch.equal(a, b), f"graph launch {border}: cell {name} differs"
    say("kernel", f"the launch replayed from a CUDA graph, {border} border: "
                  f"counted once by the kernel, maps and cells "
                  f"bit-identical to the plain version")


def euroc_frame() -> np.ndarray:
    """The first frame of phase euroc's sequence: ``configs/euroc.cfg``'s
    752x480 view through its lens, float32."""
    _, scene = lens_scene(EUROC_CFG)
    pose = scene.trajectory(1)[0]
    return np.clip(scene.render(pose), 0, 255).astype(np.uint8).astype(
        np.float32)


def run_kernel_phase():
    """Phase 3 (see the module docstring). Returns the checks by border rule
    and shape, and the eager ``detect_pyramid`` times."""
    from sdvl_tpu_torch.ops import pyramid
    from sdvl_tpu_torch.ops.cuda import detect

    dev = torch.device("cuda")
    cfg = preset_config()
    query = dict(np.load(QUERY_NPZ))
    frame0 = torch.from_numpy(query["frames"][0]).to(dev)
    pyr = pyramid.build_pyramid(frame0, 5)
    levels = pyr[:cfg.sdvl.max_fast_levels]
    small = torch.from_numpy(blocky_image(0, (64, 96))).to(dev)
    ragged = torch.from_numpy(blocky_image(1, (123, 171))).to(dev)
    euroc = pyramid.build_pyramid(torch.from_numpy(euroc_frame()).to(dev),
                                  5)[:cfg.sdvl.max_fast_levels]
    checks = {}
    for border in detect.BORDERS:
        c = {"pyramid": check_launch("pyramid", levels, border=border),
             "euroc": check_launch("euroc", euroc, border=border)}
        check_graph_launch(euroc, border)
        check_graph_launch(levels, border)
        for cell in (16, 64):
            check_launch("pyramid", levels, cell=cell, timed=False,
                         border=border)
        for l, lev in enumerate(levels):
            c[f"level{l}"] = check_launch(f"level{l}", [lev], border=border)
        c["small"] = check_launch("small", [small], border=border)
        c["ragged"] = check_launch("ragged", [ragged], border=border)
        checks[border] = c
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
    return checks, time_detect_pyramid(cfg, pyr)


# the diagonal of eig_cases' "ties"; its values ascending, equal ones in
# index order, are these indices
TIES = [2.0, 2.0, 1.0, 3.0, 1.0, 2.0]
TIES_ORDER = [2, 4, 0, 1, 5, 3]
# svd3 on diag(SVD_TIES): values descending, equal ones in index order
SVD_TIES = [1.0, 1.0, 2.0]
SVD_TIES_ORDER = [2, 0, 1]


def eig_cases(seed: int = 0) -> dict:
    """name -> float32 matrices at the bootstrap's shapes (the RANSAC batch
    of 128 9x9 ``A^T A`` of 4-point DLT systems, one weighted 9x9, one 3x3
    covariance of a plane's points), near-degenerate ones (a 9x9 with
    eigenvalues 1, 1, 1 + 1e-7, three 3s; the identity; a rank-deficient
    covariance), 16 random symmetric matrices each of 1, 2, 5 and 8 rows
    (odd and even sizes of the kernel's pairing schedule), 1000 scaled
    RANSAC matrices (more than the kernel's blocks) and a diagonal with
    exact ties (values 2, 2, 1, 3, 1, 2)."""
    rs = np.random.default_rng(seed)
    uv = rs.uniform(-0.6, 0.6, (400, 2))
    uvb = uv + rs.normal(0, 0.02, (400, 2))
    x, y, xp, yp = uv[:, 0], uv[:, 1], uvb[:, 0], uvb[:, 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    A = np.concatenate([
        np.stack([x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp], -1),
        np.stack([zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp], -1)])
    w = np.zeros((128, 400))
    for h in range(128):
        w[h, rs.choice(400, 4, replace=False)] = 1.0
    ransac = np.einsum("ni,nj,hn->hij", A, A, np.concatenate([w, w], 1))
    refit = np.einsum("ni,nj,n->ij", A, A, np.repeat(
        rs.uniform(0, 1, 400) > 0.3, 2).astype(float))
    pts = rs.normal(0, 1, (4096, 3)) * [2.0, 1.5, 0.01]
    q = np.linalg.qr(rs.normal(0, 1, (9, 9)))[0]
    flat = rs.normal(0, 1, (100, 3)) * [1.0, 1.0, 0.0]
    cases = dict(ransac_9x9=ransac, refit_9x9=refit,
                 cov_3x3=pts.T @ pts / len(pts),
                 near_degenerate_9x9=q @ np.diag(
                     [1, 1, 1 + 1e-7, 2, 3, 3, 3, 5, 8]) @ q.T,
                 identity_3x3=np.eye(3),
                 rank_deficient_3x3=flat.T @ flat / 100)
    for n in (1, 2, 5, 8):
        m = rs.normal(0, 1, (16, n, n))
        cases[f"n{n}"] = m + np.swapaxes(m, 1, 2)
    cases["batch_1000"] = ransac[rs.integers(0, 128, 1000)] \
        * rs.uniform(0.5, 2.0, (1000, 1, 1))
    cases["ties"] = np.diag(TIES)
    return {k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
            for k, v in cases.items()}



def vector_cos(got, want, vals, gap: float = 1e-3) -> float:
    """Least |cos| between the columns of ``got`` and ``want`` whose value
    in ``vals`` is apart from the others by ``gap`` of the largest magnitude
    (1.0 where none is)."""
    n = vals.shape[-1]
    vals = vals.reshape(-1, n)
    got = got.reshape(-1, got.shape[-2], n)
    want = want.reshape(-1, want.shape[-2], n)
    d = (vals[:, :, None] - vals[:, None, :]).abs()
    d = d + torch.eye(n, device=d.device) * float("inf")
    scale = vals.abs().amax(1, keepdim=True).clamp_min(1e-30)
    apart = d.amin(2) >= gap * scale
    cos = (got * want).sum(1).abs()
    return float(cos[apart].min()) if bool(apart.any()) else 1.0


def ptxas_report(lib: str) -> dict:
    """Kernel -> its registers, stack frame and spill bytes, from the
    ``-Xptxas -v`` lines of the build of ``lib`` (``_build/<lib>``, built
    verbose in phase build); the lines are printed."""
    from sdvl_tpu_torch.ops.cuda import detect

    lines = [x.strip() for x in detect.BUILD_LOGS.get(lib, "").splitlines()
             if "ptxas" in x or "stack frame" in x]
    assert lines, f"no -Xptxas -v output for {lib}"
    for x in lines:
        say("kernel", f"{lib} ptxas: {x}")
    out, name = {}, None
    for x in lines:
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", x)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", x)
        if m and name:
            out.setdefault(name, {}).update(
                stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", x)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    names = ("eigh_kernel", "svd3_kernel", "set_condition_kernel",
             "launch_floor_kernel")
    return {next((k for k in names if k in f), f): v for f, v in out.items()}


def library_device_ms(fn, reps: int = 20) -> tuple:
    """Device time of one eager ``fn()`` (a library call): the kernels it
    launches, summed, from ``torch.profiler`` over ``reps`` calls, over
    ``reps``; where the profiler shows no device time, CUDA events around
    each call (then the gaps between its kernels count too). Returns (ms,
    how it was measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if busy_us > 0:
        return busy_us / 1e3 / reps, "profiler"
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), "events"


def launch_floor_ms(n: int = 1000) -> float:
    """Device time of one empty one-thread kernel node
    (``graph_if.launch_floor``): ``n`` in one CUDA graph, the replay over
    ``n``. The least any kernel node of a replay costs on this card."""
    from sdvl_tpu_torch.ops.cuda import graph_if

    return graph_ms(graph_if.launch_floor, launches=n)


def check_small_eig(floor_ms: float) -> dict:
    """The small eigensolver (``ops/cuda/small_eig.py``) against its plain
    version, ``torch.linalg.eigh``/``svd`` on the card, at the bootstrap's
    shapes, on near-degenerate matrices, on 1, 2, 5 and 8 rows, on a batch
    of 1000 and on exact ties (in index order, for ``eigh`` and for
    ``svd3``); raises on disagreement. Prints the kernels' ``ptxas``
    figures. Times each bootstrap shape: the kernel's device time (graph
    replay), beside ``floor_ms`` (an empty kernel node's), one eager call
    of the wrapper, and the library call's eager time (which synchronises)
    and device time."""
    from sdvl_tpu_torch.ops.cuda import small_eig

    out = {"ptxas": ptxas_report("libsdvl_small_eig.so")}
    for name, A in eig_cases().items():
        n0 = small_eig.launches(kernel="eigh")
        w, V = small_eig.eigh(A)
        torch.cuda.synchronize()
        assert small_eig.launches(kernel="eigh") == n0 + 1, (
            f"{name}: launch not counted")
        wp, Vp = small_eig.eigh_plain(A)
        scale = float(wp.abs().max()) or 1.0
        err = float((w - wp).abs().max())
        resid = float((A @ V - V * w[..., None, :]).abs().max())
        cos = vector_cos(V, Vp, wp)
        assert bool((w[..., 1:] >= w[..., :-1]).all()), f"{name}: order"
        assert err <= 1e-5 * scale and resid <= 1e-5 * scale, (
            f"{name}: eigenvalues {err}, residual {resid}, scale {scale}")
        assert cos >= 1 - 1e-4, f"{name}: eigenvector |cos| {cos}"
        if name == "ties":
            assert torch.equal(w, A.diagonal()[TIES_ORDER]) and torch.equal(
                V, torch.eye(len(TIES), device=A.device)[:, TIES_ORDER]), (
                "ties: equal eigenvalues not in index order")
        out[f"eigh_{name}"] = dict(shape=list(A.shape), max_abs_err=err,
                                   rel_err=err / scale, residual=resid,
                                   min_abs_cos=cos)
    rs = np.random.default_rng(1)
    for name, H in (("homography", np.eye(3) + rs.normal(0, 0.2, (3, 3))),
                    ("rank_2", np.diag([2.0, 1.0, 0.0]) @ np.linalg.qr(
                        rs.normal(0, 1, (3, 3)))[0]),
                    ("ties", np.diag(SVD_TIES)),
                    ("batch_1000", rs.normal(0, 1, (1000, 3, 3)))):
        A = torch.from_numpy(H.astype(np.float32)).cuda()
        n0 = small_eig.launches(kernel="svd3")
        U, S, Vh = small_eig.svd3(A)
        torch.cuda.synchronize()
        assert small_eig.launches(kernel="svd3") == n0 + 1, (
            f"{name}: launch not counted")
        Up, Sp, Vhp = small_eig.svd3_plain(A)
        scale = float(Sp.max())
        err = float((S - Sp).abs().max())
        recon = float((U @ torch.diag_embed(S) @ Vh - A).abs().max())
        cos = min(vector_cos(U, Up, Sp), vector_cos(Vh.mT, Vhp.mT, Sp))
        assert err <= 1e-5 * scale and recon <= 1e-5 * scale, (
            f"svd {name}: values {err}, reconstruction {recon}")
        assert cos >= 1 - 1e-4, f"svd {name}: vector |cos| {cos}"
        assert bool((S[..., 1:] <= S[..., :-1]).all()), f"svd {name}: order"
        if name == "ties":
            eye = torch.eye(3, device=A.device)
            assert torch.equal(S, A.diagonal()[SVD_TIES_ORDER]) and \
                torch.equal(Vh, eye[SVD_TIES_ORDER]) and \
                torch.equal(U, eye[:, SVD_TIES_ORDER]), (
                    "svd ties: equal values not in index order")
        out[f"svd_{name}"] = dict(shape=list(A.shape), max_abs_err=err,
                                  rel_err=err / scale, residual=recon,
                                  min_abs_cos=cos)
    say("kernel", "small_eig against torch.linalg on the card: "
                  + "; ".join(f"{k} {v['shape']}: values within "
                              f"{v['rel_err']:.2e} of the largest, residual "
                              f"{v['residual']:.2e}, least |cos| "
                              f"{v['min_abs_cos']:.8f}"
                              for k, v in out.items() if k != "ptxas"))
    # times at the bootstrap's shapes
    cases = eig_cases()
    H = torch.from_numpy((np.eye(3) + rs.normal(0, 0.2, (3, 3))).astype(
        np.float32)).cuda()
    timed = {"eigh_ransac_9x9": (cases["ransac_9x9"], small_eig.eigh,
                                 torch.linalg.eigh),
             "eigh_refit_9x9": (cases["refit_9x9"], small_eig.eigh,
                                torch.linalg.eigh),
             "eigh_cov_3x3": (cases["cov_3x3"], small_eig.eigh,
                              torch.linalg.eigh),
             "svd_3x3": (H, small_eig.svd3, torch.linalg.svd)}
    for name, (A, kernel, library) in timed.items():
        n = A.shape[-1]
        batch = A.numel() // (n * n)
        out_floats = batch * (n + n * n) if name.startswith("eigh") \
            else batch * (3 + 18)
        bytes_ms = 4 * (A.numel() + out_floats) / PEAK_BYTES_PER_S * 1e3
        # the least work of a symmetric eigendecomposition (or an SVD) with
        # its vectors: about 9 n^3 float operations per matrix
        ops_ms = 9 * n ** 3 * batch / PEAK_F32_OPS_PER_S * 1e3
        lib_dev_ms, lib_dev_how = library_device_ms(lambda: library(A))
        t = dict(ms=graph_ms(lambda: kernel(A)),
                 launch_floor_ms=floor_ms,
                 call_ms=time_ms(lambda: kernel(A)),
                 library_ms=time_ms(lambda: library(A), inner=2),
                 library_device_ms=lib_dev_ms,
                 library_device_by=lib_dev_how,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        t["plain_ms"] = t["library_ms"]      # the plain version is the call
        t["faster_than_library"] = t["ms"] < min(t["library_ms"], lib_dev_ms)
        out[name] = {**out.get(name, {}), **t, "shape": list(A.shape)}
        say("kernel", f"small_eig {name} {list(A.shape)}: device time "
                      f"(graph replay) {t['ms']:.5f} ms (an empty kernel "
                      f"node {floor_ms:.5f} ms), eager call "
                      f"{t['call_ms']:.4f} ms; torch.linalg (cuSOLVER, "
                      f"synchronises) {t['library_ms']:.4f} ms per eager "
                      f"call, its device time {lib_dev_ms:.5f} ms "
                      f"({lib_dev_how}); bound {t['bound_ms']:.3g} ms "
                      f"({t['bound_by']}); the kernel faster than both: "
                      f"{t['faster_than_library']}")
    say("kernel", f"svd3_kernel ptxas: {out['ptxas'].get('svd3_kernel')}; "
                  f"eigh_kernel ptxas: {out['ptxas'].get('eigh_kernel')}")
    return out


def replay_ms_per(g, count: int, reps: int = 5) -> float:
    """Device time of one replay of ``g`` over ``count`` (CUDA events,
    median of ``reps``)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / count)
    return statistics.median(times)


def check_conditional_nodes(floor_ms: float) -> dict:
    """The conditional nodes (``ops/cuda/graph_if.py``), each replayed from
    one CUDA graph with its result and the condition kernel's launches
    checked, and timed (device time of the replay over its count), beside
    ``floor_ms``, an empty kernel node's time: a WHILE node that counts to
    1000 with an if/else ``device_if`` nested in its body (its time per
    iteration); 1000 IF nodes with empty bodies (the condition kernel's own
    time, and its bound); 1000 if/else pairs with empty bodies; a
    ``device_fori`` of 1000 iterations with an empty body (what a counted
    iteration costs with no kernel of the loop's own); and beside them the
    eager host read the nodes take the place of (``bool()`` of a ()
    tensor)."""
    from sdvl_tpu_torch.ops.cuda import graph_if
    from sdvl_tpu_torch.pipeline.device_fsm import (device_fori, device_if,
                                                    device_while)

    dev = torch.device("cuda")
    n_it = 1000
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    odd0 = torch.zeros((), dtype=torch.int32, device=dev)
    out = []

    def body(c):
        i, odd = c
        odd = device_if(i % 2 == 1, lambda: odd + 1, lambda: odd.clone())
        return i + 1, odd

    def run():
        out[:] = device_while(lambda c: c[0] < n_it, body, (i0, odd0),
                              max_iters=n_it)

    def captured(fn):
        g = torch.cuda.CUDAGraph()
        with graph_if.capture(g):
            fn()
        torch.cuda.synchronize()
        graph_if.reset_launches()
        g.replay()
        torch.cuda.synchronize()
        return g, graph_if.launches(), graph_if.pairs()

    run()           # eagerly first: loads every kernel the body holds
    torch.cuda.synchronize()
    g, conds, loop_pairs = captured(run)
    i, odd = (int(t) for t in out)
    # one condition before the WHILE node, one per iteration, and the
    # if/else pair's one in each iteration
    assert (i, odd) == (n_it, n_it // 2), (i, odd)
    assert (conds, loop_pairs) == (1 + n_it + n_it, n_it), (conds, loop_pairs)
    iteration_ms = replay_ms_per(g, n_it)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    read_ms = time_ms(lambda: bool(flag), inner=10)

    def ifs():
        for _ in range(n_it):
            with graph_if.if_node(flag):
                pass

    def pairs():
        for _ in range(n_it):
            device_if(flag, lambda: None, lambda: None)

    def two_ifs():
        # the same branch built as a node per branch: an IF node on the
        # predicate and one on its logical_not
        for _ in range(n_it):
            other = torch.logical_not(flag)
            with graph_if.if_node(flag):
                pass
            with graph_if.if_node(other):
                pass

    loop_out = []

    def fori():
        loop_out[:] = [device_fori(n_it, lambda k, c: c, i0)]

    def counted_while():
        # the same count as a device_while on c < n with an add per
        # iteration (and the carry's copy back)
        loop_out[:] = device_while(lambda c: c[0] < n_it,
                                   lambda c: (c[0] + 1, c[1]), (i0, odd0),
                                   max_iters=n_it)

    g_if, n_if, p_if = captured(ifs)
    g_pair, n_pair, p_pair = captured(pairs)
    g_two, n_two, p_two = captured(two_ifs)
    g_fori, n_fori, p_fori = captured(fori)
    g_while, n_while, p_while = captured(counted_while)
    assert int(loop_out[0]) == n_it, int(loop_out[0])
    assert (n_if, n_pair, n_two, n_fori, n_while) == (
        n_it, n_it, 2 * n_it, n_it + 1, n_it + 1), (
        n_if, n_pair, n_two, n_fori, n_while)
    assert (p_if, p_pair, p_two, p_fori, p_while) == (0, n_it, 0, 0, 0), (
        p_if, p_pair, p_two, p_fori, p_while)
    # what one condition must move: the () bool read, the uint64 counter
    # read and written; its two operations are far below that
    bound_ms = (1 + 8 + 8) / PEAK_BYTES_PER_S * 1e3
    res = dict(iteration_ms=iteration_ms, conditions_per_replay=conds,
               pairs_per_replay=loop_pairs,
               host_read_ms=read_ms, if_node_ms=replay_ms_per(g_if, n_it),
               if_else_pair_ms=replay_ms_per(g_pair, n_it),
               two_if_nodes_ms=replay_ms_per(g_two, n_it),
               fori_iteration_ms=replay_ms_per(g_fori, n_it),
               counted_while_iteration_ms=replay_ms_per(g_while, n_it),
               launch_floor_ms=floor_ms, bound_ms=bound_ms,
               bound_by="bytes",
               ptxas=ptxas_report("libsdvl_graph_if.so"))
    say("kernel", f"conditional nodes, device time per node (graph replay, "
                  f"{n_it} in one graph, launches counted by the condition "
                  f"kernel), beside an empty kernel node {floor_ms:.5f} ms: "
                  f"one IF node with an empty body {res['if_node_ms']:.5f} "
                  f"ms (bound {bound_ms:.3g} ms, bytes); an if/else pair "
                  f"with empty bodies {res['if_else_pair_ms']:.5f} ms (one "
                  f"condition launch each: {n_pair} launches, {p_pair} "
                  f"pairs counted; as an IF node per "
                  f"branch and a logical_not {res['two_if_nodes_ms']:.5f} "
                  f"ms); a device_fori iteration with an empty body "
                  f"{res['fori_iteration_ms']:.5f} ms ({n_fori} condition "
                  f"launches for {n_it} iterations; as a device_while on "
                  f"c < n with an add "
                  f"{res['counted_while_iteration_ms']:.5f} ms); a WHILE "
                  f"node of {n_it} "
                  f"iterations with an if/else device_if in its body: result "
                  f"({i}, {odd}) right, {conds} condition launches "
                  f"({loop_pairs} of them pairs), "
                  f"{iteration_ms:.5f} ms per iteration (its small "
                  f"kernels and copies, two conditions: the pair's and the "
                  f"loop's); an eager host read of a () "
                  f"tensor {read_ms:.4f} ms; set_condition_kernel ptxas "
                  f"{res['ptxas'].get('set_condition_kernel')}")
    return res


def time_detect_pyramid(cfg, pyr) -> dict:
    """One eager ``detect_pyramid`` call as the step makes it (no lock), the
    kernel against the same call with the kernel's plain version in the
    wrapper's place, in turns: plain, kernel, kernel, plain."""
    from sdvl_tpu_torch.ops import fast
    from sdvl_tpu_torch.ops.cuda import detect

    s = cfg.sdvl

    def call():
        return fast.detect_pyramid(
            pyr, levels=s.max_fast_levels, cell=s.cell_size,
            fast_threshold=s.fast_threshold,
            st_threshold=s.min_feature_score, max_features=s.num_features)

    def plain():
        kernel = detect.fast_shi_tomasi_cells
        detect.fast_shi_tomasi_cells = detect.fast_shi_tomasi_cells_plain
        try:
            return call()
        finally:
            detect.fast_shi_tomasi_cells = kernel

    t = [time_ms(f, reps=10, inner=5) for f in (plain, call, call, plain)]
    out = dict(plain_ms=[t[0], t[3]], fused_ms=[t[1], t[2]])
    say("kernel", f"detect_pyramid on the first query frame, ms per eager "
                  f"call: plain version {t[0]:.4f} / {t[3]:.4f}, kernel "
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


def render_preset_frames(rec):
    """The recorded run's preset frames, rendered by the port's copy of the
    synthetic scene from the recorded ground-truth poses, as uint8. Fails
    unless their SHA-256 equals the recorded one (the JAX run's frames).
    Returns (frames, ground-truth poses)."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene

    scene = PlaneScene(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
                       width=640, height=480, plane_z=4.0)
    poses = rec["poses_gt"]
    traj = np.stack(scene.trajectory(len(poses), translation_amp=1.0))
    d_traj = float(np.abs(traj - poses).max())
    assert d_traj <= 1e-6, f"trajectory differs from the record by {d_traj}"
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses]
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    want = bytes(rec["frames_sha256"]).decode()
    assert h.hexdigest() == want, (
        f"rendered frames differ from the recorded run's: SHA-256 "
        f"{h.hexdigest()} != {want}")
    return frames, poses


def slam_draws(rec):
    """The recorded JAX run's random draws as a ``Draws`` provider. A frame
    the JAX run did not track has no pose noise: asking for it means the
    port's states diverged."""
    from sdvl_tpu_torch.pipeline.stream import Draws

    recorded = {int(i): g for i, g in zip(rec["pose_frames"],
                                          rec["pose_gumbel"])}
    return Draws(pose=recorded.get, homography=rec["homography_gumbel"],
                 plane=rec["plane_gumbel"])


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


def check_slam_run(r, rec, n=None, matches=(2, 0.15)) -> dict:
    """Hold one SLAM run against the first ``n`` frames of the recorded JAX
    run (all by default; the criteria of ``tests/test_stream_fsm.py``);
    raises on disagreement. ``matches``: the largest ``n_matches``
    difference on a RUNNING frame, and the largest share of RUNNING frames
    that may differ at all."""
    from sdvl_tpu_torch.io import evaluate

    if n is not None and n < len(rec["jax_state"]):
        rec = {k: (v[:n] if k.startswith("jax_") and k not in (
            "jax_n_keyframes", "jax_kf_frame_id", "jax_n_points")
            or k == "poses_gt" else v) for k, v in rec.items()}
        rec["jax_n_keyframes"] = int(rec["jax_is_keyframe"].sum()) + 1
    n = len(rec["jax_state"])
    div = first_divergence(r, rec)
    assert r.n_frames == n and r.poses_raw.shape == (n, 7), r.n_frames
    assert np.isfinite(r.trajectory).all(), "non-finite pose"
    boot_j = int(np.argmax(rec["jax_is_keyframe"]))
    boot_t = int(np.argmax(r.is_keyframe))
    assert boot_t == boot_j, f"bootstrap at {boot_t}, JAX {boot_j}; {div}"
    assert (r.states == rec["jax_state"]).all(), f"states differ; {div}"
    assert (r.is_keyframe == rec["jax_is_keyframe"]).all(), (
        f"keyframe flags differ; {div}")
    tracked_kf = np.nonzero(r.is_keyframe[boot_t + 1:])[0] + boot_t + 1
    running = rec["jax_state"] == 2
    dm = np.abs(r.n_matches - rec["jax_n_matches"])[running]
    assert dm.max() <= matches[0] and (dm > 0).mean() <= matches[1], (
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
                tracked_keyframes=tracked_kf.tolist(),
                max_centre_dist=d_cent, extent=extent, ate=ate,
                ate_pct=100 * ate / extent,
                frames_with_match_diff=int((dm > 0).sum()),
                max_match_diff=int(dm.max()))


CAPTURES = [0]      # captures of graphs that hold the kernel, since
                    # reset_counts()
# the stage graphs that launch the detection kernel: the stream's step and
# chunks, the host driver's detection and locked preprocess, MultiStream's
# frame batch and chunks
KERNEL_GRAPHS = ("step", "preprocess", "detect", "batch_frame")


def holds_detection(name: str) -> bool:
    return name in KERNEL_GRAPHS or name.startswith(("chunk_",
                                                     "batch_chunk_"))


def count_captures() -> None:
    """Count every capture of a graph that holds the detection kernel in
    ``CAPTURES`` from now on (once per process)."""
    from sdvl_tpu_torch.pipeline.device_fsm import StageGraph

    init = StageGraph.__init__
    if getattr(init, "counted", False):
        return

    def counted(self, name, *a, **k):
        CAPTURES[0] += holds_detection(name)
        return init(self, name, *a, **k)

    counted.counted = True
    StageGraph.__init__ = counted


def reset_counts() -> None:
    """Just before a path is driven: the kernels' launch counters (on the
    device, added to by the kernels themselves: detection, the small
    eigensolver, the conditional nodes' condition kernel) and the capture
    count to 0."""
    from sdvl_tpu_torch.ops.cuda import detect, graph_if, small_eig

    count_captures()
    detect.reset_launches()
    small_eig.reset_launches()
    graph_if.reset_launches()
    CAPTURES[0] = 0


def side_counts() -> dict:
    """Just after a path was driven: the small eigensolver's launches (both
    kernels, and each), the condition kernel's (one per IF node, if/else
    pair, WHILE node and WHILE iteration that ran) and the if/else pairs
    among them, as the kernels counted them."""
    from sdvl_tpu_torch.ops.cuda import graph_if, small_eig

    return dict(small_eig=small_eig.launches(),
                **{k: small_eig.launches(kernel=k) for k in small_eig.KERNELS},
                conditions=graph_if.launches(), pairs=graph_if.pairs())


def read_counts() -> tuple:
    """Just after a path was driven: (kernel launches as the kernel counted
    them, graph captures)."""
    from sdvl_tpu_torch.ops.cuda import detect

    return detect.launches(), CAPTURES[0]


def frame_launches(launches: int, captures: int) -> int:
    """The launches of a path's frames: those the kernel counted, less the
    eager passes before each capture (each runs the frame's detection
    once)."""
    from sdvl_tpu_torch.pipeline.device_fsm import CAPTURE_PASSES

    return launches - CAPTURE_PASSES * captures


def sync_sites(fn) -> list:
    """Run ``fn()`` under ``set_sync_debug_mode("warn")``; the Python line
    of each synchronisation it made."""
    from sdvl_tpu_torch.utils.trace import sync_sites as sites

    return [os.path.relpath(site, ROOT) for site in sites(fn)]


def run_slam(cfg, frames, rec, time_frames: bool, count_syncs: bool = False,
             graphs: bool = True):
    """One full-SLAM stream over the frames, frame by frame, on the graph
    path (``graphs``) or the eager card path. Returns (result, stream,
    per-frame seconds, per-frame synchronisation sites, (kernel launches,
    graph captures), per-frame graph replays)."""
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    st = SdvlStream(cfg, seed=0, device="cuda", gumbel_provider=slam_draws(rec),
                    graphs=graphs)
    torch.cuda.synchronize()
    seconds, syncs, replays = [], [], []
    reset_counts()
    try:
        for f in frames:
            n0 = st.runner.replays
            t0 = time.perf_counter()
            if count_syncs:
                syncs.append(sync_sites(lambda: st.feed(f)))
            else:
                st.feed(f)
            if time_frames:
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            replays.append(st.runner.replays - n0)
    except Exception:
        if st._rows:
            say("slam", "stopped; first divergence from the JAX record: "
                + first_divergence(st.result(), rec))
        raise
    counts = read_counts()
    st.side_counts = side_counts()
    return st.result(), st, seconds, syncs, counts, replays


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


def per_state(r, values, skip=-1) -> dict:
    """Mean of per-frame ``values`` by :func:`state_groups`, frame ``skip``
    (the graph's capture frame; or a list of frames) left out."""
    v = np.asarray(values, np.float64)
    keep = ~np.isin(np.arange(len(v)), skip)
    return {k: {"frames": int((m & keep).sum()),
                "mean": float(v[m & keep].mean()) if (m & keep).any()
                else None}
            for k, m in state_groups(r).items()}


def capture_frame(replays) -> int:
    """Index of the frame whose step captured the graph (the first replay),
    or -1."""
    return next((i for i, n in enumerate(replays) if n), -1)


def run_slam_phase(card: str) -> dict:
    """Phase 4 (see the module docstring)."""
    from sdvl_tpu_torch.io import evaluate
    from sdvl_tpu_torch.io.snapshot import save_stream_snapshot
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    rec = dict(np.load(SLAM_NPZ))
    t0 = time.perf_counter()
    frames, poses = render_preset_frames(rec)
    n = len(frames)
    say("slam", f"rendered {n} frames at {frames[0].shape} in "
                f"{time.perf_counter() - t0:.1f} s, SHA-256 equal to the "
                f"recorded run's")
    # the record was made with the Pallas kernel's border rule
    cfg = preset_config(localize_only=False, use_pallas_detect=True)

    n_cold = 40
    r0, _, s0, _, _, _ = run_slam(cfg, frames[:n_cold], rec,
                                  time_frames=True)
    c0 = check_slam_run(r0, rec, n_cold)
    say("slam", f"cold run (graph path): first frame {1e3 * s0[0]:.1f} ms, "
                f"{n_cold} frames in {sum(s0):.2f} s; {c0}")
    r, st, secs, sites, (launches, caps), replays = run_slam(
        cfg, frames, rec, time_frames=True, count_syncs=True)
    chk = check_slam_run(r, rec)
    assert chk["tracked_keyframes"], "no keyframe after the bootstrap"
    assert caps == 1 and frame_launches(launches, caps) == n, (
        f"kernel launches {launches} with {caps} captures: one per frame "
        f"({n}) and one per eager pass of the capture expected")
    cap = capture_frame(replays)
    boot = chk["bootstrap_frame"]
    assert cap == 0 and replays == [1] * n, (
        f"graph replays per frame {replays}: the graph captured at frame 0 "
        f"and one replay on every frame expected")
    syncs = [len(x) for x in sites]
    assert not any(syncs[cap + 1:]), (
        f"frames after the capture synchronised: {syncs}; {sites[cap + 1:]}")
    eig = st.side_counts["small_eig"]
    for k, what in (("eigh", "the small eigensolver's eigh"),
                    ("svd3", "the small eigensolver's SVD"),
                    ("conditions", "the conditional nodes' condition")):
        assert st.side_counts[k] > 0, f"the path did not launch {what} kernel"
    second_ms = [1e3 * secs[i] for i in range(cap + 1, n)
                 if r.states[i - 1] == 1]
    steady = [x for i, x in enumerate(secs) if i != cap]
    ms = per_state(r, [1e3 * x for x in secs], skip=cap)
    sy = per_state(r, syncs, skip=cap)
    say("slam", f"states {r.states.tolist()}")
    say("slam", f"keyframes {r.is_keyframe.astype(int).tolist()}")
    say("slam", f"n_matches {r.n_matches.tolist()}")
    say("slam", f"JAX n_matches {rec['jax_n_matches'].tolist()}")
    say("slam", f"warm run (graph path), all {n} frames against the "
                f"record: {chk}; {int(st.m.n_keyframes)} keyframes, "
                f"{int(st.m.pt_valid.sum())} points; kernel launches "
                f"(counted by the kernel) {launches} = 1 x {n} frames + "
                f"{launches - n} in the capture's eager passes")
    say("slam", f"graph replays per frame {replays}: one on every frame, "
                f"FIRST and SECOND included (frame {cap} captured the graph: "
                f"{1e3 * st.runner.capture_s:.1f} ms of warm-up and capture, "
                f"{1e3 * secs[cap]:.1f} ms for the frame; the graph's pool "
                f"holds {st.runner.pool_bytes / 2**20:.1f} MiB); SECOND "
                f"frames after the capture "
                + ", ".join(f"{x:.2f}" for x in second_ms)
                + f" ms; small eigensolver launches {eig}, condition-kernel "
                  f"launches {st.side_counts['conditions']} (if/else pairs "
                  f"{st.side_counts['pairs']})")
    say("slam", f"ms per frame by state (warm, synchronised per frame, "
                f"capture frame apart): "
                + ", ".join(f"{k} {v['mean']:.2f} ({v['frames']} frames)"
                            for k, v in ms.items() if v["frames"])
                + f"; first frame of the cold run {1e3 * s0[0]:.1f} ms; "
                  f"{len(steady) / sum(steady):.3f} frames/s on {card}")
    say("slam", "synchronisations per frame (set_sync_debug_mode), graph "
                "path: "
                + ", ".join(f"{k} {v['mean']:.2f}" for k, v in sy.items()
                            if v["frames"])
                + f"; {syncs}")
    by_site = {i: {x: sites[i].count(x) for x in sorted(set(sites[i]))}
               for i in (0, 1, boot, cap, cap + 5)}
    say("slam", f"where they are, by frame: {by_site}")

    # the port's own map, served
    cfg_loc = preset_config(localize_only=True)
    query = frames[8:32]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slam_map.npz")
        save_stream_snapshot(st, path)
        loc = SdvlStream.localizer(cfg_loc, path, seed=1, device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loc.feed_chunk(np.stack(query), block=True)
        loc_s = time.perf_counter() - t0
        loc_launches, loc_caps = read_counts()
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
    assert loc_caps == 1 and frame_launches(loc_launches, loc_caps) == len(
        query), (loc_launches, loc_caps)
    say("slam", f"served the port's own map: states {rl.states.tolist()}, "
                f"ATE {ate:.5f} over {extent:.4f} ({100 * ate / extent:.2f} "
                f"%), {len(query)} frames in {loc_s:.3f} s, kernel launches "
                f"{loc_launches}")
    return dict(launches=launches, captures=caps, loc_launches=loc_launches,
                loc_captures=loc_caps, pool_bytes=st.runner.pool_bytes,
                side_counts=st.side_counts, second_ms=second_ms,
                loc_frames=len(query), check=chk,
                ms_by_state=ms, syncs_by_state=sy, syncs=syncs,
                replays=replays, capture_frame=cap,
                capture_ms=1e3 * st.runner.capture_s,
                capture_frame_ms=1e3 * secs[cap],
                sync_sites=by_site, first_frame_ms=1e3 * s0[0], frames=n,
                frames_per_s=len(steady) / sum(steady),
                served_ate_pct=100 * ate / extent,
                _rows=torch.stack(st._rows), _secs=secs, _rec=rec,
                _frames=frames, _cfg=cfg)


INFO_COLUMNS = ("pose",) * 7 + ("world_tf",) * 7 + (
    "state", "quality", "n_matches", "n_attempts", "is_keyframe",
    "n_corners", "median_shift")


def replay_profile(st, img, reps: int = 3):
    """Device activity of ``reps`` replays of the stream's graph on frame
    ``img`` (the stream's state moves on: use a stream that is done):
    kernels and copies per replay and device ms per replay, from
    ``torch.profiler``; None where the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = st.runner.graph
    img_in = g.inputs[0]
    img_in.copy_(torch.from_numpy(img).to(img_in.device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            g.graph.replay()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return dict(kernels=(len(dev) - len(copies)) / reps,
                copies=len(copies) / reps,
                device_ms=busy_us / 1e3 / reps)


# record frames the eager card path runs in phases graph and host: the
# bootstrap, tracking and the tracked keyframe at frame 56
EAGER_FRAMES = 60


def run_graph_phase(card: str, slam: dict) -> dict:
    """Phase graph (see the module docstring): the record on the eager card
    path beside phase slam's graph run, and the graph path's steady rate
    with nothing synchronised between frames."""
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    rec, frames, cfg = slam["_rec"], slam["_frames"], slam["_cfg"]
    n = len(frames)
    ne = EAGER_FRAMES
    cap = slam["capture_frame"]
    r, st, secs, sites, (launches, caps), replays = run_slam(
        cfg, frames[:ne], rec, time_frames=True, count_syncs=True,
        graphs=False)
    chk = check_slam_run(r, rec, ne)
    assert launches == ne and caps == 0 and not any(replays), (
        launches, caps, replays)
    syncs = [len(x) for x in sites]
    sy = per_state(r, syncs, skip=cap)
    ms = per_state(r, [1e3 * x for x in secs], skip=cap)
    g_ms = slam["ms_by_state"]
    # the graph path against the eager card path, frame by frame
    rows_g, rows_e = slam["_rows"][:ne], torch.stack(st._rows)
    equal = bool(torch.equal(rows_g, rows_e))
    diff = (rows_g - rows_e).abs()
    cols = {}
    for c, name in enumerate(INFO_COLUMNS):
        d = float(diff[:, c].max())
        if d:
            cols[name] = max(cols.get(name, 0.0), d)
    frames_diff = torch.nonzero(diff.amax(1) > 0).flatten().tolist()
    assert equal, (f"graph path differs from the eager card path in "
                   f"{cols} on frames {frames_diff}")
    # the graph path with nothing synchronised between frames: the bootstrap
    # and the capture first, then the rest dispatched back to back
    ga = SdvlStream(cfg, seed=0, device="cuda",
                    gumbel_provider=slam_draws(rec))
    for f in frames[:cap + 1]:
        ga.feed(f)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for f in frames[cap + 1:]:
        ga.feed(f)
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_async = time.perf_counter() - t0
    n_async = n - cap - 1
    assert read_counts() == (n_async, 0), read_counts()
    check_slam_run(ga.result(), rec)
    prof = replay_profile(ga, frames[-1])
    # replays alone, back to back: how long the host spends in one
    # replay call against the wall time of one replay
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ga.runner.graph.graph.replay()
    t_call = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    slots = [len(ga._uploads._slots), len(ga._noise._uploads._slots)]
    # the graph's pool goes back to the card with the stream
    pool = ga.runner.pool_bytes
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    del ga
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_reserved()
    assert freed >= pool, (
        f"dropping the stream freed {freed} bytes, its graph's pool holds "
        f"{pool}")
    e_steady = [x for i, x in enumerate(secs) if i != cap]
    out = dict(
        frames=n, eager_frames=ne, eager_check=chk, equal_to_eager=equal,
        side_counts=st.side_counts,
        eager_ms_by_state=ms, graph_ms_by_state=g_ms,
        eager_syncs_by_state=sy, graph_syncs_by_state=slam["syncs_by_state"],
        eager_syncs=syncs, graph_replays=slam["replays"],
        capture_ms=slam["capture_ms"],
        eager_frames_per_s=len(e_steady) / sum(e_steady),
        graph_frames_per_s=slam["frames_per_s"],
        graph_async_frames_per_s=n_async / t_async,
        graph_async_host_ms_per_frame=1e3 * t_host / n_async,
        replay_profile=prof, eager_launches=launches,
        replay_call_host_ms=1e3 * t_call / reps,
        replay_wall_ms=1e3 * t_wall / reps, pinned_slots=slots,
        pool_bytes=pool, freed_on_drop_bytes=freed)
    say("graph", f"eager card path (graphs=False), the first {ne} record "
                 f"frames: {chk}")
    say("graph", f"graph path against the eager card path: packed infos of "
                 f"the first {ne} frames bit-identical ({equal})")
    say("graph", "synchronisations per frame by state, graph / eager: "
                 + ", ".join(f"{k} {slam['syncs_by_state'][k]['mean']:.2f} / "
                             f"{v['mean']:.2f}" for k, v in sy.items()
                             if v["frames"]))
    say("graph", f"graph launches per frame {slam['replays']}; the graph "
                 f"was captured at frame {cap} in {slam['capture_ms']:.1f} "
                 f"ms (two eager passes through both sides of every branch, "
                 f"then the capture)")
    say("graph", "ms per frame by state (synchronised per frame), graph / "
                 "eager: "
                 + ", ".join(f"{k} {g_ms[k]['mean']:.2f} / {v['mean']:.2f}"
                             for k, v in ms.items() if v["frames"])
                 + f"; frames/s {out['graph_frames_per_s']:.3f} / "
                   f"{out['eager_frames_per_s']:.3f}")
    say("graph", f"graph path with no synchronisation between frames: "
                 f"{n_async} frames after the capture in {t_async:.3f} s = "
                 f"{out['graph_async_frames_per_s']:.3f} frames/s, the host "
                 f"done after {1e3 * t_host / n_async:.3f} ms per frame")
    say("graph", f"{reps} replays alone, back to back: the host spends "
                 f"{out['replay_call_host_ms']:.3f} ms in a replay call, a "
                 f"replay takes {out['replay_wall_ms']:.3f} ms of wall time; "
                 f"pinned upload slots (image, noise) {slots}")
    say("graph", f"the stream's graph pool holds {pool / 2**20:.1f} MiB "
                 f"(phase slam's: {slam['pool_bytes'] / 2**20:.1f} MiB); "
                 f"dropping the stream gave {freed / 2**20:.1f} MiB back to "
                 f"the card, its pool included")
    say("graph", "one replay of a tracking frame (torch.profiler, "
                 f"{'3 replays' if prof else 'no device activity seen: not measured'}"
                 + (f"): {prof['kernels']:.0f} kernels and {prof['copies']:.0f} "
                    f"copies/memsets, {prof['device_ms']:.3f} ms of device "
                    f"time" if prof else ")") + f" on {card}")
    return out


CHUNK = 16      # frames per chunk of phase chunk


def run_chunk_phase(card: str, slam: dict) -> dict:
    """Phase chunk (see the module docstring): the record frames through
    ``feed_chunk`` from frame 0, against phase slam's per-frame graph run;
    then the chunks after the first dispatched back to back."""
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    rec, frames, cfg = slam["_rec"], slam["_frames"], slam["_cfg"]
    n = len(frames)
    chunks = [np.stack(frames[i:i + CHUNK]) for i in range(0, n, CHUNK)]
    st = SdvlStream(cfg, seed=0, device="cuda",
                    gumbel_provider=slam_draws(rec))
    torch.cuda.synchronize()
    reset_counts()
    secs, syncs, replays, captured = [], [], [], []
    for c in chunks:
        n0, g0 = st.runner.replays, len(st.runner.chunk_graphs)
        t0 = time.perf_counter()
        syncs.append(len(sync_sites(lambda: st.feed_chunk(c))))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        replays.append(st.runner.replays - n0)
        captured.append(len(st.runner.chunk_graphs) > g0)
    launches, caps = read_counts()
    side = side_counts()
    sizes = sorted({len(c) for c in chunks})
    assert replays == [1] * len(chunks), (
        f"replays per chunk {replays}: one per chunk expected")
    assert sorted(st.runner.chunk_graphs) == sizes and st.runner.graph is None
    assert caps == len(sizes) and frame_launches(launches, caps) == n, (
        launches, caps)
    bad = [s for s, c in zip(syncs, captured) if s and not c]
    assert not bad, f"chunks that captured nothing synchronised: {syncs}"
    rows = torch.stack(st._rows)
    equal = bool(torch.equal(rows, slam["_rows"]))
    assert equal, (
        "feed_chunk differs from the per-frame graph path on frames "
        f"{torch.nonzero((rows != slam['_rows']).any(1)).flatten().tolist()}")
    chk = check_slam_run(st.result(), rec)
    steady = [i for i, c in enumerate(captured) if not c]
    ms_frame = [1e3 * secs[i] / len(chunks[i]) for i in steady]
    graphs = st.runner.chunk_graphs
    cap_s = {t: g.capture_s for t, g in graphs.items()}
    pools = {t: g.pool_bytes for t, g in graphs.items()}
    # the chunks after the first, back to back, on a stream of their own
    st2 = SdvlStream(cfg, seed=0, device="cuda",
                     gumbel_provider=slam_draws(rec))
    st2.feed_chunk(chunks[0])
    full = [c for c in chunks[1:] if len(c) == CHUNK]
    torch.cuda.synchronize()
    slots0 = len(st2._uploads._slots) + len(st2._noise._uploads._slots)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(full)
                                                               + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for c, mark in zip(full, marks[1:]):
        st2.feed_chunk(c)
        mark.record()
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    n_b2b = CHUNK * len(full)
    # each chunk's span on the stream, back to back, and the pinned upload
    # slots the ring had to add while chunks were in flight
    b2b_ms = [a.elapsed_time(b) / CHUNK for a, b in zip(marks, marks[1:])]
    new_slots = (len(st2._uploads._slots) + len(st2._noise._uploads._slots)
                 - slots0)
    assert torch.equal(torch.stack(st2._rows),
                       slam["_rows"][:CHUNK * (1 + len(full))])
    del st2
    out = dict(frames=n, chunk=CHUNK, chunks=len(chunks), replays=replays,
               syncs=syncs, captured=captured, launches=launches,
               captures=caps, side_counts=side, equal_to_per_frame=equal,
               check=chk, chunk_s=secs, ms_per_frame=ms_frame,
               capture_s=cap_s, pool_bytes=pools,
               back_to_back_frames_per_s=n_b2b / t_all,
               back_to_back_host_ms_per_frame=1e3 * t_host / n_b2b,
               back_to_back_stream_ms_per_frame=b2b_ms,
               back_to_back_new_pinned_slots=new_slots,
               per_frame_async_frames_per_s=None)
    say("chunk", f"the {n} record frames in chunks of {CHUNK} (the tail "
                 f"{len(chunks[-1])}) from frame 0: one replay per chunk "
                 f"{replays}, synchronisations per chunk {syncs} (a chunk "
                 f"that captures synchronises), every frame's packed info "
                 f"bit-identical to the per-frame graph path; {chk}")
    say("chunk", f"graphs per chunk length {sizes}: warm-up and capture s "
                 + ", ".join(f"{t}: {v:.2f}" for t, v in cap_s.items())
                 + "; pools MiB "
                 + ", ".join(f"{t}: {v / 2**20:.1f}" for t, v in pools.items())
                 + f"; kernel launches {launches} = 1 x {n} frames + "
                   f"{launches - n} in the captures' eager passes; small "
                   f"eigensolver {side['small_eig']}, condition kernel "
                   f"{side['conditions']} (if/else pairs {side['pairs']})")
    say("chunk", "ms per frame of each chunk that captures nothing "
                 "(synchronised per chunk): "
                 + ", ".join(f"{x:.3f}" for x in ms_frame)
                 + f"; {len(full)} chunks of {CHUNK} back to back: "
                   f"{out['back_to_back_frames_per_s']:.3f} frames/s, the "
                   f"host done after {1e3 * t_host / n_b2b:.3f} ms per "
                   f"frame; on the stream (CUDA events between chunks) "
                   + ", ".join(f"{x:.3f}" for x in b2b_ms)
                   + f" ms per frame; {new_slots} pinned upload slots added "
                     f"meanwhile; on {card}")
    return out


STATE_CODES = {"FIRST_FRAME": 0, "SECOND_FRAME": 1, "RUNNING": 2, "LOST": 3}


def graph_replays(slam) -> int:
    """Replays so far of the host driver's stage graphs."""
    return sum(g.replays for g in slam._graphs.values())


def run_host(cfg, frames, rec, graphs: bool):
    """The host driver ``SDVL`` over the frames, frame by frame,
    synchronised and timed per frame, its synchronisations counted. Returns
    (driver, infos, seconds, synchronisation sites, (kernel launches,
    captures of the preprocess graph), graph replays, stage graphs captured)
    per frame."""
    from sdvl_tpu_torch.pipeline.sdvl import SDVL

    slam = SDVL(cfg, seed=0, device="cuda", gumbel_provider=slam_draws(rec),
                graphs=graphs)
    torch.cuda.synchronize()
    infos, seconds, sites, replays, captured = [], [], [], [], []
    reset_counts()
    for f in frames:
        n0, g0 = graph_replays(slam), set(slam._graphs)
        t0 = time.perf_counter()
        sites.append(sync_sites(lambda: infos.append(slam.handle_frame(f))))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        replays.append(graph_replays(slam) - n0)
        captured.append(sorted(set(slam._graphs) - g0))
    counts = read_counts()
    slam.side_counts = side_counts()
    return slam, infos, seconds, sites, counts, replays, captured


def host_result(slam, infos):
    """A host-driver run in the layout ``check_slam_run`` reads: the state
    after each frame, the bootstrap frames' inlier counts as their
    ``n_matches`` (as the stream reports them)."""
    import types

    traj = np.stack([p for _, p in slam.trajectory])
    states = [STATE_CODES[i["state"]] for i in infos[1:]] + [
        slam.state.value]
    return types.SimpleNamespace(
        n_frames=len(infos), poses_raw=traj, trajectory=traj,
        states=np.asarray(states),
        is_keyframe=np.asarray([i["keyframe"] for i in infos]),
        n_matches=np.asarray([i.get("n_inliers", i["n_matches"])
                              for i in infos]))


def packed_host_infos(slam, infos) -> np.ndarray:
    """Each frame's (state, n_matches, n_attempts, keyframe, pose (7,)) and
    its trajectory row: what the driver returned and kept."""
    traj = np.stack([p for _, p in slam.trajectory])
    head = np.asarray([[STATE_CODES[i["state"]], i["n_matches"],
                        i["n_attempts"], i["keyframe"]] for i in infos],
                      np.float64)
    return np.concatenate([head, np.stack([i["pose"] for i in infos]),
                           traj], axis=1)


def run_host_phase(card: str, slam_out: dict) -> dict:
    """Phase host (see the module docstring): the host driver on the 85
    record frames, on the graph path and on the eager card path."""
    rec, frames, cfg = slam_out["_rec"], slam_out["_frames"], slam_out["_cfg"]
    n = len(frames)
    ne = EAGER_FRAMES
    runs = {graphs: run_host(cfg, frames if graphs else frames[:ne], rec,
                             graphs) for graphs in (True, False)}
    out = {}
    g_slam, g_infos, g_secs, g_sites, (g_l, g_c), g_rep, g_cap = runs[True]
    e_slam, e_infos, e_secs, e_sites, (e_l, e_c), e_rep, _ = runs[False]
    r = host_result(g_slam, g_infos)
    chk = check_slam_run(r, rec)
    r_e = host_result(e_slam, e_infos)
    check_slam_run(r_e, rec, ne)
    pg, pe = packed_host_infos(g_slam, g_infos), packed_host_infos(e_slam,
                                                                   e_infos)
    frames_diff = np.nonzero((pg[:ne] != pe).any(1))[0].tolist()
    assert not frames_diff, (
        f"host driver: graph path differs from the eager card path on "
        f"frames {frames_diff}")
    # one read per frame, FIRST and SECOND included, once its stages'
    # graphs exist
    tracking = [i for i, x in enumerate(g_infos)
                if x["state"] in ("RUNNING", "LOST")]
    second = [i for i, x in enumerate(g_infos)
              if x["state"] == "SECOND_FRAME"]
    capture_frames = [i for i, c in enumerate(g_cap) if c]
    g_syncs = [len(x) for x in g_sites]
    e_syncs = [len(x) for x in e_sites]
    steady = [i for i in tracking if i not in capture_frames]
    bad = {i: g_sites[i] for i in range(n)
           if i not in capture_frames and g_syncs[i] != 1}
    assert not bad, f"frames with other than 1 synchronisation: {bad}"
    # tracking: preprocess, track, map stage; SECOND: detection, bootstrap,
    # seed, initial match; FIRST: detection
    assert all(g_rep[i] >= 2 for i in tracking) and all(
        g_rep[i] == 4 for i in second) and all(
        g_rep[i] == 1 for i in range(n) if i not in tracking + second), g_rep
    assert g_c == 2 and frame_launches(g_l, g_c) == n, (g_l, g_c)
    second_steady = [i for i in second if i not in capture_frames]
    assert second_steady, "no SECOND frame replayed without a capture"
    assert e_l == ne and e_c == 0 and not any(e_rep), (e_l, e_c)
    ms_g = per_state(r, [1e3 * x for x in g_secs])
    ms_g_steady = per_state(r, [1e3 * x for x in g_secs],
                            skip=capture_frames)
    ms_e = per_state(r_e, [1e3 * x for x in e_secs])
    sy_g = per_state(r, g_syncs, skip=capture_frames)
    sy_e = per_state(r_e, e_syncs)
    rp = per_state(r, g_rep)
    g_steady = [x for i, x in enumerate(g_secs) if i in steady]
    e_steady = [x for i, x in enumerate(e_secs) if i in steady]
    pools = {k: v.pool_bytes for k, v in g_slam._graphs.items()}
    capture_s = {k: v.capture_s for k, v in g_slam._graphs.items()}
    # the driver's pool goes back to the card with the driver
    pool = g_slam.pool_bytes
    g_side, e_side = g_slam.side_counts, e_slam.side_counts
    del runs, e_slam
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    del g_slam
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_reserved()
    assert freed >= pool, (freed, pool)
    out = dict(frames=n, eager_frames=ne, check=chk, equal_to_eager=True,
               launches=g_l, captures=g_c, eager_launches=e_l,
               side_counts=g_side, eager_side_counts=e_side,
               second_ms=[1e3 * g_secs[i] for i in second_steady],
               second_syncs=[g_syncs[i] for i in second_steady],
               eager_second_ms=[1e3 * e_secs[i] for i in second_steady],
               capture_frames=capture_frames,
               captured={i: g_cap[i] for i in capture_frames},
               syncs=g_syncs, eager_syncs=e_syncs, replays=g_rep,
               syncs_by_state=sy_g, eager_syncs_by_state=sy_e,
               replays_by_state=rp, ms_by_state=ms_g,
               ms_by_state_steady=ms_g_steady, eager_ms_by_state=ms_e,
               frames_per_s=len(g_steady) / sum(g_steady),
               eager_frames_per_s=len(e_steady) / sum(e_steady),
               pool_bytes=pool, pool_bytes_by_stage=pools,
               capture_s_by_stage=capture_s, freed_on_drop_bytes=freed)

    def fmt(d):
        return ", ".join(f"{k} {v['mean']:.2f}" for k, v in d.items()
                         if v["frames"])

    say("host", f"SDVL on the {n} record frames, graph path, held to the "
                f"JAX record: {chk}")
    say("host", f"graph path against the eager card path (graphs=False): "
                f"states, match counts, keyframe flags, poses and trajectory "
                f"of the first {ne} frames bit-identical")
    say("host", f"stage graphs captured at frames "
                + ", ".join(f"{i}: {g_cap[i]}" for i in capture_frames)
                + "; warm-up and capture s "
                + ", ".join(f"{k} {v:.2f}" for k, v in capture_s.items()))
    say("host", f"synchronisations per frame by state, graph (capture "
                f"frames apart) / eager: {fmt(sy_g)} / {fmt(sy_e)}; "
                f"{g_syncs}")
    say("host", f"graph replays per frame by state: {fmt(rp)}; {g_rep}")
    say("host", f"ms per frame by state (synchronised per frame), graph "
                f"(capture frames apart) / eager: {fmt(ms_g_steady)} / "
                f"{fmt(ms_e)}; tracking frames/s {out['frames_per_s']:.3f} / "
                f"{out['eager_frames_per_s']:.3f} on {card}")
    say("host", f"SECOND frames replayed without a capture (frames "
                f"{second_steady}): "
                + ", ".join(f"{x:.2f}" for x in out["second_ms"])
                + f" ms, synchronisations {out['second_syncs']}; eager "
                + ", ".join(f"{x:.2f}" for x in out["eager_second_ms"])
                + " ms")
    say("host", f"kernel launches (counted by the kernel) {g_l} = 1 x {n} "
                f"frames + {g_l - n} in the detection and preprocess "
                f"graphs' captures; eager {e_l}; small eigensolver "
                f"{g_side['small_eig']} (eager {e_side['small_eig']})")
    say("host", f"the driver's stage graphs share one pool: "
                f"{pool / 2**20:.1f} MiB ("
                + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in pools.items())
                + f" MiB); dropping the driver gave {freed / 2**20:.1f} MiB "
                  f"back to the card")
    return out


def run_slice(cfg, query, count_launches: bool, graphs: bool = True):
    """One localizer run over the query frames, on the graph path
    (``graphs``) or the eager card path. Returns (result, seconds,
    (kernel launches, graph captures), stream)."""
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    gumbel = query["gumbel"]
    loc = SdvlStream.localizer(cfg, MAP_NPZ, seed=1, device="cuda",
                               gumbel_provider=lambda i: gumbel[i],
                               graphs=graphs)
    before = [t.clone() for t in map_leaves(loc.m)]
    torch.cuda.synchronize()
    if count_launches:
        reset_counts()
    t0 = time.perf_counter()
    loc.feed_chunk(query["frames"], block=True)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    r = loc.result()
    after = map_leaves(loc.m)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b), "map changed"
    return r, seconds, counts, loc


def slice_syncs(cfg, query, graphs: bool) -> tuple:
    """The localizer over the query frames one ``feed`` at a time, each
    under ``set_sync_debug_mode("warn")``. Returns (synchronisations per
    frame, graph replays per frame, packed infos)."""
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    gumbel = query["gumbel"]
    loc = SdvlStream.localizer(cfg, MAP_NPZ, seed=1, device="cuda",
                               gumbel_provider=lambda i: gumbel[i],
                               graphs=graphs)
    syncs, replays = [], []
    for f in query["frames"]:
        n0 = loc.runner.replays
        syncs.append(len(sync_sites(lambda: loc.feed(f))))
        replays.append(loc.runner.replays - n0)
    torch.cuda.synchronize()
    return syncs, replays, torch.stack(loc._rows)


# ---------------------------------------------------------------- multi
MULTI_STREAMS = (1, 4, 8)
MULTI_CHUNK = 8          # frames per feed_chunk of the frozen-map runs
SLAM_CHUNK = 17          # of the 2 SLAM streams' 85 frames
# the same runs with a CUDA graph per stream (the design before the batch
# graphs): per-frame stream-frames/s over three runs, and the streams'
# pools in MiB, on NVIDIA H100 80GB HBM3, 700.00 W
PER_STREAM_GRAPHS = {1: ("38.089-48.194", 170.0),
                     4: ("38.452-48.525", 4 * 170.0),
                     8: ("38.199-48.229", 8 * 170.0), "slam": 2 * 2886.0}


def sync(device: str = "cuda") -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def mib(n) -> float:
    return round((n or 0) / 2**20, 1)


def secs(by_graph: dict) -> dict:
    return {k: round(v, 2) for k, v in by_graph.items()}


def feed_multi(ms, batches, chunk, device: str = "cuda") -> dict:
    """Feed ``batches`` (T, N, H, W) to ``ms``: one frame batch per
    ``feed`` (``chunk`` None) or ``chunk`` frames per ``feed_chunk``. The
    first call captures its graph (timed alone); the others are counted
    for synchronisations (on the card) and timed together. Returns the
    first call's seconds, the later calls' seconds and stream-frames, and
    their synchronisations, with the device's peak memory over the run."""
    step = 1 if chunk is None else chunk
    calls = [batches[i:i + step] for i in range(0, len(batches), step)]
    feed = (lambda b: ms.feed(b[0])) if chunk is None else ms.feed_chunk
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feed(calls[0])
    sync(device)
    first_s = time.perf_counter() - t0
    syncs = []
    t0 = time.perf_counter()
    for b in calls[1:]:
        if device == "cuda":
            syncs.append(len(sync_sites(lambda: feed(b))))
        else:
            feed(b)
    sync(device)
    return dict(first_s=first_s, seconds=time.perf_counter() - t0,
                later=ms.n * step * (len(calls) - 1), calls=len(calls),
                syncs=syncs, peak_mib=mib(torch.cuda.max_memory_allocated())
                if device == "cuda" else None)


def run_multi_frozen(cfg, query, n_streams: int, device: str = "cuda",
                     chunk=None) -> dict:
    """``MultiStream`` serving the JAX-built map to ``n_streams`` streams,
    every stream fed the query frames, stream ``i`` seeded ``1 + i`` and
    lane 0 fed the recorded pose noise, through :func:`feed_multi`. Checks
    the map bit-identical. Adds the results, the packed rows, (kernel
    launches, graph captures), the batch graphs' replays, capture seconds
    and pool bytes and, for chunks on the card, the device ms per
    stream-frame of a chunk replay (CUDA events)."""
    from sdvl_tpu_torch.dist.multi_stream import MultiStream

    gumbel = query["gumbel"]
    ms = MultiStream(cfg, n_streams, seed=1, frozen_map=MAP_NPZ,
                     device=device,
                     gumbel_providers=[gumbel.__getitem__]
                     + [None] * (n_streams - 1))
    before = [t.clone() for t in map_leaves(ms.m)]
    batch = np.repeat(query["frames"][:, None], n_streams, axis=1)
    sync(device)
    reset_counts()
    run = feed_multi(ms, batch, chunk, device)
    counts = read_counts()
    after = map_leaves(ms.m)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b), "shared map changed"
    device_ms = None
    if device == "cuda" and chunk is not None:
        # the chunk graph once more on its last inputs: one submission, so
        # the events time the device (the carries move on; the map is
        # never written)
        g = ms.batch_graphs[f"batch_chunk_{chunk}"].graph
        device_ms = replay_ms_per(g, n_streams * chunk, reps=3)
    return dict(run, results=ms.result(), rows=torch.cat(ms._rows),
                counts=counts, replays=ms.replays, capture_s=ms.capture_s,
                pool_bytes=ms.pool_bytes, device_ms=device_ms)


def run_multi_phase(card: str, slice_result, query, device: str = "cuda",
                    streams=MULTI_STREAMS, slam_frames=None) -> dict:
    """Phase 6 (see the module docstring); ``slam_frames`` cuts the SLAM
    streams' frames (a rehearsal on the CPU)."""
    from sdvl_tpu_torch.dist.multi_stream import MultiStream
    from sdvl_tpu_torch.pipeline.device_fsm import CAPTURE_PASSES

    out = {}
    cfg = preset_config()
    T = len(query["frames"])
    c_slice = camera_centres(slice_result.trajectory)
    extent = float(np.linalg.norm(np.ptp(
        camera_centres(query["poses_gt"]), axis=0)))
    for n in streams:
        runs = {}
        for chunk in (None, MULTI_CHUNK):
            r = runs[chunk] = run_multi_frozen(cfg, query, n, device, chunk)
            launches, caps = r["counts"]
            graph = ("batch_frame" if chunk is None
                     else f"batch_chunk_{chunk}")
            # one graph over all streams: its capture's eager passes step
            # every stream once each
            assert device != "cuda" or (
                caps == 1
                and launches - CAPTURE_PASSES * n * caps == n * T), (
                f"{launches} launches with {caps} captures: {n} x {T} "
                f"frames and {n} per eager pass of one capture expected")
            assert device != "cuda" or r["replays"] == {graph: r["calls"]}, (
                f"replays {r['replays']}: one per call ({r['calls']}) "
                f"expected")
            assert not any(r["syncs"]), f"calls synchronised: {r['syncs']}"
            results = r["results"]
            for i, res in enumerate(results):
                running = res.states == 2
                assert np.isfinite(res.poses_raw).all(), (
                    f"stream {i}: non-finite")
                assert int(np.argmax(running)) <= 5 and running[-5:].all(), (
                    f"N={n} stream {i}: states {res.states.tolist()}")
            r["lane0_vs_slice_centre"] = float(np.abs(
                camera_centres(results[0].trajectory) - c_slice).max())
            assert (results[0].states == slice_result.states).all(), (
                results[0].states.tolist(), slice_result.states.tolist())
            assert r["lane0_vs_slice_centre"] <= 1e-4 * extent, (
                r["lane0_vs_slice_centre"], extent)
            key = f"multi_{n}" if chunk is None else f"multi_chunk_{n}"
            out[key] = dict(
                streams=n, frames=n * T, launches=launches, captures=caps,
                replays=r["replays"], calls=r["calls"],
                capture_s=r["capture_s"], first_call_s=r["first_s"],
                pool_bytes=r["pool_bytes"],
                pool_mib=mib(sum(r["pool_bytes"].values())),
                peak_mib=r["peak_mib"], seconds=r["seconds"],
                syncs_per_call=r["syncs"],
                frames_per_s=r["later"] / r["seconds"],
                ms_per_stream_frame=1e3 * r["seconds"] / r["later"],
                device_ms_per_stream_frame=r["device_ms"],
                lane0_vs_slice_centre=r["lane0_vs_slice_centre"])
        rows_equal = torch.equal(runs[None]["rows"],
                                 runs[MULTI_CHUNK]["rows"])
        assert rows_equal, "chunked rows differ from the per-frame ones"
        f, c = out[f"multi_{n}"], out[f"multi_chunk_{n}"]
        before_rate, before_pool = PER_STREAM_GRAPHS.get(
            n, ("not measured", "not measured"))
        dev_ms = c["device_ms_per_stream_frame"]
        say("multi", f"frozen JAX map, {n} streams x {T} frames, batch "
                     f"graphs over all streams: every stream RUNNING within "
                     f"5 frames and on the last 5, map bit-identical, lane "
                     f"0 equal to phase slice (centres within "
                     f"{f['lane0_vs_slice_centre']:.3g} of extent "
                     f"{extent:.4f}), chunked rows bit-identical to the "
                     f"per-frame ones. feed: {f['launches']} kernel "
                     f"launches, {f['captures']} capture "
                     f"({secs(f['capture_s'])}), replays {f['replays']} in "
                     f"{f['calls']} feeds (1 a feed), synchronisations "
                     f"after the capture {sum(f['syncs_per_call'])}, "
                     f"{f['frames_per_s']:.3f} stream-frames/s after the "
                     f"first batch. feed_chunk of {MULTI_CHUNK}: "
                     f"{c['launches']} launches, {c['captures']} capture "
                     f"({secs(c['capture_s'])}), replays {c['replays']} in "
                     f"{c['calls']} chunks (1 a chunk), synchronisations "
                     f"{sum(c['syncs_per_call'])}, {c['frames_per_s']:.3f} "
                     f"stream-frames/s after the first chunk, device "
                     + ("not measured" if dev_ms is None
                        else f"{dev_ms:.3f}")
                     + f" ms per stream-frame in a chunk replay. Shared "
                     f"pool {f['pool_mib']} + {c['pool_mib']} MiB (peak "
                     f"allocated {f['peak_mib']}, {c['peak_mib']} MiB). A "
                     f"graph per stream: {before_rate} stream-frames/s, "
                     f"pools {before_pool} MiB. On {card}")

    # two full-SLAM streams with their own maps, lane 0 on the record
    rec = dict(np.load(SLAM_NPZ))
    frames, _ = render_preset_frames(rec)
    frames = frames[:slam_frames]
    chunk = SLAM_CHUNK if len(frames) % SLAM_CHUNK == 0 else len(frames)
    cfg_slam = preset_config(localize_only=False, use_pallas_detect=True)
    ms = MultiStream(cfg_slam, 2, seed=0, device=device,
                     gumbel_providers=[slam_draws(rec), None])
    sync(device)
    reset_counts()
    run = feed_multi(ms, np.repeat(np.stack(frames)[:, None], 2, axis=1),
                     chunk, device)
    launches, caps = read_counts()
    r0, r1 = ms.result()
    chk = check_slam_run(r0, rec, len(frames))
    assert device != "cuda" or (
        caps == 1
        and launches - CAPTURE_PASSES * 2 * caps == 2 * len(frames)), (
        launches, caps)
    run1 = r1.states == 2
    assert run1.any() and run1[int(np.argmax(run1)):].all(), (
        r1.states.tolist())
    replays = ms.replays
    assert device != "cuda" or replays == {
        f"batch_chunk_{chunk}": run["calls"]}, replays
    assert not any(run["syncs"]), f"chunks synchronised: {run['syncs']}"
    pool = mib(sum(ms.pool_bytes.values()))
    rate = run["later"] / run["seconds"] if run["later"] else None
    out["multi_slam"] = dict(streams=2, frames=2 * len(frames),
                             launches=launches, captures=caps,
                             replays=replays, calls=run["calls"],
                             capture_s=ms.capture_s,
                             first_call_s=run["first_s"],
                             pool_bytes=ms.pool_bytes, pool_mib=pool,
                             peak_mib=run["peak_mib"],
                             syncs_per_call=run["syncs"],
                             seconds=run["seconds"], frames_per_s=rate,
                             lane0=chk)
    say("multi", f"2 full-SLAM streams x {len(frames)} record frames, a map "
                 f"each, in chunks of {chunk}: lane 0 against the JAX "
                 f"record {chk}; lane 1 (own draws) RUNNING from frame "
                 f"{int(np.argmax(run1))} to the end; kernel launches "
                 f"{launches} = 2 x {len(frames)} + "
                 f"{launches - 2 * len(frames)} in the capture's eager "
                 f"passes, replays {replays} in {run['calls']} chunks (1 a "
                 f"chunk), capture {secs(ms.capture_s)}, synchronisations after "
                 f"it {sum(run['syncs'])}, shared pool {pool} MiB (a graph "
                 f"per stream: {PER_STREAM_GRAPHS['slam']} MiB), peak "
                 f"allocated {run['peak_mib']} MiB; "
                 + ("no chunk after the first" if rate is None
                    else f"{rate:.3f} stream-frames/s after the first chunk")
                 + f" on {card}")
    return out


# ------------------------------------------------------------------ cli
TUM_F1_CFG = os.path.join(ROOT, "configs", "tum_f1.cfg")
CLI_FRAMES = 85
CLI_RESUME_FRAMES = 6
CLI_QUERY = (8, 32)          # frames served by the localizer run
MATCHES = re.compile(r"matches\s+(\d+)/\s*(\d+)")


def lens_scene(cfg_path: str):
    """(camera config, ``PlaneScene`` seen through it: the port's
    ``io/synthetic.py`` with the config's size, intrinsics and d1..d5, the
    plane at z = 4)."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene
    from sdvl_tpu_torch.pipeline.config import load_cfg

    c = load_cfg(cfg_path).camera
    return c, PlaneScene(fx=c.fx, fy=c.fy, cx=c.u0, cy=c.v0, width=c.width,
                         height=c.height, plane_z=4.0, dist=c.dist)


def write_cli_sequence(cfg_path: str, out_dir: str, n: int = CLI_FRAMES,
                       extra: int = CLI_RESUME_FRAMES, amp: float = 1.0):
    """``n + extra`` ``PlaneScene`` frames along its trajectory at
    translation amplitude ``amp``, rendered by the port's
    ``io/synthetic.py`` through the lens of ``cfg_path`` (its size,
    intrinsics and d1..d5), written as binary PGM files, with image lists
    ``files.txt`` (the run's ``n``), ``resume.txt`` (the frames after it)
    and ``query.txt`` (``CLI_QUERY``). Returns the ground-truth poses and
    the uint8 frames."""
    c, scene = lens_scene(cfg_path)
    poses = np.stack(scene.trajectory(n + extra, translation_amp=amp))
    names = [f"frame_{i:04d}.pgm" for i in range(n + extra)]
    frames = []
    for name, p in zip(names, poses):
        frames.append(np.clip(scene.render(p), 0, 255).astype(np.uint8))
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (c.width, c.height)
                    + frames[-1].tobytes())
    lists = {"files.txt": names[:n],
             "resume.txt": names[n:],
             "query.txt": names[CLI_QUERY[0]:CLI_QUERY[1]]}
    for fname, rows in lists.items():
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write("\n".join(rows) + "\n")
    return poses, frames


def timed_global_ba(m, intr, graphs: bool, device: str = "cuda",
                    mesh=None) -> dict:
    """``mapper.global_ba(m, intr, mesh=mesh, graphs=graphs)``, synchronised
    and timed, its synchronisations counted (on the card). Returns the new
    map, the
    ms, the synchronisation sites, the CG iterations of each LM step and,
    on the graph path, the graph's warm-up and capture seconds, its pool
    and its replays."""
    from sdvl_tpu_torch.pipeline import mapper

    stats, res = {}, []
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = lambda: res.append(mapper.global_ba(  # noqa: E731
        m, intr, mesh=mesh, graphs=graphs, stats=stats))
    sites = sync_sites(run) if device == "cuda" else run() or []
    if device == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    out = dict(map=res[0], ms=ms, sync_sites=sites,
               cg_iterations=stats["cg_iterations"].tolist())
    if graphs:
        out.update(capture_s=stats["capture_s"], pool_bytes=stats[
            "pool_bytes"], replays=stats["replays"],
            replay_ms=ms - 1e3 * stats["capture_s"])
    return out


def run_cli(argv, device: str = "cuda") -> dict:
    """``sdvl_tpu_torch.cli.run.main(argv)`` in process, its standard output
    captured. Counts the detection kernel's launches, the synchronisations
    inside each frame's call (``feed`` / ``handle_frame``, through
    ``set_sync_debug_mode`` on the card) and records what the end-of-run
    global BA saw: the trajectory and map before it, the trajectory after,
    its time and the PCG iterations of each LM step."""
    import io
    from unittest import mock

    from sdvl_tpu_torch.cli import run as cli
    from sdvl_tpu_torch.pipeline import mapper, runtime
    from sdvl_tpu_torch.pipeline.sdvl import SDVL
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    on_card = device == "cuda"
    rec = {"frame_syncs": [], "mappers": [], "sync_sites": {},
           "frame_replays": [], "frame_captures": [], "stream_replays": []}
    caught = []

    def graphs(drv):
        """(stage graphs, their replays) of a host driver and its mapper."""
        if not isinstance(drv, SDVL):
            return 0, 0
        gs = list(drv._graphs.values())
        if drv._async_mapper is not None:
            gs += list(drv._async_mapper._graphs.values())
        return len(gs), sum(g.replays for g in gs)

    def counted(fn):
        def wrapper(self, *a, **k):
            rec["driver"] = self
            n0 = len(caught)
            c0, r0 = graphs(self)
            s0 = self.runner.replays if isinstance(self, SdvlStream) else 0
            out = fn(self, *a, **k)
            c1, r1 = graphs(self)
            rec["frame_captures"].append(c1 - c0)
            rec["frame_replays"].append(r1 - r0)
            if isinstance(self, SdvlStream):
                rec["stream_replays"].append(self.runner.replays - s0)
            new = [w for w in caught[n0:] if "synchroniz" in str(w.message)]
            rec["frame_syncs"].append(len(new))
            for w in new:
                site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                rec["sync_sites"][site] = rec["sync_sites"].get(site, 0) + 1
            return out
        return wrapper

    apply_gba = cli._apply_global_ba

    def recorded_gba(slam, cfg, traj, traj_ids):
        if isinstance(slam, SdvlStream):
            rec["result"] = slam.result()
        rec["map_before"] = slam.m
        rec["traj_before"] = np.array(traj, copy=True)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = {}
        gba = mapper.global_ba
        with mock.patch.object(mapper, "global_ba", lambda *a, **k: gba(
                *a, stats=stats, **k)):
            out = apply_gba(slam, cfg, traj, traj_ids)
        if on_card:
            torch.cuda.synchronize()
        rec["gba_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["cg_iterations"] = stats["cg_iterations"].tolist()
        rec["gba_graph"] = {k: stats.get(k) for k in (
            "capture_s", "pool_bytes", "replays")}
        return out

    class RecordedMapper(runtime.AsyncMapper):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["mappers"].append(self)

        def stop(self):
            # stopping drops the graphs: their pools, before
            rec["pool_bytes"] = self.slam.pool_bytes
            rec["mapper_pool_bytes"] = self.pool_bytes
            super().stop()

    buf = io.StringIO()
    reset_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            SdvlStream, "feed", counted(SdvlStream.feed)))
        stack.enter_context(mock.patch.object(
            SDVL, "handle_frame", counted(SDVL.handle_frame)))
        stack.enter_context(mock.patch.object(cli, "_apply_global_ba",
                                              recorded_gba))
        stack.enter_context(mock.patch.object(runtime, "AsyncMapper",
                                              RecordedMapper))
        caught = stack.enter_context(warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        stack.enter_context(contextlib.redirect_stdout(buf))
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, 0)
        t0 = time.perf_counter()
        rc = cli.main(["--device", device, *argv])
        rec["wall_s"] = time.perf_counter() - t0
    assert rc == 0, rc
    drv = rec.pop("driver", None)
    if isinstance(drv, SDVL):
        rec.setdefault("pool_bytes", drv.pool_bytes)
    elif drv is not None and drv.runner.graph is not None:
        rec["pool_bytes"] = drv.runner.pool_bytes
    del drv
    rec["launches"], rec["captures"] = read_counts()
    rec["frame_launches"] = frame_launches(rec["launches"], rec["captures"])
    rec["lines"] = buf.getvalue().splitlines()
    summaries = [json.loads(ln) for ln in rec["lines"] if ln.startswith("{")]
    assert len(summaries) == 1, rec["lines"][-20:]
    rec["summary"] = summaries[0]
    rec["syncs"] = sum(1 for w in caught if "synchroniz" in str(w.message))
    frame_lines = [ln for ln in rec["lines"]
                   if ln.startswith("[INFO] frame ")]
    rec["states"] = [ln.split()[3] for ln in frame_lines]
    rec["n_matches"] = [int(MATCHES.search(ln).group(1))
                        for ln in frame_lines]
    return rec


def tum_rows(path: str, n: int) -> np.ndarray:
    rows = np.loadtxt(path, ndmin=2)
    assert rows.shape == (n, 8), rows.shape
    assert np.isfinite(rows).all(), "non-finite trajectory row"
    return rows


def tum_from_poses(poses: np.ndarray) -> np.ndarray:
    """World->cam poses (N, 7) as TUM columns tx ty tz qx qy qz qw."""
    from sdvl_tpu_torch.core import se3

    inv = se3.inverse(torch.from_numpy(np.asarray(poses, np.float32)))
    inv = inv.numpy()
    return np.concatenate([inv[:, 4:], inv[:, 1:4], inv[:, :1]], axis=1)


def sim3_ate_pct(centres: np.ndarray, poses_gt: np.ndarray) -> float:
    """Sim(3)-aligned ATE of camera centres in % of the ground truth's
    extent."""
    gt = camera_centres(poses_gt)
    extent = float(np.linalg.norm(np.ptp(gt, axis=0)))
    return 100.0 * umeyama_ate(np.asarray(centres, np.float64), gt) / extent


def pad_keyframe_slots(m, n_slots: int):
    """The map with its keyframe capacity raised to ``n_slots`` (new slots
    empty, as ``empty_map`` makes them)."""
    from sdvl_tpu_torch.state.map_state import empty_map

    K, P, C = m.capacities
    levels = len(m.kf_pyr)
    H, W = m.kf_pyr[0].shape[1:]
    e = empty_map(n_kf=n_slots - K, n_pts=P, n_cand=C, img_shape=(H, W),
                  levels=levels, device=m.kf_pose.device)
    kf_fields = ("kf_pose", "kf_valid", "kf_frame_id", "obs_mask", "obs_px",
                 "obs_level")
    out = {f: torch.cat([getattr(m, f), getattr(e, f)]) for f in kf_fields}
    out["kf_pyr"] = tuple(torch.cat([a, b]) for a, b in zip(m.kf_pyr,
                                                             e.kf_pyr))
    return m._replace(**out)


def tracking_syncs(rec) -> list:
    """The synchronisations of each tracking (RUNNING or LOST) frame of a
    host-driver CLI run that captured no graph."""
    return [n for st, n, c in zip(rec["states"], rec["frame_syncs"],
                                  rec["frame_captures"])
            if st in ("RUNNING", "LOST") and not c]


def per_frame(rec, card: str) -> str:
    s = rec["summary"]
    n = len(rec["frame_syncs"])
    sites = sorted(rec["sync_sites"].items(), key=lambda kv: -kv[1])
    graphs = ""
    if any(rec["frame_captures"]):
        pools = rec.get("pool_bytes", 0) + rec.get("mapper_pool_bytes", 0)
        graphs = (f"; {np.mean(rec['frame_replays']):.2f} stage graph "
                  f"replays per frame, {sum(rec['frame_captures'])} stage "
                  f"graphs captured at frames "
                  f"{np.nonzero(rec['frame_captures'])[0].tolist()}, pools "
                  f"{rec.get('pool_bytes', 0) / 2**20:.1f} MiB (tracker) + "
                  f"{rec.get('mapper_pool_bytes', 0) / 2**20:.1f} MiB "
                  f"(mapper) = {pools / 2**20:.1f} MiB")
    return (f"{s['fps']} frames/s, {s['mean_ms']} ms per frame (the CLI's "
            f"steady-state numbers), {rec['wall_s']:.1f} s in all; "
            f"{np.mean(rec['frame_syncs']):.2f} synchronisations per frame "
            f"({sum(rec['frame_syncs'])} in {n} frames, {rec['syncs']} in "
            f"the whole run; by site {dict(sites[:8])}); detection kernel "
            f"{rec['launches']} launches in {n} frames and "
            f"{rec['captures']} captures of a graph that holds it"
            f"{graphs}; on {card}")


CLI_VIZ_FRAMES = 30
CLI_VIZ_EVERY = 10


def decode_png(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG (the port's ``viz.recorder.save_png`` writes
    these) as a uint8 array, through the port's native loader where it
    loads (gray, float32), else read here: chunks checked by CRC, the zlib
    stream inflated, every row's filter type 0."""
    import struct
    import zlib

    from sdvl_tpu_torch.io import native_loader

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG"
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc, f"{path}: CRC"
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = head[:4]
    if native_loader.ensure_built():
        loader = native_loader.NativeFrameLoader([path], w, h)
        try:
            img = next(iter(loader))
        finally:
            loader.close()
        return np.round(img).astype(np.uint8)
    assert depth == 8 and color in (0, 2), f"{path}: {head}"
    ch = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    assert (raw[:, 0] == 0).all(), f"{path}: filtered rows"
    return raw[:, 1:].reshape(h, w, ch).squeeze(-1) if ch == 1 else \
        raw[:, 1:].reshape(h, w, ch)


def run_cli_viz(cfg_path: str, seq_dir: str, host_run: dict, device: str,
                card: str) -> dict:
    """``--viz DIR --viz-every 10`` on the host driver over the first
    ``CLI_VIZ_FRAMES`` frames: every PNG exists and decodes (the port's
    native loader), and the frames the recorder skips synchronise exactly as
    the same frames of ``host_run`` (the host driver without ``--viz``).
    Without matplotlib the run must stop before its first frame with an
    error naming it; the recorder then runs with its map figures off (the
    overlays still record on the card)."""
    from unittest import mock

    import sdvl_tpu_torch.viz as viz
    from sdvl_tpu_torch.io import native_loader
    from sdvl_tpu_torch.viz import scene

    out_dir = os.path.join(seq_dir, "viz")
    argv = ["--config", cfg_path, "--images", seq_dir, "--max-frames",
            str(CLI_VIZ_FRAMES), "--viz", out_dir, "--viz-every",
            str(CLI_VIZ_EVERY), "--quiet"]
    have_mpl = True
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        have_mpl = False
    patches = contextlib.ExitStack()
    if not have_mpl:
        reset_counts()
        try:
            run_cli(argv, device)
        except RuntimeError as e:
            assert "matplotlib" in str(e), e
        else:
            raise AssertionError("--viz ran without matplotlib")
        assert read_counts() == (0, 0) and not os.path.exists(out_dir)
        say("cli", "matplotlib is not installed: --viz stopped before the "
                   "first frame with an error naming it (checked); the "
                   "recorder runs on with its map figures off")
        patches.enter_context(mock.patch.object(scene, "require_matplotlib",
                                                lambda: None))
        patches.enter_context(mock.patch.object(
            viz, "VizRecorder",
            lambda *a, **k: viz.recorder.VizRecorder(*a, maps=False, **k)))
    with patches:
        rv = run_cli(argv, device)
    assert device != "cuda" or rv["frame_launches"] == CLI_VIZ_FRAMES, rv[
        "launches"]
    names = sorted(os.listdir(out_dir))
    recorded = [i for i in range(CLI_VIZ_FRAMES) if i % CLI_VIZ_EVERY == 0]
    overlays = [n for n in names if n.startswith("frame_")]
    maps = [n for n in names if n.startswith("map_")]
    assert overlays, names
    assert len(maps) == (len(recorded) if have_mpl else 0), names
    from sdvl_tpu_torch.pipeline.config import load_cfg
    from sdvl_tpu_torch.pipeline.device_fsm import cropped_shape

    crop = cropped_shape(load_cfg(cfg_path))
    for name in overlays:
        img = decode_png(os.path.join(out_dir, name))
        assert img.shape[:2] == crop, (name, img.shape)
    for name in maps:
        assert decode_png(os.path.join(out_dir, name)).size > 0, name
    decoder = ("the native loader" if native_loader.ensure_built()
               else "zlib (native loader: " + native_loader.build_error()
               + ")")
    skipped = [i for i in range(CLI_VIZ_FRAMES) if i % CLI_VIZ_EVERY]
    s_viz = [rv["frame_syncs"][i] for i in skipped]
    s_ref = [host_run["frame_syncs"][i] for i in skipped]
    assert s_viz == s_ref, (s_viz, s_ref)
    rec_syncs = [rv["frame_syncs"][i] for i in recorded]
    say("cli", f"run 3b, host driver --viz --viz-every {CLI_VIZ_EVERY} over "
               f"{CLI_VIZ_FRAMES} frames: {len(overlays)} overlays, "
               f"{len(maps)} map figures, every PNG decodes ({decoder}); "
               f"synchronisations on the {len(skipped)} frames it "
               f"skips equal the run without --viz ({sum(s_viz)} in all); "
               f"on the recorded frames {rec_syncs} against "
               f"{[host_run['frame_syncs'][i] for i in recorded]}; "
               f"matplotlib present: {have_mpl}; " + per_frame(rv, card))
    return dict(summary=rv["summary"], launches=rv["launches"],
                captures=rv["captures"],
                frames=CLI_VIZ_FRAMES, overlays=len(overlays),
                map_figures=len(maps), matplotlib=have_mpl,
                skipped_frame_syncs=sum(s_viz),
                recorded_frame_syncs=rec_syncs)


def run_dist_phase(card: str, m100, device: str = "cuda",
                   cfg_path: str = TUM_F1_CFG) -> dict:
    """Phase 8 (see the module docstring): ``global_ba(mesh=...)`` on nccl
    at world size 1, as one graph replay and eagerly (``graphs=False``),
    against ``global_ba()`` (one process, one replay), on the cli phase's
    100-slot map (Cholesky) and on it padded to the shipped 1000 slots
    (PCG); in turns, one process, eager mesh, mesh graph, mesh graph,
    eager mesh, one process."""
    import socket

    import torch.distributed as tdist

    from sdvl_tpu_torch.dist import multihost
    from sdvl_tpu_torch.pipeline.config import intrinsics, load_cfg

    intr = intrinsics(load_cfg(cfg_path))
    K = load_cfg(cfg_path).sdvl.max_keyframes
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    backend = multihost.initialize(
        f"127.0.0.1:{port}", 1, 0,
        backend="nccl" if device == "cuda" else "gloo")
    out = {"backend": backend, "world_size": multihost.process_count()}
    on_card = device == "cuda"
    try:
        mesh = multihost.global_mesh("point")
        for name, m in (("chol_100", m100),
                        ("cg_1000", pad_keyframe_slots(m100, K))):
            runs = {"one": [], "mesh_eager": [], "mesh_graph": []}
            for kind in ("one", "mesh_eager", "mesh_graph", "mesh_graph",
                         "mesh_eager", "one"):
                runs[kind].append(timed_global_ba(
                    m, intr, graphs=on_card and kind != "mesh_eager",
                    device=device, mesh=None if kind == "one" else mesh))
            g, e, b = (runs[k][0] for k in ("mesh_graph", "mesh_eager",
                                            "one"))
            kv, pv = b["map"].kf_valid, b["map"].pt_valid
            diffs = {}
            for ref_name, ref in (("one", b), ("mesh_eager", e)):
                for kind, got in (("mesh_graph", g), ("mesh_eager", e)):
                    if kind == ref_name:
                        continue
                    a, r = got["map"], ref["map"]
                    d_pose = float((a.kf_pose - r.kf_pose)[kv].abs().max())
                    d_pt = float((a.pt_pos - r.pt_pos)[pv].abs().max())
                    same_obs = bool(torch.equal(a.obs_mask, r.obs_mask))
                    assert d_pose <= 5e-4 and d_pt <= 5e-3 and same_obs, (
                        name, kind, ref_name, d_pose, d_pt, same_obs)
                    diffs[f"{kind}_vs_{ref_name}"] = dict(
                        pose_diff=d_pose, point_diff=d_pt)
            graph_runs = runs["mesh_graph"] if on_card else []
            for run in graph_runs:
                assert run["replays"] == 1 and not run["sync_sites"], (
                    run["replays"], run["sync_sites"])
            ms = {k: [r["ms"] for r in v] for k, v in runs.items()}
            replay_ms = [r["replay_ms"] for r in graph_runs]
            one_replay_ms = [r["replay_ms"] for r in runs["one"]
                             if "replay_ms" in r]
            eager_syncs = [len(r["sync_sites"]) for r in runs["mesh_eager"]]
            out[name] = dict(
                diffs, ms=ms, mesh_replay_ms=replay_ms,
                one_replay_ms=one_replay_ms,
                mesh_capture_s=[r["capture_s"] for r in graph_runs],
                mesh_pool_bytes=[r["pool_bytes"] for r in graph_runs],
                mesh_graph_syncs=0 if on_card else None,
                mesh_eager_syncs=eager_syncs,
                cg_iterations=g["cg_iterations"])
            d = diffs["mesh_graph_vs_one"]
            say("dist", f"global_ba on {int(kv.sum())} keyframes / "
                        f"{int(pv.sum())} points in {m.capacities[0]} slots "
                        f"({name.split('_')[0]}), {backend} mesh of "
                        f"{out['world_size']}: the mesh as one graph "
                        f"replay (0 synchronisations before the result) "
                        f"against one process: poses within "
                        f"{d['pose_diff']:.3g} (<= 5e-4), points within "
                        f"{d['point_diff']:.3g} (<= 5e-3), gated "
                        f"observations equal; against the eager mesh "
                        f"{diffs['mesh_graph_vs_mesh_eager']}. ms in all: "
                        f"one process {ms['one']}, mesh graph "
                        f"{ms['mesh_graph']} (replay {replay_ms}), eager "
                        f"mesh {ms['mesh_eager']} with {eager_syncs} "
                        f"synchronisations; one process's replay "
                        f"{one_replay_ms} on {card}")
    finally:
        tdist.destroy_process_group()
    return out


def host_run_summary(rec) -> dict:
    """What a host-driver CLI run reports: its summary, the kernel's
    launches, synchronisations per frame and per steady tracking frame,
    stage graph replays per frame and the graphs' pools."""
    return dict(summary=rec["summary"], launches=rec["launches"],
                captures=rec["captures"], frames=len(rec["frame_syncs"]),
                syncs_per_frame=float(np.mean(rec["frame_syncs"])),
                tracking_syncs_per_frame=float(np.mean(tracking_syncs(rec))),
                replays_per_frame=float(np.mean(rec["frame_replays"])),
                pool_bytes=rec.get("pool_bytes"),
                mapper_pool_bytes=rec.get("mapper_pool_bytes"))


def check_async_run(rec, txt: str, gt, min_m: int) -> dict:
    """An ``--async-mapping`` run against the criteria of
    ``tests/test_runtime_async.py``, with 1 synchronisation on each
    tracking frame that captured no graph."""
    n = CLI_FRAMES
    states = np.asarray(rec["states"])
    mapper_ = rec["mappers"][0]
    running = states == "RUNNING"
    nm = np.asarray(rec["n_matches"])[running]
    rows = tum_rows(txt, n)
    ate = sim3_ate_pct(rows[running, 1:4], gt[running])
    assert mapper_.processed > 0 and states[-1] == "RUNNING"
    assert running.mean() >= 18 / 26, states.tolist()
    assert (nm >= min_m).mean() > 0.8, nm.tolist()
    assert rec["summary"]["points"] >= 30
    assert rec["summary"]["keyframes"] >= 2
    assert ate < 5.0, ate
    assert rec["frame_launches"] == n
    syncs = tracking_syncs(rec)
    assert syncs and set(syncs) == {1}, (
        f"async mapper: tracking frames synchronised {syncs} times")
    return dict(host_run_summary(rec), ate_pct=ate,
                processed=mapper_.processed, dropped=mapper_.dropped_frames,
                running=int(running.sum()),
                good_share=float((nm >= min_m).mean()))


def time_publish(cfg_path: str, reps: int = 20) -> dict:
    """Device ms of the async mapper's publish at a config's capacities:
    the map copied into the tracker's storage whole (after a keyframe) and
    without the keyframe pyramids (after frame work), as
    ``AsyncMapper.publish`` copies it; CUDA events around ``reps`` copies."""
    from sdvl_tpu_torch.pipeline.config import load_cfg
    from sdvl_tpu_torch.pipeline.device_fsm import StepState, cropped_shape
    from sdvl_tpu_torch.state.map_state import empty_map

    cfg = load_cfg(cfg_path)
    s = cfg.sdvl

    def make():
        return empty_map(n_kf=s.max_keyframes, n_pts=s.max_points,
                         n_cand=s.max_candidates, img_shape=cropped_shape(cfg),
                         levels=s.pyramid_levels, device="cuda")

    src, dst = make(), StepState(make(), None, inplace=True)
    out = {}
    for name, m in (("whole", src),
                    ("no_kf_pyr", src._replace(kf_pyr=dst.m.kf_pyr))):
        moved = sum(a.numel() * a.element_size()
                    for a, b in zip(map_leaves(m), map_leaves(dst.m))
                    if a is not b)
        dst.update(m=m)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            dst.update(m=m)
        e1.record()
        torch.cuda.synchronize()
        out[name] = dict(bytes=moved, ms=e0.elapsed_time(e1) / reps,
                         bound_ms=1e3 * 2 * moved / PEAK_BYTES_PER_S)
    return out


def run_cli_phase(card: str, device: str = "cuda",
                  cfg_path: str = TUM_F1_CFG) -> dict:
    """Phase 6 (see the module docstring)."""
    from sdvl_tpu_torch.io.snapshot import load_stream_snapshot
    from sdvl_tpu_torch.pipeline import mapper
    from sdvl_tpu_torch.pipeline.config import intrinsics, load_cfg
    from sdvl_tpu_torch.pipeline.stream import SdvlStream
    from sdvl_tpu_torch.solvers import ba

    out = {}
    n = CLI_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        poses, _ = write_cli_sequence(cfg_path, tmp)
        cfg = load_cfg(cfg_path)
        K = cfg.sdvl.max_keyframes
        assert K > ba.CG_KF_THRESHOLD and any(cfg.camera.dist), (
            "the cli phase runs the shipped capacity and a distorted lens")
        say("cli", f"rendered {len(poses)} frames at {cfg.camera.height}x"
                   f"{cfg.camera.width} through the lens of "
                   f"{os.path.relpath(cfg_path, ROOT)} (d = "
                   f"{cfg.camera.dist}) in {time.perf_counter() - t0:.1f} s")
        cfg100 = os.path.join(tmp, "capacity100.cfg")
        with open(cfg_path) as f:
            text = f.read()
        assert f"SDVL.max_keyframes: {K}" in text
        with open(cfg100, "w") as f:
            f.write(text.replace(f"SDVL.max_keyframes: {K}",
                                 "SDVL.max_keyframes: 100"))
        p = {name: os.path.join(tmp, name) for name in (
            "s1.npz", "s1.txt", "s2.txt", "s3.npz", "s3.txt", "s3.json",
            "s3c.txt", "s4.txt", "s4b.txt", "s5.txt")}
        gt = poses[:n]

        # 1. the stream at the shipped capacity, global BA at the end
        r1 = run_cli(["--config", cfg_path, "--images", tmp, "--stream",
                      "--global-ba", "--output", p["s1.txt"], "--snapshot",
                      p["s1.npz"], "--quiet"], device)
        res1 = r1["result"]
        running = res1.states == 2
        start = int(np.argmax(running))
        assert running.any() and running[start:].all(), res1.states.tolist()
        ate_before = sim3_ate_pct(
            camera_centres(r1["traj_before"][start:]), gt[start:])
        rows1 = tum_rows(p["s1.txt"], n)
        ate_after = sim3_ate_pct(rows1[start:, 1:4], gt[start:])
        assert ate_before < 3.0 and ate_after < 3.0, (ate_before, ate_after)
        assert r1["cg_iterations"], "global BA did not take the PCG path"
        assert r1["frame_launches"] == n, r1["launches"]
        st = SdvlStream(cfg, device=device)
        load_stream_snapshot(st, p["s1.npz"])
        assert st.m.capacities[0] == K
        cg1 = r1["cg_iterations"]
        say("cli", f"run 1, --stream --global-ba at {K} keyframe slots: "
                   f"{r1['summary']}; RUNNING from frame {start} to the end, "
                   f"keyframes {res1.is_keyframe.astype(int).tolist()}")
        say("cli", f"run 1: Sim(3) ATE {ate_before:.4f} % of the extent "
                   f"before global BA, {ate_after:.4f} % after; global BA "
                   f"(PCG, {K} slots) {r1['gba_ms']:.1f} ms, CG iterations "
                   f"per LM step {cg1}; TUM file {n} finite rows; the "
                   f"snapshot loads in SdvlStream")
        say("cli", "run 1: " + per_frame(r1, card))
        out["stream"] = dict(summary=r1["summary"], launches=r1["launches"],
                             captures=r1["captures"],
                             frames=n, syncs_per_frame=float(
                                 np.mean(r1["frame_syncs"])),
                             ate_pct_before=ate_before,
                             ate_pct_after=ate_after,
                             global_ba_ms=r1["gba_ms"], cg_iterations=cg1)

        # 2. the same run at 100 keyframe slots
        r2 = run_cli(["--config", cfg100, "--images", tmp, "--stream",
                      "--global-ba", "--output", p["s2.txt"], "--quiet"],
                     device)
        res2 = r2["result"]
        assert (res2.states == res1.states).all(), "states differ"
        assert (res2.is_keyframe == res1.is_keyframe).all(), "keyframes"
        extent = float(np.linalg.norm(np.ptp(camera_centres(gt), axis=0)))
        d_cap = float(np.abs(camera_centres(r2["traj_before"])
                             - camera_centres(r1["traj_before"])).max())
        assert d_cap <= 1e-4 * extent, (d_cap, extent)
        assert r2["frame_launches"] == n and not r2["cg_iterations"]
        # PCG against the dense solve on one map: run 2's final map as it
        # is (100 slots, Cholesky) and padded to the shipped capacity (PCG)
        m2 = r2["map_before"]
        intr = intrinsics(load_cfg(cfg100))
        # each as one replay (the default on the card) and on graphs=False:
        # bit-identical, CG counts included
        timed, gba = {}, {}
        for name, m in (("dense", m2), ("pcg", pad_keyframe_slots(m2, K))):
            runs = {g: timed_global_ba(m, intr, g, device)
                    for g in ((True, False) if device == "cuda"
                              else (False,))}
            g = runs[device == "cuda"]
            timed[name] = (g["map"], g["ms"], g["cg_iterations"])
            if device == "cuda":
                e = runs[False]
                for field in ("kf_pose", "pt_pos", "obs_mask", "pt_valid"):
                    assert torch.equal(getattr(g["map"], field),
                                       getattr(e["map"], field)), (
                        f"global BA {name}: {field} of the replay differs "
                        f"from graphs=False")
                assert g["cg_iterations"] == e["cg_iterations"], (
                    g["cg_iterations"], e["cg_iterations"])
                assert g["replays"] == 1 and not g["sync_sites"], (
                    g["replays"], g["sync_sites"])
                gba[name] = dict(
                    slots=int(m.kf_valid.shape[0]), graph_ms=g["ms"],
                    replay_ms=g["replay_ms"], capture_s=g["capture_s"],
                    pool_bytes=g["pool_bytes"], graph_syncs=0,
                    eager_ms=e["ms"], eager_syncs=len(e["sync_sites"]),
                    cg_iterations=g["cg_iterations"])
                say("cli", f"global BA {name} at {gba[name]['slots']} slots "
                           f"as one replay: bit-identical to graphs=False "
                           f"(poses, points, masks, CG counts "
                           f"{g['cg_iterations']}); "
                           f"{g['ms']:.1f} ms with the warm-up and capture "
                           f"({g['capture_s']:.2f} s; the replay "
                           f"{g['replay_ms']:.1f} ms), no synchronisation; "
                           f"pool {g['pool_bytes'] / 2**20:.1f} MiB; "
                           f"graphs=False {e['ms']:.1f} ms with "
                           f"{len(e['sync_sites'])} synchronisations, on "
                           f"{card}")
        (md, ms_d, cg_d), (mp, ms_p, cg_p) = timed["dense"], timed["pcg"]
        assert cg_p and not cg_d
        kv = md.kf_valid.cpu().numpy()
        pv = md.pt_valid.cpu().numpy()
        d_pose = float(np.abs(mp.kf_pose[:100].cpu().numpy()[kv]
                              - md.kf_pose.cpu().numpy()[kv]).max())
        d_pt = float(np.abs(mp.pt_pos.cpu().numpy()[pv]
                            - md.pt_pos.cpu().numpy()[pv]).max())
        assert d_pose <= 5e-4 and d_pt <= 5e-3, (d_pose, d_pt)
        say("cli", f"run 2, 100 keyframe slots: states and keyframe flags "
                   f"equal run 1's, camera centres within {d_cap:.3g} "
                   f"(extent {extent:.4f}); " + per_frame(r2, card))
        say("cli", f"global BA on run 2's map ({int(kv.sum())} keyframes, "
                   f"{int(pv.sum())} points): dense Cholesky at 100 slots "
                   f"{ms_d:.1f} ms, PCG at {K} slots {ms_p:.1f} ms with CG "
                   f"iterations per LM step {cg_p}; poses within {d_pose:.3g} "
                   f"(<= 5e-4), points within {d_pt:.3g} (<= 5e-3)")
        out["_map100"] = m2
        out["capacity100"] = dict(summary=r2["summary"],
                                  max_centre_diff=d_cap,
                                  global_ba_dense_ms=ms_d,
                                  global_ba_pcg_ms=ms_p,
                                  pcg_cg_iterations=cg_p,
                                  pcg_vs_dense_pose=d_pose,
                                  pcg_vs_dense_point=d_pt,
                                  global_ba_replay=gba)

        # 3. the host driver, 100 slots, traced
        r3 = run_cli(["--config", cfg100, "--images", tmp, "--trace",
                      p["s3.json"], "--snapshot", p["s3.npz"], "--output",
                      p["s3.txt"]], device)
        rows3 = tum_rows(p["s3.txt"], n)
        d_host = float(np.abs(rows3[:, 1:8]
                              - tum_from_poses(r2["traj_before"])).max())
        assert d_host <= 1e-4, d_host
        run2 = res2.states == 2
        run2[start] = False       # the stream reports inliers there
        dm = np.abs(np.asarray(r3["n_matches"]) - res2.n_matches)[run2]
        assert dm.max() <= 1 and (dm > 0).mean() <= 0.15, dm.tolist()
        with open(p["s3.json"]) as f:
            trace = json.load(f)
        assert "preprocess" in trace and "track" in trace, sorted(trace)
        assert r3["frame_launches"] == n
        syncs3 = tracking_syncs(r3)
        assert syncs3 and set(syncs3) == {1}, (
            f"host driver: tracking frames synchronised {syncs3} times")
        say("cli", f"run 3, host driver, 100 slots: trajectory within "
                   f"{d_host:.3g} of run 2's, n_matches off by "
                   f"{int(dm.max())} on {int((dm > 0).sum())} of "
                   f"{int(run2.sum())} RUNNING frames; 1 synchronisation on "
                   f"each of the {len(syncs3)} tracking frames that captured "
                   f"nothing; trace spans "
                   + ", ".join(f"{k} {v['mean_ms']} ms" for k, v in
                               trace.items()))
        say("cli", "run 3: " + per_frame(r3, card))
        out["host"] = dict(host_run_summary(r3), max_traj_diff=d_host,
                           trace=trace)

        # 3b. the host driver with --viz, a short run
        out["viz"] = run_cli_viz(cfg100, tmp, r3, device, card)

        # 3c. the host driver at the shipped capacity
        r3c = run_cli(["--config", cfg_path, "--images", tmp, "--output",
                       p["s3c.txt"]], device)
        rows3c = tum_rows(p["s3c.txt"], n)
        assert r3c["states"] == r3["states"], "states differ"
        d_cap3 = float(np.abs(rows3c[:, 1:4] - rows3[:, 1:4]).max())
        assert d_cap3 <= 1e-4 * extent, (d_cap3, extent)
        assert r3c["frame_launches"] == n
        syncs3c = tracking_syncs(r3c)
        assert syncs3c and set(syncs3c) == {1}, syncs3c
        say("cli", f"run 3c, host driver, {K} slots: states equal run 3's, "
                   f"camera centres within {d_cap3:.3g}; "
                   + per_frame(r3c, card))
        out["host_1000"] = dict(host_run_summary(r3c),
                                max_centre_diff=d_cap3)

        # 4. the host driver with the async mapper, at 100 and at the
        # shipped capacity
        for name, cfg_run, txt in (("async", cfg100, "s4.txt"),
                                   ("async_1000", cfg_path, "s4b.txt")):
            r4 = run_cli(["--config", cfg_run, "--images", tmp,
                          "--async-mapping", "--output", p[txt]], device)
            out[name] = check_async_run(r4, p[txt], gt, cfg.sdvl.min_matches)
            say("cli", f"run 4 ({name}), --async-mapping: mapper processed "
                       f"{out[name]['processed']} items, dropped "
                       f"{out[name]['dropped']} frames; "
                       f"{out[name]['running']} of {n} frames RUNNING, "
                       f"{out[name]['good_share']:.2f} of them >= "
                       f"{cfg.sdvl.min_matches} matches; ATE "
                       f"{out[name]['ate_pct']:.4f} %")
            say("cli", f"run 4 ({name}): " + per_frame(r4, card))
        for name, cfg_run in (("100", cfg100), (str(K), cfg_path)):
            pub = out[f"publish_{name}"] = time_publish(cfg_run)
            say("cli", f"the async mapper's publish at {name} keyframe "
                       f"slots (device ms per copy into the tracker's map): "
                       + "; ".join(f"{k} {v['bytes'] / 1e6:.1f} MB in "
                                   f"{v['ms']:.4f} ms (bound {v['bound_ms']:.4f}"
                                   f" ms, bytes)" for k, v in pub.items())
                       + f" on {card}")

        # 5. follow-on runs: resume run 3's session, serve run 1's map
        r5 = run_cli(["--config", cfg100, "--images", tmp, "--filename",
                      "resume.txt", "--resume", p["s3.npz"], "--quiet"],
                     device)
        assert f"[INFO] resumed from {p['s3.npz']} at frame {n}" \
            in r5["lines"]
        assert r5["summary"]["frames"] == CLI_RESUME_FRAMES
        assert r5["frame_launches"] == CLI_RESUME_FRAMES
        q0, q1 = CLI_QUERY
        r6 = run_cli(["--config", cfg_path, "--images", tmp, "--filename",
                      "query.txt", "--stream", "--localize", p["s1.npz"],
                      "--output", p["s5.txt"]], device)
        states6 = np.asarray(r6["states"])
        running6 = states6 == "RUNNING"
        assert int(np.argmax(running6)) <= 5 and running6[-5:].all(), (
            states6.tolist())
        rows6 = tum_rows(p["s5.txt"], q1 - q0)
        ate6 = sim3_ate_pct(rows6[running6, 1:4], poses[q0:q1][running6])
        assert ate6 < 5.0, ate6
        assert r6["frame_launches"] == q1 - q0
        say("cli", f"run 5, --resume of run 3's snapshot: "
                   f"{r5['summary']}, {r5['launches']} launches; "
                   f"--stream --localize of run 1's map on frames {q0}-"
                   f"{q1 - 1}: states {states6.tolist()}, ATE {ate6:.4f} "
                   f"%, {r6['launches']} launches")
        say("cli", "run 5, --localize: " + per_frame(r6, card))
        out["resume"] = dict(summary=r5["summary"],
                             launches=r5["launches"])
        out["localize"] = dict(summary=r6["summary"], ate_pct=ate6,
                               launches=r6["launches"], frames=q1 - q0)
    return out


# How far the card's long run may lie outside the range of the recorded JAX
# runs (one per seed), in each of the tool's figures: the spread of the JAX
# seeds themselves on each side (so a figure may lie as far outside their
# range as the range is wide), and at least these floors: the spread of
# both packages' runs of the recorded configuration, the JAX package's three
# recorded seeds and three runs of the port on an H100 with noise seeds 0,
# 1, 2 together (tracked ratio 0.9888-0.9938, insertions 39-46, evictions
# 24-29, prunes 3-5, LOST frames 14-26, ATE 0.0137-0.3819), rounded up
LONG_FLOORS = dict(tracked_ratio=0.005, keyframes_total_inserted=7,
                   evictions=5, prunes=2, n_lost_frames=12, ate_rmse=0.01)


def long_ranges(jax_stats: list) -> dict:
    """Per figure of ``LONG_FLOORS``: the recorded JAX runs' (min, max),
    widened on each side by their spread, at least the floor."""
    out = {}
    for k, floor in LONG_FLOORS.items():
        v = [s[k] for s in jax_stats]
        pad = max(max(v) - min(v), floor)
        out[k] = (min(v) - pad, max(v) + pad)
    return out


def run_long_phase(card: str, record: str = LONG_NPZ,
                   path: str = "long") -> dict:
    """Phase long (see the module docstring): the JAX tool's long
    live-mapping run through ``SdvlStream.feed_chunk`` at the recorded
    depth and relocalizer lane budget, one replay per chunk, held to the
    recorded JAX runs; ``path`` names it in the output."""
    import dataclasses

    from sdvl_tpu_torch.tools import long_run

    rec = np.load(record)
    proto = json.loads(bytes(rec["protocol"]).decode())
    jax_stats = json.loads(bytes(rec["jax_stats"]).decode())
    K, n, chunk = proto["kf"], proto["frames"], proto["chunk"]
    cfg, scene = long_run.long_run_config(K, proto["points"])
    cfg = dataclasses.replace(cfg, sdvl=dataclasses.replace(
        cfg.sdvl, **proto.get("sdvl", {})))
    sd = cfg.sdvl
    bounded = sd.max_keyframes > sd.reloc_max_keyframes
    poses = long_run.lawnmower_trajectory(n, **proto["path"])
    syncs, replays, captured = [], [], []

    def on_chunk(st, feed):
        n0, g0 = st.runner.replays, len(st.runner.chunk_graphs)
        syncs.append(len(sync_sites(feed)))
        replays.append(st.runner.replays - n0)
        captured.append(len(st.runner.chunk_graphs) > g0)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r, _, stats = long_run.run_protocol(
        cfg, scene, n, chunk=chunk, blackout_frac=proto["blackout_frac"],
        blackout_len=proto["blackout_len"], poses=poses, seed=0,
        device="cuda", on_chunk=on_chunk)
    seconds = time.perf_counter() - t0
    launches, caps = read_counts()
    side = side_counts()
    want = bytes(rec["frames_sha256"]).decode()
    assert stats["frames_sha256"] == want, (
        f"rendered frames differ from the recorded run's: SHA-256 "
        f"{stats['frames_sha256']} != {want}")
    long_run.check_stats(stats, K)
    boot = int(np.argmax(r.states == 2))
    boot_j = sorted({int(np.argmax(s == 2)) for s in rec["jax_state"]})
    assert boot in boot_j, f"bootstrap at frame {boot}, JAX at {boot_j}"
    ranges = long_ranges(jax_stats)
    outside = {k: (stats[k], lo, hi) for k, (lo, hi) in ranges.items()
               if not lo <= stats[k] <= hi}
    assert not outside, f"outside the recorded runs' range: {outside}"
    # the relocalizer's sweeps, inferred from the states by do_reloc's
    # rule (the branch runs inside the graph and is not observed): with a
    # lane budget below K the nearest lanes, on real frames after the
    # blackout too, and, once the LOST stretch is long enough, every slot;
    # else every slot on every LOST frame
    frames = stats["reloc_sweeps"]
    sweeps = {k: len(v) for k, v in frames.items()}
    b1 = int(n * proto["blackout_frac"]) + proto["blackout_len"]
    near_real = sum(i >= b1 for i in frames["nearest"])
    assert sweeps["all_slots"] and bool(sweeps["nearest"]) == bounded, (
        f"relocalizing frames by sweep {sweeps}, lane budget "
        f"{sd.reloc_max_keyframes} of {K} slots")
    assert near_real or not bounded, (
        f"no real frame took the nearest lanes: {frames}")
    n_chunks = -(-n // chunk)
    assert replays == [1] * n_chunks, f"replays per chunk {replays}"
    sizes = {min(chunk, n - i) for i in range(0, n, chunk)}
    assert caps == len(sizes) and frame_launches(launches, caps) == n, (
        launches, caps)
    bad = [i for i, (s, c) in enumerate(zip(syncs, captured)) if s and not c]
    assert not bad, f"chunks that captured nothing synchronised: {bad}"
    pool = sum(stats["pool_mib"].values())
    out = dict(frames=n, chunk=chunk, kf_slots=K, point_slots=proto["points"],
               reloc_max_keyframes=sd.reloc_max_keyframes,
               reloc_escalate_after=sd.reloc_escalate_after, sweeps=sweeps,
               nearest_after_blackout=near_real,
               stats=stats, jax_stats=jax_stats, ranges=ranges,
               bootstrap_frame=boot, launches=launches, captures=caps,
               side_counts=side, replays_per_chunk=sorted(set(replays)),
               syncs_after_capture=sum(s for s, c in zip(syncs, captured)
                                       if not c),
               seconds=seconds, pool_mib=pool)
    say(path, f"{n} frames at 640x480, {K} keyframe / {proto['points']} "
              f"point slots, relocalizer lane budget "
              f"{sd.reloc_max_keyframes} (every slot after "
              f"{sd.reloc_escalate_after} more LOST frames), chunks of "
              f"{chunk}, 5 black frames from frame "
              f"{int(n * proto['blackout_frac'])}: frames' SHA-256 equal "
              f"to the JAX record's; bootstrap at frame {boot} (JAX "
              f"runs: {boot_j}); the tool's assertions hold; relocalizing "
              f"frames by sweep, inferred from the states: {sweeps} "
              f"({near_real} real frames after the blackout on the "
              f"nearest lanes)")
    say(path, "card / JAX seeds " + str(rec["seeds"].tolist()) + ": "
              + "; ".join(f"{k} {stats[k]} / "
                          f"{[s[k] for s in jax_stats]} (allowed "
                          f"{lo:.4g}..{hi:.4g})"
                          for k, (lo, hi) in ranges.items())
              + f"; lost segments {stats['lost_segments']} / "
                f"{[s['lost_segments'] for s in jax_stats]}")
    say(path, f"one replay per chunk ({n_chunks} chunks), "
              f"{out['syncs_after_capture']} synchronisations in the "
              f"chunks that captured nothing; kernel launches {launches} "
              f"= 1 x {n} frames + {launches - n} in the capture's eager "
              f"passes; small eigensolver {side['small_eig']}, condition "
              f"kernel {side['conditions']} (if/else pairs "
              f"{side['pairs']})")
    say(path, f"replays alone {stats['replay_fps']} frames/s, harness "
              f"(rendering in {long_run.default_workers('cuda')} "
              f"threads, overlapped) {stats['harness_fps']} frames/s; "
              f"first chunk (capture and bootstrap) {stats['compile_s']} "
              f"s, capture s {stats['capture_s']}, pool "
              f"{pool:.1f} MiB; on {card}")
    return out


# phase zurich's bounds against the JAX record (the JAX tool at its defaults
# on a CPU): the reprojection error before BA (float32 sums over 0.62M
# observations), the filled slots' camera centres after it (the CPU test's
# bound, tests/test_torch_zurich_scale.py), the points after it, both runs'
# error after it (float32's floor: 0.0023 in the record), the serving run's
# RUNNING frames (the card draws its own RANSAC noise; 5 % of the 226
# frames), the standalone relocalizer's pose
ZURICH_E0_REL = 1e-4
ZURICH_CENTRES = 1e-4
# the points after global BA, each at its distance from the nearer of the
# reference's two evaluations in the record (jitted, op by op), within this
# share of the reference's own largest distance between the two among the
# points seen by as many keyframes (zurich_scale_smoke.OBS_GROUPS; 3.60e-3
# for the 8 points seen by 2, 4.0e-4 for 3-4, 1.04e-4 to 1.16e-4 for 5 and
# more; spread_against): the reference's own spread, no more
ZURICH_POINTS = 1.0
ZURICH_E1_ABS = 0.01
ZURICH_TRACKED = 11
ZURICH_LANE_POSE = 1e-3


def check_captures(calls: list, expected: list, phase: str) -> int:
    """``calls``: (synchronisations, replays, captured) of each feed of a
    graph-path run. Asserts one replay per call, captures exactly at the
    calls ``expected`` and no synchronisation in a call that captured
    nothing; returns the synchronisations in the calls that did."""
    replays = [c[1] for c in calls]
    assert replays == [1] * len(calls), f"{phase}: replays {replays}"
    captured = [i for i, c in enumerate(calls) if c[2]]
    assert captured == expected, f"{phase}: captures at {captured}"
    bad = [i for i, c in enumerate(calls) if c[0] and not c[2]]
    assert not bad, f"{phase}: calls that captured nothing synchronised: " \
                    f"{bad}"
    return sum(c[0] for c in calls if c[2])


def run_zurich_phase(card: str) -> dict:
    """Phase zurich (see the module docstring): the JAX package's
    Zurich-capacity smoke at its defaults, held against
    ``tests/data/torch_zurich_record.npz``."""
    from sdvl_tpu_torch.tools import zurich_scale_smoke as z

    rec = np.load(ZURICH_NPZ)
    proto = json.loads(bytes(rec["protocol"]).decode())
    kf, kf_cap, pts = proto["kf"], proto["kf_cap"], proto["pts"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    intr, scene, cfg, m, kf_poses, sha = z.build_map(
        kf, pts, kf_cap, proto["height"], proto["width"], "cuda")
    want = bytes(rec["kf_images_sha256"]).decode()
    assert sha == want, f"keyframe views' SHA-256 {sha} != record {want}"
    own, jax_layout = z.state_bytes(m)
    fill_s = time.perf_counter() - t0
    say("zurich", f"{kf} of {kf_cap} keyframe slots filled with 640x480 "
                  f"views (SHA-256 equal to the JAX record's), {pts} points, "
                  f"{int(m.obs_mask.sum())} observations in {fill_s:.1f} s; "
                  f"state {own / 1e9:.4f} GB (the JAX layout's "
                  f"{jax_layout / 1e9:.4f})")

    # serving: the per-frame feeds and the chunks, each call's
    # synchronisations, replays and whether it captured
    q = z.query_views(scene, kf_poses, workers=z.default_workers("cuda"))
    calls = []

    def on_feed(st, feed):
        r = st.runner
        g0, n0 = (r.graph, len(r.chunk_graphs)), r.replays
        n_syncs = len(sync_sites(feed))
        calls.append((n_syncs, r.replays - n0,
                      (r.graph, len(r.chunk_graphs)) != g0))

    reset_counts()
    serve, res, lanes = z.serve_smoke(m, intr, cfg, kf_poses, q,
                                      device="cuda", on_feed=on_feed)
    s_launch, s_caps = read_counts()
    s_side = side_counts()
    states = res.states
    j_states = rec["serve_state"]
    assert res.n_frames == len(j_states), (res.n_frames, len(j_states))
    assert states[0] == j_states[0] == 2, "not relocalized on frame 0"
    assert serve["serve_final_state"] == "RUNNING", serve
    j_tracked = int((j_states == 2).sum())
    assert abs(serve["serve_tracked_frames"] - j_tracked) <= ZURICH_TRACKED, (
        serve["serve_tracked_frames"], j_tracked)
    steady = 64
    cap_syncs = check_captures(calls, [0, 2 + steady], "zurich serving")
    assert s_caps == 2 and frame_launches(s_launch, s_caps) == res.n_frames, (
        s_launch, s_caps, res.n_frames)
    lane_rows = {}
    for i, n in enumerate(rec["lane_budgets"].tolist()):
        r = lanes[n]
        d = float(np.abs(r.pose.cpu().numpy() - rec["lane_pose"][i]).max())
        lane_rows[n] = dict(kf=int(r.kf), jax_kf=int(rec["lane_kf"][i]),
                            pose_diff=d, error=float(r.error),
                            jax_error=float(rec["lane_error"][i]))
        assert int(r.kf) == int(rec["lane_kf"][i]), lane_rows[n]
        assert d <= ZURICH_LANE_POSE, lane_rows[n]
        assert serve["reloc_lane_replays"][n] == 9, serve
    dm = np.abs(res.n_matches - rec["serve_n_matches"])[
        (states == 2) & (j_states == 2)]
    say("zurich", f"serving {res.n_frames} frames over the 1000-slot map: "
                  f"relocalized on frame 0 as the JAX run; RUNNING on "
                  f"{serve['serve_tracked_frames']} (JAX {j_tracked}), LOST "
                  f"at {np.flatnonzero(states == 3).tolist()} (JAX "
                  f"{np.flatnonzero(j_states == 3).tolist()}); n_matches "
                  f"apart on {int((dm > 0).sum())} of {len(dm)} frames "
                  f"both track (largest {int(dm.max()) if len(dm) else 0})")
    say("zurich", f"graph path: captures at the cold reloc step and the "
                  f"first chunk, one replay per feed or chunk "
                  f"({len(calls)} calls), 0 synchronisations in the calls "
                  f"that captured nothing ({cap_syncs} in the two that "
                  f"did); kernel launches {s_launch} = {res.n_frames} "
                  f"frames + {s_launch - res.n_frames} in the captures' "
                  f"eager passes; condition kernel {s_side['conditions']} "
                  f"(if/else pairs {s_side['pairs']})")
    say("zurich", "standalone relocalizer (one replay each, 8 timed): "
                  + "; ".join(f"{n} lanes {serve['reloc_lane_ms'][n]:.4f} "
                              f"ms, keyframe {v['kf']} (JAX {v['jax_kf']}), "
                              f"pose {v['pose_diff']:.2e} from JAX's"
                              for n, v in lane_rows.items()))
    say("zurich", f"reloc step cold (capture) {serve['serve_compile_s']:.3f}"
                  f" s, warm {serve['serve_reloc_step_ms']:.3f} ms; steady "
                  f"{serve['serve_steady_step_ms']:.3f} ms a frame; chunks "
                  f"of 32: {serve['serve_chunked_fps']:.2f} frames/s, "
                  f"device {serve['serve_chunk_ms_per_frame']:.3f} ms a "
                  f"frame; captures {serve['serve_capture_s']:.3f} s, pool "
                  f"{serve['serve_pool_mib']:.1f} MiB; on {card}")
    mem_serve = z.memory_gb("cuda")

    # global BA over the filled map, fed the JAX tool's draws
    noise = [torch.from_numpy(rec[k]).cuda()
             for k in ("pose_noise", "pt_noise")]
    reset_counts()
    ba = z.run_global_ba(m, intr, *noise, proto["stage_iters"])
    b_side = side_counts()
    e0_j, e1_j = float(rec["reproj_px_before"]), float(
        rec["reproj_px_after"])
    assert ba["replays"] == 1 and not ba["sync_sites"], (
        ba["replays"], ba["sync_sites"])
    assert abs(ba["e0"] - e0_j) <= ZURICH_E0_REL * e0_j, (ba["e0"], e0_j)
    assert ba["e1"] < ZURICH_E1_ABS and e1_j < ZURICH_E1_ABS, (ba["e1"],
                                                               e1_j)
    c = camera_centres(ba["map"].kf_pose[:kf].cpu().numpy())
    c_j = camera_centres(rec["ba_kf_pose"])
    d_c = float(np.abs(c - c_j).max())
    d_p = float(np.abs(ba["map"].pt_pos.cpu().numpy()
                       - rec["ba_pt_pos"]).max())
    obs = np.packbits(ba["map"].obs_mask[:kf].cpu().numpy(), axis=1)
    obs_apart = int(np.unpackbits(obs ^ rec["ba_obs_mask"]).sum())
    sp = z.spread_against(ba["map"].pt_pos.cpu().numpy(),
                          ba["map"].kf_pose[:kf].cpu().numpy(), obs, rec,
                          ZURICH_POINTS)
    say("zurich", f"global BA's points, each at its distance from the "
                  f"nearer of the reference's two runs (jitted, op by op), "
                  f"by the keyframes that see it: {json.dumps(sp['points'])}"
                  f"; the reference's own spread (op by op against "
                  f"jitted): {json.dumps(sp['own']['points'])}; camera "
                  f"centres {json.dumps(sp['centres'])}, own "
                  f"{json.dumps(sp['own']['centres'])}")
    assert d_c <= ZURICH_CENTRES, f"camera centres {d_c} from the record's"
    assert not sp["apart"], f"beyond the reference's own spread: " \
                            f"{sp['apart']}"
    cg_j = rec["ba_cg_iterations"].tolist()
    say("zurich", f"global BA over {kf} filled of {kf_cap} slots, fed the "
                  f"JAX draws: one replay, 0 synchronisations before the "
                  f"result; reprojection error {ba['e0']:.6f} -> "
                  f"{ba['e1']:.6f} px (JAX {e0_j:.6f} -> {e1_j:.6f}); "
                  f"camera centres {d_c:.3e} from JAX's, points "
                  f"{d_p:.3e}, gated observations apart {obs_apart}; CG "
                  f"iterations per LM step {ba['cg_iterations']} (JAX "
                  f"{cg_j}); condition kernel {b_side['conditions']}")
    say("zurich", f"global BA: first call (warm-up, capture, replay) "
                  f"{ba['seconds']:.3f} s, capture {ba['capture_s']:.3f} s, "
                  f"replay {1e3 * ba['replay_s']:.1f} ms, pool "
                  f"{ba['pool_mib']:.1f} MiB; on {card}")
    mem = z.memory_gb("cuda")
    out = {"kf_capacity": kf_cap, "kf_filled": kf, "points": pts,
           "state_gb": own / 1e9, "state_gb_jax_layout": jax_layout / 1e9,
           "reproj_px_before": ba["e0"], "reproj_px_after": ba["e1"],
           "ba_s_compile+run": ba["seconds"], "ba_s_warm": ba["replay_s"],
           "ba_capture_s": ba["capture_s"],
           "ba_replay_ms": 1e3 * ba["replay_s"],
           "ba_pool_mib": ba["pool_mib"], "ba_replays": ba["replays"],
           "ba_cg_iterations": ba["cg_iterations"],
           "jax_cg_iterations": cg_j,
           "ba_syncs_before_result": len(ba["sync_sites"]),
           "centre_diff": d_c, "point_diff": d_p, "obs_apart": obs_apart,
           "point_spread": sp["points"], "own_point_spread":
           sp["own"]["points"], "centre_spread": sp["centres"],
           "own_centre_spread": sp["own"]["centres"],
           "jax_reproj_px_before": e0_j, "jax_reproj_px_after": e1_j,
           **serve, "serve_hbm_in_use_gb": mem_serve["hbm_in_use_gb"],
           **mem, "lanes": lane_rows, "jax_tracked_frames": j_tracked,
           "frames": res.n_frames, "launches": s_launch, "captures": s_caps,
           "side_counts": s_side, "ba_side_counts": b_side,
           "serve_calls": len(calls), "seconds": time.perf_counter() - t0}
    say("zurich", "json " + json.dumps({
        k: v for k, v in out.items() if k not in ("side_counts",
                                                  "ba_side_counts")}))
    say("zurich", f"allocated now {mem['hbm_in_use_gb']:.3f} GB, peak "
                  f"{mem['hbm_peak_gb']:.3f} GB")
    return out


CAPACITY_KS = (100, 300, 1000)
# the capacities against each other: camera centres within this share of
# the trajectory's extent (phase cli's "capacity changes nothing")
CAPACITY_CENTRES = 1e-4


def probe_result(out: dict):
    """A ``capacity_probe.probe_one`` record's per-frame lists as the
    fields ``check_slam_run`` reads."""
    import types

    traj = np.asarray(out["poses"], np.float32)
    return types.SimpleNamespace(
        states=np.asarray(out["states"]), n_frames=len(out["states"]),
        is_keyframe=np.asarray(out["is_keyframe"], bool),
        n_matches=np.asarray(out["n_matches"]), trajectory=traj,
        poses_raw=traj)


def widened_match_bounds(base, others) -> tuple:
    """The largest ``n_matches`` difference and the share of RUNNING frames
    that differ between a reference run ``base`` and each of ``others``
    (its own runs under other noise or another summation order), each a
    (matches, states) pair, widened as ``long_ranges`` widens (the range
    from 0 to the largest, by its width), at least the same-draws bounds
    (2, 15 %)."""
    worst, share = 0, 0.0
    for matches, states in others:
        both = (base[1] == 2) & (states == 2)
        dm = np.abs(matches.astype(np.int64)
                    - base[0].astype(np.int64))[both]
        worst, share = max(worst, int(dm.max())), max(share,
                                                      float((dm > 0).mean()))
    return max(2 * worst, 2), max(2 * share, 0.15)


def probe_match_bounds(rec) -> tuple:
    """``widened_match_bounds`` of the record's JAX probe runs at K = 100
    under seeds 1, 2 against seed 0 (the reference's own spread under
    other RANSAC noise)."""
    runs = list(zip(rec["probe_n_matches"], rec["probe_state"]))
    return widened_match_bounds(runs[0], [
        runs[i] for i in np.flatnonzero(rec["probe_seeds"] > 0)])


def run_capacity_phase(card: str) -> dict:
    """Phase capacity (see the module docstring): the JAX package's
    capacity probe at K = 100, 300 and 1000, each K held to the JAX record
    at that K and the three to each other."""
    from sdvl_tpu_torch.tools import capacity_probe as cp
    from sdvl_tpu_torch.tools.long_run import default_workers

    rec = np.load(ZURICH_NPZ)
    proto = json.loads(bytes(rec["protocol"]).decode())
    n = proto["probe_frames"]
    scene, cfg = cp.probe_config()
    poses, frames = cp.probe_frames(scene, n, default_workers("cuda"))
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    want = bytes(rec["probe_frames_sha256"]).decode()
    assert h.hexdigest() == want, (h.hexdigest(), want)
    gt = np.stack(poses).astype(np.float32)
    assert np.abs(gt - rec["probe_poses_gt"]).max() <= 1e-6
    seeds = rec["probe_seeds"]
    ks = rec["probe_ks"][seeds == 0].tolist()
    assert tuple(ks) == CAPACITY_KS, ks
    matches = probe_match_bounds(rec)
    say("capacity", f"n_matches against the JAX run at each K: within "
                    f"{matches[0]} on every RUNNING frame, apart on at most "
                    f"{100 * matches[1]:.1f} % of them (the JAX runs at K = "
                    f"{ks[0]} under seeds {seeds[seeds > 0].tolist()} "
                    f"against seed 0, widened as phase long widens: the card "
                    f"draws its own RANSAC noise)")
    runs = {}
    for i, K in enumerate(ks):
        reset_counts()
        out = cp.probe_one(K, frames, cfg, device="cuda")
        launches, caps = read_counts()
        out.update(launches=launches, captures=caps,
                   side_counts=side_counts())
        jrec = {"jax_state": rec["probe_state"][i].astype(np.int32),
                "jax_is_keyframe": rec["probe_is_keyframe"][i],
                "jax_n_matches": rec["probe_n_matches"][i].astype(np.int32),
                "jax_trajectory": rec["probe_trajectory"][i],
                "poses_gt": rec["probe_poses_gt"]}
        jrec["jax_n_keyframes"] = int(jrec["jax_is_keyframe"].sum()) + 1
        out["vs_jax"] = check_slam_run(probe_result(out), jrec,
                                       matches=matches)
        n_chunks = -(-n // cp.CHUNK)
        assert out["replays_per_chunk"] == [1] * n_chunks, out[
            "replays_per_chunk"]
        assert out["syncs_after_capture"] == 0, out["syncs_after_capture"]
        assert caps == 1 and frame_launches(launches, caps) == n, (launches,
                                                                   caps)
        runs[K] = out
        v = out["vs_jax"]
        say("capacity", f"K = {K}: held to the JAX record at K = {K} "
                        f"(bootstrap frame {v['bootstrap_frame']}, states "
                        f"and keyframe flags equal, n_matches apart on "
                        f"{v['frames_with_match_diff']} frames, at most "
                        f"{v['max_match_diff']}; ATE {v['ate_pct']:.3f} % of "
                        f"the extent); {out['step_ms_per_frame']:.3f} ms a "
                        f"frame = {out['fps']:.2f} frames/s, device "
                        f"{out['replay_ms_per_frame']:.3f} ms a frame of a "
                        f"chunk replay; first chunk {out['compile_s']:.3f} "
                        f"s, capture {out['capture_s'][cp.CHUNK]:.3f} s, "
                        f"pool {out['pool_mib'][cp.CHUNK]:.1f} MiB, map "
                        f"{out['map_state_mb']:.1f} MB; kernel launches "
                        f"{launches} = {n} frames + {launches - n}, "
                        f"small eigensolver {out['side_counts']['small_eig']}"
                        f", condition kernel "
                        f"{out['side_counts']['conditions']}")
    c_gt = camera_centres(gt)
    extent = float(np.linalg.norm(np.ptp(c_gt, axis=0)))
    centres = {K: camera_centres(np.asarray(runs[K].pop("poses"), np.float32))
               for K in ks}
    centres_j = {K: camera_centres(rec["probe_trajectory"][i])
                 for i, K in enumerate(ks)}
    apart = {}
    for K in ks[1:]:
        for k in ("states", "is_keyframe"):
            assert runs[K][k] == runs[ks[0]][k], f"K = {K}: {k} differ"
        apart[K] = dict(
            card=float(np.abs(centres[K] - centres[ks[0]]).max()),
            jax=float(np.abs(centres_j[K] - centres_j[ks[0]]).max()))
        bound = max(CAPACITY_CENTRES * extent, apart[K]["jax"])
        assert apart[K]["card"] <= bound, (K, apart[K], bound)
    say("capacity", f"the capacities against K = {ks[0]}: states and "
                    f"keyframe flags equal; largest camera-centre distance "
                    + ", ".join(f"K = {K} {v['card']:.3e} (the JAX record's "
                                f"own {v['jax']:.3e})"
                                for K, v in apart.items())
                    + f", extent {extent:.4f}; on {card}")
    for K in ks:
        for k in ("states", "is_keyframe", "n_matches"):
            runs[K].pop(k)
    return dict(runs=runs, extent=extent, frames=n, apart=apart)


# phase euroc's bounds against tests/data/torch_euroc_record.npz (the JAX
# stream over the shipped configs/euroc.cfg on a CPU, and its witness: the
# same run with its bootstrap frame stepped op by op). The world yaw about
# z between the card's run and the record's (the ground-plane alignment's
# gauge, ROADMAP.md "How the SLAM parity tests compare worlds") within
# this share of the witness's own (1.85e-3 rad; the port on the CPU
# 6.8e-4); the tilt beside it in rad (tests/test_torch_cli_parity.py's
# bound; the port on the CPU 1.8e-5, the witness 6.9e-6); the camera
# centres once the yaw is taken out, as a share of the trajectory's extent
# (the port on the CPU 9.2e-5, the witness 3.1e-5); global BA's points and
# centres on the recorded map as phase zurich holds them (ZURICH_POINTS)
EUROC_YAW = 1.0
EUROC_TILT = 1e-4
EUROC_CENTRES = 2e-4
EUROC_POINTS = 1.0


def keyframe_tie(r, rec, min_keyframe_its: int):
    """The first frame whose keyframe flag the run and the record part on,
    and whether that decision was a tie: the record's decision there
    within ``1.9 x`` the largest ``n_matches`` difference between the two
    runs since the record's previous keyframe (the frame's count and the
    running maximum the policy holds it against, times 0.9 at most, each
    move by that much: a larger margin cannot flip). Returns (None, ...)
    where the flags never part."""
    from sdvl_tpu_torch.pipeline.mapper import keyframe_margin

    apart = np.flatnonzero(r.is_keyframe != rec["jax_is_keyframe"])
    if not len(apart):
        return None, None, None
    i = int(apart[0])
    k, fsk = rec["jax_kf_policy"][i - 1]
    margin = keyframe_margin(int(rec["jax_n_matches"][i]), int(k),
                             int(fsk) + 1, min_keyframe_its)
    prev = np.flatnonzero(rec["jax_is_keyframe"][:i])[-1]
    moved = int(np.abs(r.n_matches - rec["jax_n_matches"])[prev + 1:i + 1]
                .max())
    return i, margin, abs(margin) <= 1.9 * moved


def check_witnessed_run(r, rec, cfg) -> dict:
    """Hold a run of ``cfg`` to a record with a witness
    (``torch_euroc_record.npz``): phase slam's criteria with the
    ``n_matches`` bounds ``widened_match_bounds`` takes from the witness
    (the record's JAX run with its bootstrap frame op by op; the same
    states), on every frame or,
    where the keyframe flags part on a tie (``keyframe_tie``), on the
    frames before it and, over the whole run, states equal, Sim(3) ATE
    under 3 % of the extent and the keyframe count within 1; then
    gauge-free: the world yaw about z against the record's within
    ``EUROC_YAW`` of the witness's own, the tilt within ``EUROC_TILT``, the
    camera centres, the yaw taken out, within ``EUROC_CENTRES`` of the
    extent. Raises on disagreement."""
    import types

    from sdvl_tpu_torch.io import evaluate

    matches = widened_match_bounds(
        (rec["jax_n_matches"], rec["jax_state"]),
        [(rec["witness_n_matches"], rec["jax_state"])])
    parted, margin, tie = keyframe_tie(r, rec, cfg.sdvl.min_keyframe_its)
    if parted is None:
        chk = check_slam_run(r, rec, matches=matches)
    else:
        assert tie, (f"keyframe flags part on frame {parted}, the record's "
                     f"decision {margin:.2f} matches from its threshold: "
                     f"not a tie; {first_divergence(r, rec)}")
        head = types.SimpleNamespace(
            n_frames=parted, **{k: getattr(r, k)[:parted] for k in (
                "states", "is_keyframe", "n_matches", "trajectory",
                "poses_raw")})
        chk = check_slam_run(head, rec, n=parted, matches=matches)
        assert (r.states == rec["jax_state"]).all(), "states differ"
        n_kf = int(r.is_keyframe.sum()) + 1
        assert abs(n_kf - int(rec["jax_n_keyframes"])) <= 1, n_kf
        c_gt = evaluate.positions_from_poses(rec["poses_gt"])
        start = chk["bootstrap_frame"]
        chk["ate"] = evaluate.ate_rmse(evaluate.positions_from_poses(
            r.trajectory)[start:], c_gt[start:], with_scale=True)
        chk["extent"] = float(np.linalg.norm(np.ptp(c_gt[start:], axis=0)))
        assert chk["ate"] < 0.03 * chk["extent"], chk
        chk.update(n_keyframes=n_kf, keyframes=np.flatnonzero(
            r.is_keyframe).tolist())
    c_j = evaluate.positions_from_poses(rec["jax_trajectory"])
    start = chk["bootstrap_frame"]
    yaw = {}
    for name, traj in (("run", r.trajectory),
                       ("witness", rec["witness_trajectory"])):
        rotvec, c = evaluate.world_rotation(rec["jax_trajectory"], traj)
        yaw[name] = dict(yaw=float(rotvec[2]),
                         tilt=float(np.abs(rotvec[:2]).max()),
                         centres=float(np.linalg.norm(c - c_j, axis=1)[
                             start:].max()))
    run, wit = yaw["run"], yaw["witness"]
    assert abs(run["yaw"]) <= EUROC_YAW * abs(wit["yaw"]), yaw
    assert run["tilt"] <= EUROC_TILT, yaw
    assert run["centres"] <= EUROC_CENTRES * chk["extent"], yaw
    chk.update(matches_bound=list(matches), keyframes_parted=parted,
               parted_margin=margin, world=yaw)
    return chk


def run_euroc_phase(card: str) -> dict:
    """Phase euroc (see the module docstring): ``configs/euroc.cfg`` as
    shipped, held against ``tests/data/torch_euroc_record.npz``."""
    from sdvl_tpu_torch.pipeline.config import intrinsics, load_cfg
    from sdvl_tpu_torch.tools.zurich_scale_smoke import (recorded_ba_map,
                                                        spread_against)

    rec = dict(np.load(EUROC_NPZ))
    proto = json.loads(bytes(rec["protocol"]).decode())
    with open(EUROC_CFG) as f:
        assert f.read() == proto["cfg"], (
            "stale record: configs/euroc.cfg is not the recorded run's "
            "(tests/make_torch_fixtures.py --euroc-record)")
    cfg = load_cfg(EUROC_CFG)
    n = proto["frames"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        poses, frames = write_cli_sequence(EUROC_CFG, tmp, n=n, extra=0,
                                           amp=proto["translation_amp"])
        h = hashlib.sha256()
        for f in frames:
            h.update(np.ascontiguousarray(f).tobytes())
        want = bytes(rec["frames_sha256"]).decode()
        assert h.hexdigest() == want, (h.hexdigest(), want)
        assert np.abs(poses - rec["poses_gt"]).max() <= 1e-6
        crop = tuple(d // 16 * 16 for d in frames[0].shape)
        say("euroc", f"rendered {n} frames at {frames[0].shape[0]}x"
                     f"{frames[0].shape[1]} through the lens of "
                     f"configs/euroc.cfg (d = {cfg.camera.dist}) in "
                     f"{time.perf_counter() - t0:.1f} s, SHA-256 equal to "
                     f"the record's; the step keeps {crop[0]}x{crop[1]}, "
                     f"detection levels "
                     + ", ".join(f"{crop[1] / 32 / 2 ** l:g}"
                                 for l in range(cfg.sdvl.max_fast_levels))
                     + f" cells of {cfg.sdvl.cell_size} across")

        # 1. the stream, fed the record's draws, against the record
        r, st, secs, sites, (launches, caps), replays = run_slam(
            cfg, frames, rec, time_frames=True, count_syncs=True)
        chk = check_witnessed_run(r, rec, cfg)
        assert r.is_keyframe[chk["bootstrap_frame"] + 1:].sum() >= 3, chk
        cap = capture_frame(replays)
        assert cap == 0 and replays == [1] * n, replays
        syncs = [len(x) for x in sites]
        assert not any(syncs[1:]), f"frames after the capture synchronised: " \
                                   f"{syncs}"
        assert caps == 1 and frame_launches(launches, caps) == n, (launches,
                                                                   caps)
        ms = per_state(r, [1e3 * x for x in secs], skip=cap)
        steady = [x for i, x in enumerate(secs) if i != cap]
        out["stream"] = dict(
            check=chk, launches=launches, captures=caps, frames=n,
            side_counts=st.side_counts, ms_by_state=ms,
            frames_per_s=len(steady) / sum(steady),
            capture_s=st.runner.capture_s,
            capture_frame_ms=1e3 * secs[cap],
            pool_mib=st.runner.pool_bytes / 2 ** 20, syncs=syncs)
        w = chk["world"]
        say("euroc", f"stream (graph path) against the record: {chk}")
        say("euroc", f"the worlds part by a yaw about z of "
                     f"{w['run']['yaw']:.3e} rad (the reference against "
                     f"itself, its bootstrap frame op by op: "
                     f"{w['witness']['yaw']:.3e}), tilt "
                     f"{w['run']['tilt']:.1e} (witness "
                     f"{w['witness']['tilt']:.1e}); camera centres "
                     f"{w['run']['centres']:.3e} apart once it is taken out "
                     f"(witness {w['witness']['centres']:.3e}; extent "
                     f"{chk['extent']:.4f}); keyframe flags part on frame "
                     f"{chk['keyframes_parted']} (the record's decision "
                     f"{chk['parted_margin']} matches from its threshold); "
                     f"n_matches bounds {chk['matches_bound']}")
        say("euroc", f"graph replays one per frame, captured at frame 0 "
                     f"({st.runner.capture_s:.3f} s of warm-up and capture, "
                     f"{1e3 * secs[cap]:.1f} ms for the frame, pool "
                     f"{out['stream']['pool_mib']:.1f} MiB); 0 "
                     f"synchronisations after it; kernel launches "
                     f"{launches} = {n} frames + {launches - n}; small "
                     f"eigensolver {st.side_counts['small_eig']}, condition "
                     f"kernel {st.side_counts['conditions']}")
        say("euroc", "ms per frame by state (synchronised per frame, "
                     "capture frame apart): "
                     + ", ".join(f"{k} {v['mean']:.2f} ({v['frames']} "
                                 f"frames)" for k, v in ms.items()
                                 if v["frames"])
                     + f"; {out['stream']['frames_per_s']:.3f} frames/s on "
                       f"{card}")
        del st

        # 2. global BA at the shipped 1000 slots on the recorded map
        m = recorded_ba_map(rec, cfg)
        reset_counts()
        g = timed_global_ba(m, intrinsics(cfg), graphs=True)
        b_side = side_counts()
        assert g["replays"] == 1 and not g["sync_sites"], (g["replays"],
                                                           g["sync_sites"])
        assert g["cg_iterations"], "global BA did not take the PCG path"
        S = rec["ba_kf_pose"].shape[0]
        mb = g["map"]
        sp = spread_against(
            mb.pt_pos.cpu().numpy(), mb.kf_pose[:S].cpu().numpy(),
            np.packbits(mb.obs_mask[:S].cpu().numpy(), axis=1), rec,
            EUROC_POINTS)
        assert not sp["apart"], sp["apart"]
        assert sp["obs_apart"] <= sp["own_obs_apart"], sp
        out["ba"] = dict(spread=sp, ms=g["ms"], replay_ms=g["replay_ms"],
                         capture_s=g["capture_s"],
                         pool_mib=g["pool_bytes"] / 2 ** 20,
                         cg_iterations=g["cg_iterations"],
                         side_counts=b_side)
        say("euroc", f"global BA at {cfg.sdvl.max_keyframes} slots on the "
                     f"recorded map ({int(rec['map_kf_valid'].sum())} "
                     f"keyframes, {int(rec['map_pt_valid'].sum())} points): "
                     f"one replay, 0 synchronisations; against the nearer of "
                     f"the reference's two runs, points {json.dumps(sp['points'])}"
                     f", centres {json.dumps(sp['centres'])}; the "
                     f"reference's own spread: points "
                     f"{json.dumps(sp['own']['points'])}, centres "
                     f"{json.dumps(sp['own']['centres'])}; gated "
                     f"observations apart {sp['obs_apart']} (own "
                     f"{sp['own_obs_apart']}); CG iterations per LM step "
                     f"{g['cg_iterations']}")
        say("euroc", f"global BA: {g['ms']:.1f} ms with the warm-up and "
                     f"capture ({g['capture_s']:.3f} s), replay "
                     f"{g['replay_ms']:.1f} ms, pool "
                     f"{g['pool_bytes'] / 2 ** 20:.1f} MiB; on {card}")
        del m, mb, g

        # 3. the command-line program with the shipped config
        txt = os.path.join(tmp, "euroc.txt")
        r1 = run_cli(["--config", EUROC_CFG, "--images", tmp, "--stream",
                      "--global-ba", "--output", txt, "--quiet"])
        res1 = r1["result"]
        running = res1.states == 2
        start = int(np.argmax(running))
        assert running.any() and running[start:].all(), res1.states.tolist()
        gt = poses[:n]
        ate_before = sim3_ate_pct(
            camera_centres(r1["traj_before"][start:]), gt[start:])
        rows = tum_rows(txt, n)
        ate_after = sim3_ate_pct(rows[start:, 1:4], gt[start:])
        assert ate_before < 3.0 and ate_after < 3.0, (ate_before, ate_after)
        assert r1["cg_iterations"], "global BA did not take the PCG path"
        assert r1["frame_launches"] == n, r1["launches"]
        assert r1["stream_replays"] == [1] * n, r1["stream_replays"]
        out["cli"] = dict(summary=r1["summary"], launches=r1["launches"],
                          captures=r1["captures"], frames=n,
                          replays=sum(r1["stream_replays"]),
                          ate_pct_before=ate_before, ate_pct_after=ate_after,
                          global_ba_ms=r1["gba_ms"],
                          cg_iterations=r1["cg_iterations"],
                          syncs_per_frame=float(np.mean(r1["frame_syncs"])))
        say("euroc", f"cli --stream --global-ba with configs/euroc.cfg: "
                     f"{r1['summary']}; RUNNING from frame {start} to the "
                     f"end; Sim(3) ATE {ate_before:.4f} % of the extent "
                     f"before global BA, {ate_after:.4f} % after; global BA "
                     f"{r1['gba_ms']:.1f} ms, CG iterations per LM step "
                     f"{r1['cg_iterations']}; one graph replay on each of "
                     f"the {n} frames")
        say("euroc", "cli: " + per_frame(r1, card))
    return out


def small_eig_entries(eig, slam, graph, chunk, host, long, new_paths,
                      card) -> list:
    """The ``kernels`` line's entries of the small eigensolver's two
    kernels: launches by path (counted by each kernel), errors against the
    plain version over every checked case, times at the bootstrap's largest
    call of each (``eigh``: the RANSAC batch; every shape in
    ``by_shape``)."""
    paths = {"slam": slam["side_counts"], "slam_eager": graph["side_counts"],
             "chunk": chunk["side_counts"], "host": host["side_counts"],
             "host_eager": host["eager_side_counts"],
             "long": long["side_counts"],
             **{k: v["side_counts"] for k, v in new_paths.items()}}
    frames = {"slam": slam["frames"], "slam_eager": graph["eager_frames"],
              "chunk": chunk["frames"], "host": host["frames"],
              "host_eager": host["eager_frames"], "long": long["frames"],
              **{k: v["frames"] for k, v in new_paths.items()}}
    out = []
    for kernel, prefix, timed, replaces in (
            ("eigh", "eigh_", "eigh_ransac_9x9",
             "torch.linalg.eigh; the reference's jnp.linalg.eigh at "
             "sdvl_tpu/solvers/homography.py:39 and "
             "sdvl_tpu/core/geometry.py:217"),
            ("svd3", "svd_", "svd_3x3",
             "torch.linalg.svd; the reference's jnp.linalg.svd at "
             "sdvl_tpu/solvers/homography.py:100")):
        checked = [v for k, v in eig.items()
                   if k.startswith(prefix) and "max_abs_err" in v]
        t = eig[timed]
        out.append({
            "name": f"small_eig_{kernel}",
            "route": "cuda",
            "source": "sdvl_tpu_torch/csrc/small_eig.cu",
            # the port's own kernel: it replaces no Pallas kernel
            "replaces": f"none (the port's own; in place of {replaces})",
            "launches": slam["side_counts"][kernel],
            "frames": slam["frames"],
            "launches_by_path": {k: v[kernel] for k, v in paths.items()},
            "frames_by_path": frames,
            # both kernels together, as PR 9 counted them
            "small_eig_launches_by_path": {k: v["small_eig"]
                                           for k, v in paths.items()},
            "max_abs_err": max(v["max_abs_err"] for v in checked),
            "rel_err": max(v["rel_err"] for v in checked),
            "min_abs_cos": min(v["min_abs_cos"] for v in checked),
            "shape": t["shape"],
            "ms": t["ms"],
            "launch_floor_ms": t["launch_floor_ms"],
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "ptxas": eig["ptxas"].get(f"{kernel}_kernel"),
            "by_shape": {k: v for k, v in eig.items()
                         if k.startswith(prefix)},
            "card": card,
        })
    return out


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
    from sdvl_tpu_torch.ops.cuda import graph_if, small_eig

    t0 = time.perf_counter()
    # one nvcc per source, started together
    libs = (detect, graph_if, small_eig)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for job in [pool.submit(lib.load_library, verbose=True)
                    for lib in libs]:
            job.result()
    say("build", f"csrc/detect.cu -> _build/libsdvl_detect.so, "
                 f"csrc/graph_if.cu -> _build/libsdvl_graph_if.so and "
                 f"csrc/small_eig.cu -> _build/libsdvl_small_eig.so in "
                 f"{time.perf_counter() - t0:.1f} s ({' '.join(detect.NVCC_FLAGS)})")
    # ---------------------------------------------------------- 3 kernel
    t0 = time.perf_counter()
    checks, dp = run_kernel_phase()
    floor = launch_floor_ms()
    say("kernel", f"an empty <<<1,1>>> kernel node (1000 in one graph): "
                  f"{floor:.5f} ms of device time each")
    eig = check_small_eig(floor)
    cond = check_conditional_nodes(floor)
    say("kernel", f"phase took {time.perf_counter() - t0:.1f} s")
    cfg = preset_config()
    query = dict(np.load(QUERY_NPZ))

    # ------------------------------------------------------------ 4 slam
    t0 = time.perf_counter()
    slam = run_slam_phase(card)
    say("slam", f"phase took {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------------------------- graph
    t0 = time.perf_counter()
    graph = run_graph_phase(card, slam)
    say("graph", f"phase took {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------------------------- chunk
    t0 = time.perf_counter()
    chunk = run_chunk_phase(card, slam)
    chunk["per_frame_async_frames_per_s"] = graph["graph_async_frames_per_s"]
    say("chunk", f"per-frame graph path with nothing synchronised between "
                 f"frames (phase graph): "
                 f"{graph['graph_async_frames_per_s']:.3f} frames/s; chunks "
                 f"of {CHUNK} back to back: "
                 f"{chunk['back_to_back_frames_per_s']:.3f} frames/s")
    say("chunk", f"phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ host
    t0 = time.perf_counter()
    host = run_host_phase(card, slam)
    say("host", f"phase took {time.perf_counter() - t0:.1f} s")
    for k in [k for k in slam if k.startswith("_")]:
        del slam[k]

    # ----------------------------------------------------------- 5 slice
    t_phase = time.perf_counter()
    n = len(query["frames"])
    _, cold_s, _, _ = run_slice(cfg, query, count_launches=False)
    say("slice", f"first run (cold: cuBLAS/cuSOLVER set-up, allocator): "
                 f"{n} frames in {cold_s:.3f} s")
    r, seconds, (launches, slice_caps), loc = run_slice(
        cfg, query, count_launches=True)
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
    assert slice_caps == 1 and frame_launches(launches, slice_caps) == n, (
        f"kernel launches {launches} with {slice_caps} captures: one per "
        f"frame ({n}) and one per eager pass of the capture expected")
    n_corners = int(loc.last_corners.valid.sum())
    assert n_corners > 0, "fused detection found no corner on the last frame"
    vs_jax = {}
    for route, res in (("plain", r), ("pallas", run_slice(
            preset_config(use_pallas_detect=True), query,
            count_launches=False)[0])):
        vs_jax[route] = dict(
            states_equal=bool((res.states == query["jax_state"]).all()),
            max_match_diff=int(np.abs(res.n_matches
                                      - query["jax_n_matches"]).max()),
            max_centre_dist=float(np.linalg.norm(
                camera_centres(res.poses_raw)
                - camera_centres(query["jax_pose"]), axis=1).max()))
    say("slice", f"RUNNING from frame {int(np.argmax(running))}, "
                 f"{frac:.2f} of RUNNING frames >= {min_matches} matches, "
                 f"ATE {ate:.5f} over extent {extent:.4f} "
                 f"({100 * ate / extent:.2f} %), map bit-identical, "
                 f"kernel launches {launches} = 1 x {n} frames + "
                 f"{launches - n} in the capture's eager passes, corners on "
                 f"last "
                 f"frame {n_corners}")
    say("slice", "against the recorded JAX run (CPU, plain detection), "
                 "the plain border rule (this route) beside the pallas rule "
                 "(the route the earlier slices ran on the card): "
                 + "; ".join(f"{k}: states equal {v['states_equal']}, max "
                             f"|n_matches diff| {v['max_match_diff']}, "
                             f"largest camera-centre distance "
                             f"{v['max_centre_dist']:.3g}"
                             for k, v in vs_jax.items()))
    cap_s = loc.runner.capture_s
    # every frame a replay with no synchronisation but the capture frame's,
    # and bit-identical to the eager card path
    g_syncs, g_replays, g_rows = slice_syncs(cfg, query, graphs=True)
    e_syncs, _, e_rows = slice_syncs(cfg, query, graphs=False)
    assert g_replays == [1] * n, g_replays
    assert not any(g_syncs[1:]), f"serving frames synchronised: {g_syncs}"
    assert torch.equal(g_rows, e_rows), (
        "localizer: graph path differs from the eager card path on frames "
        f"{torch.nonzero((g_rows != e_rows).any(1)).flatten().tolist()}")
    say("slice", f"graph path: one replay per frame {g_replays}, "
                 f"synchronisations per frame {g_syncs} (the first frame "
                 f"captures), eager card path {e_syncs}; packed infos "
                 f"bit-identical to the eager card path")
    say("slice", f"{n} frames in {seconds:.4f} s (graph path, the capture "
                 f"{cap_s:.3f} s included) = {n / (seconds - cap_s):.2f} "
                 f"frames/s with the capture apart, one stream, on {card}; "
                 f"phase took {time.perf_counter() - t_phase:.1f} s")
    slice_out = dict(graph_syncs=g_syncs, eager_syncs=e_syncs,
                     replays=g_replays, capture_s=cap_s,
                     frames_per_s=n / (seconds - cap_s))

    # ----------------------------------------------------------- 6 multi
    t0 = time.perf_counter()
    multi = run_multi_phase(card, r, query)
    say("multi", f"phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------- 7 cli
    t0 = time.perf_counter()
    cli = run_cli_phase(card)
    say("cli", f"phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ 8 dist
    t0 = time.perf_counter()
    dist_out = run_dist_phase(card, cli.pop("_map100"))
    say("dist", f"phase took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ 9 long
    t0 = time.perf_counter()
    long_out = run_long_phase(card)
    long_lanes = run_long_phase(card, LONG_LANES_NPZ, "long_lanes")
    say("long", f"phase took {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------- zurich
    t0 = time.perf_counter()
    zurich = run_zurich_phase(card)
    say("zurich", f"phase took {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------- capacity
    t0 = time.perf_counter()
    capacity = run_capacity_phase(card)
    say("capacity", f"phase took {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------------------------- euroc
    t0 = time.perf_counter()
    euroc = run_euroc_phase(card)
    say("euroc", f"phase took {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------- 10 kernels
    new_paths = {"long_lanes": long_lanes, "zurich_serve": zurich, **{
        f"capacity_{K}": v for K, v in capacity["runs"].items()},
        "euroc": euroc["stream"]}
    on_paths = (("slam", slam), ("chunk", chunk), ("host", host),
                ("long", long_out), *new_paths.items())
    conditions = {k: v["side_counts"]["conditions"] for k, v in on_paths}
    pairs = {k: v["side_counts"]["pairs"] for k, v in on_paths}
    # a condition per branch: a pair's second node had a launch of its own
    per_branch = {k: conditions[k] + pairs[k] for k in conditions}
    for k in conditions:
        # every frame of the stream dispatches on its state with a pair,
        # every run of the host driver at least once (the seed stage's)
        least_pairs = (1 if k in ("host", "zurich_serve")
                       else dict(on_paths)[k]["frames"])
        assert least_pairs <= pairs[k] <= conditions[k], (
            f"{k}: {pairs[k]} if/else pairs in {conditions[k]} "
            f"condition-kernel launches, at least {least_pairs} expected")
    say("kernels", "condition-kernel launches by path (counted by the "
                   "kernel) "
                   + ", ".join(f"{k} {conditions[k]}, of them {pairs[k]} "
                               f"if/else pairs, each one launch where a "
                               f"condition per branch would be two "
                               f"({per_branch[k]})" for k in conditions))
    p3, p3_plain = checks["pallas"]["pyramid"], checks["plain"]["pyramid"]
    paths = {"slam": (slam["launches"], slam["frames"], slam["captures"]),
             "slam_eager": (graph["eager_launches"], graph["eager_frames"],
                            0),
             "chunk": (chunk["launches"], chunk["frames"], chunk["captures"]),
             "host": (host["launches"], host["frames"], host["captures"]),
             "host_eager": (host["eager_launches"], host["eager_frames"],
                            0),
             "slam_map_served": (slam["loc_launches"], slam["loc_frames"],
                                 slam["loc_captures"]),
             "localizer": (launches, n, slice_caps),
             "long": (long_out["launches"], long_out["frames"],
                      long_out["captures"]),
             **{k: (v["launches"], v["frames"], v["captures"])
                for k, v in new_paths.items()}}
    paths.update({k: (v["launches"], v["frames"], v["captures"])
                  for k, v in multi.items()})
    paths.update({f"cli_{k}": (cli[k]["launches"], cli[k]["frames"],
                               cli[k]["captures"])
                  for k in ("stream", "host", "host_1000", "async",
                            "async_1000", "viz")})
    paths["euroc_cli"] = (euroc["cli"]["launches"], euroc["cli"]["frames"],
                          euroc["cli"]["captures"])
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
        # (for the multi paths, stream-frames)
        "launches_by_path": {k: v[0] for k, v in paths.items()},
        "frames_by_path": {k: v[1] for k, v in paths.items()},
        "captures_by_path": {k: v[2] for k, v in paths.items()},
        "localizer_frames_per_s": slice_out["frames_per_s"],
        "max_abs_err": max(c["max_abs_err"] for by in checks.values()
                           for c in by.values()),
        # the pallas border rule (the earlier slices' route) in "ms" and
        # its neighbours, the plain rule (the shipped configs') beside
        "ms": p3["ms"],
        "plain_border_ms": p3_plain["ms"],
        "plain_border_plain_ms": p3_plain["plain_ms"],
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
        "graph": graph,
        "host": host,
        "slice": slice_out,
        "slice_vs_jax": vs_jax,
        "multi": multi,
        "cli": {k: {kk: vv for kk, vv in v.items() if kk != "trace"}
                for k, v in cli.items()},
        "dist": dist_out,
        "chunk": chunk,
        "long": long_out,
        "long_lanes": long_lanes,
        "zurich": zurich,
        "capacity": capacity,
        "euroc": {"stream": {k: v for k, v in euroc["stream"].items()
                             if k != "side_counts"},
                  "ba": {k: v for k, v in euroc["ba"].items()
                         if k != "side_counts"},
                  "cli": euroc["cli"]},
        "conditional_nodes": cond,
        "card": card,
    }, *small_eig_entries(eig, slam, graph, chunk, host, long_out,
                          new_paths, card), {
        "name": "set_condition_kernel",
        "route": "cuda",
        "source": "sdvl_tpu_torch/csrc/graph_if.cu",
        # the port's own: the condition of each IF and WHILE node, where the
        # reference's device programs branch and loop inside XLA
        "replaces": "none (the port's own; the condition of the CUDA "
                    "graphs' IF and WHILE nodes, in place of the "
                    "reference's lax.cond/switch/while_loop at "
                    "sdvl_tpu/pipeline/device_fsm.py and "
                    "sdvl_tpu/solvers/ba.py)",
        "launches": slam["side_counts"]["conditions"],
        "frames": slam["frames"],
        "launches_by_path": dict(
            conditions, zurich_ba=zurich["ba_side_counts"]["conditions"],
            euroc_ba=euroc["ba"]["side_counts"]["conditions"]),
        "frames_by_path": {k: v["frames"] for k, v in on_paths},
        "pairs_by_path": dict(
            pairs, zurich_ba=zurich["ba_side_counts"]["pairs"],
            euroc_ba=euroc["ba"]["side_counts"]["pairs"]),
        # with a condition per branch: the launches and a second per pair
        "per_branch_launches_by_path": per_branch,
        # the condition it sets was checked exact (phase kernel)
        "max_abs_err": 0.0,
        # one IF node with an empty body; the plain version is the eager
        # path's host read of the predicate
        "ms": cond["if_node_ms"],
        "plain_ms": cond["host_read_ms"],
        "bound_ms": cond["bound_ms"],
        "bound_by": cond["bound_by"],
        "library_ms": None,
        "launch_floor_ms": cond["launch_floor_ms"],
        "if_else_pair_ms": cond["if_else_pair_ms"],
        "two_if_nodes_ms": cond["two_if_nodes_ms"],
        "fori_iteration_ms": cond["fori_iteration_ms"],
        "counted_while_iteration_ms": cond["counted_while_iteration_ms"],
        "while_iteration_ms": cond["iteration_ms"],
        "ptxas": cond["ptxas"].get("set_condition_kernel"),
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
