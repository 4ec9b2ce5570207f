"""Where a localizer frame's time goes on the GPU: a torch.profiler trace
of the eager card path (``graphs=False``).

Runs the localization-only stream at the tum_f1 preset shape on the committed
fixtures (``tests/data/torch_localize_*.npz``), warms up on the first frames,
then profiles a steady window and prints

* wall time per frame of the window and the frames per second,
* wall time per stage of the step (pyramid, detection, direct alignment,
  matching, RANSAC, pose optimisation), the device waited for around each,
* the device's busy share (sum of kernel and memcpy time over wall time),
* launches, memcpys and synchronisations per frame,
* the top operators by device time and by host time.

    python -m sdvl_tpu_torch.tools.profile_localizer [--frames 6] [--out DIR]

With ``--out`` the tables are also written to ``DIR/profile_localizer.txt``
and, with ``--trace``, the timeline to ``DIR/profile_localizer_trace.json``
(tens of MB for a few frames).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


STAGES = (
    ("ops.pyramid", "build_pyramid"),
    ("ops.fast", "detect_pyramid"),
    ("pipeline.relocalize", "relocalize"),
    ("solvers.image_align", "compute_pose"),
    ("pipeline.matcher", "match_map_points"),
    ("solvers.pose", "ransac"),
    ("solvers.pose", "optimize"),
)


def stage_times(loc, window):
    """Wall time per stage over ``window``: each stage function is wrapped
    to wait for the device before and after itself, so a stage's time is
    its host time plus its device time, with nothing overlapped. Returns
    ({stage: ms per frame}, ms per frame of the whole step)."""
    import importlib

    totals, originals = {}, []
    for mod_name, fn_name in STAGES:
        mod = importlib.import_module(f"sdvl_tpu_torch.{mod_name}")
        fn = getattr(mod, fn_name)
        label = f"{mod_name}.{fn_name}"
        totals[label] = 0.0

        def timed(*a, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            totals[_label] += time.perf_counter() - t0
            return out

        originals.append((mod, fn_name, fn))
        setattr(mod, fn_name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc.feed_chunk(window, block=True)
        whole = time.perf_counter() - t0
    finally:
        for mod, fn_name, fn in originals:
            setattr(mod, fn_name, fn)
    n = len(window)
    return {k: 1e3 * v / n for k, v in totals.items()}, 1e3 * whole / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=6,
                    help="frames per measured window (three windows)")
    ap.add_argument("--warm", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="with --out: also export the timeline (large)")
    ap.add_argument("--plain-detect", action="store_true",
                    help="route detection through the plain torch version")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("profile_localizer needs a GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)

    import chip_smoke
    from sdvl_tpu_torch.pipeline.stream import SdvlStream
    from torch.profiler import ProfilerActivity, profile

    card = chip_smoke.gpu_line()
    cfg = chip_smoke.preset_config()
    if args.plain_detect:
        # the kernel's plain version in the wrapper's place, on the card
        from sdvl_tpu_torch.ops.cuda import detect

        detect.fast_shi_tomasi_cells = detect.fast_shi_tomasi_cells_plain
    query = dict(np.load(chip_smoke.QUERY_NPZ))
    gumbel = query["gumbel"]
    # the eager card path: the stage clocks wait for the device, which a
    # graph capture cannot
    loc = SdvlStream.localizer(cfg, chip_smoke.MAP_NPZ, seed=1,
                               device="cuda",
                               gumbel_provider=lambda i: gumbel[i],
                               graphs=False)
    frames = query["frames"]
    if args.warm + 3 * args.frames > len(frames):
        ap.error(f"warm + 3 * frames exceeds the {len(frames)} query frames")
    per_frame = []
    for f in frames[: args.warm]:
        t0 = time.perf_counter()
        loc.feed(f, block=True)
        per_frame.append(1e3 * (time.perf_counter() - t0))

    # un-profiled steady window first: the profiler itself slows the host
    t0 = time.perf_counter()
    loc.feed_chunk(frames[args.warm: args.warm + args.frames], block=True)
    plain_s = time.perf_counter() - t0

    lo = args.warm + args.frames
    stages, stage_whole = stage_times(loc, frames[lo: lo + args.frames])
    lo += args.frames
    window = frames[lo: lo + args.frames]
    n = len(window)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loc.feed_chunk(window, block=True)
        prof_s = time.perf_counter() - t0
    r = loc.result()

    ka = prof.key_averages()
    # device rows only: operator rows repeat their kernels' time
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    memcpy = sum(e.count for e in ka if e.key.startswith("cudaMemcpy"))
    syncs = sum(e.count for e in ka if "Synchronize" in e.key)
    lines = [
        f"card: {card}",
        f"torch {torch.__version__}, detection "
        f"{'plain' if args.plain_detect else 'fused kernel'}",
        f"states of all fed frames: {r.states.tolist()}",
        "warm-up frames, each fed and waited for on its own (frame 0 "
        "relocalizes), ms: " + ", ".join(f"{t:.1f}" for t in per_frame),
        f"steady window without profiler: {args.frames} frames in "
        f"{plain_s:.4f} s = {args.frames / plain_s:.2f} frames/s "
        f"({1e3 * plain_s / args.frames:.2f} ms/frame)",
        f"stage-timed window (device waited for around each stage), ms per "
        f"frame of {stage_whole:.2f}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f", rest {stage_whole - sum(stages.values()):.2f}",
        f"profiled window: {n} frames in {prof_s:.4f} s",
        f"device time in the profiled window: {dev_us / 1e3:.2f} ms = "
        f"{100 * dev_us / 1e6 / prof_s:.1f} % busy, "
        f"{100 - 100 * dev_us / 1e6 / prof_s:.1f} % idle",
        f"per frame: {launches / n:.0f} cudaLaunchKernel, "
        f"{memcpy / n:.1f} cudaMemcpy*, {syncs / n:.1f} synchronisations, "
        f"{dev_us / 1e3 / n:.3f} ms of device time",
        "",
        "top by device time:",
        ka.table(sort_by="self_cuda_time_total", row_limit=25,
                 max_name_column_width=60),
        "top by host time:",
        ka.table(sort_by="self_cpu_time_total", row_limit=25,
                 max_name_column_width=60),
    ]
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_localizer.txt"), "w") as f:
            f.write(text + "\n")
        if args.trace:
            prof.export_chrome_trace(
                os.path.join(args.out, "profile_localizer_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
