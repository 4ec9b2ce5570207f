"""Where a full-SLAM frame's time goes on the GPU, by what the frame runs,
on the eager card path (``graphs=False``: one launch per op, as a graph
replays them).

Runs the map-building stream at the tum_f1 preset shape over the frames that
``chip_smoke.py`` renders (the 85 of ``tests/data/torch_slam_record.npz``,
which insert keyframes after the bootstrap), with the record's detection
route and fed its draws, and prints

* wall time per stage of the step, per frame, by what the frame ran (FIRST,
  SECOND, RUNNING without a keyframe, keyframe frames): each stage function
  waits for the device before and after itself, so a stage's time is its
  host time plus its device time, with nothing overlapped; the pose IRLS
  (``solvers.pose.optimize``) is timed too, as a part of ``track_frame``;
* for a profiled window of RUNNING frames and for the keyframe frames:
  launches, memcpys and synchronisations per frame, device time and the
  device's busy share;
* the top operators by device time of the RUNNING window.

    python -m sdvl_tpu_torch.tools.profile_slam [--out DIR]

With ``--out`` the report is also written to ``DIR/profile_slam.txt``.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np
import torch

# (module under sdvl_tpu_torch, function): stages that never nest in one
# another on the step's path
STAGES = (
    ("ops.pyramid", "build_pyramid"),
    ("ops.fast", "detect_pyramid"),
    ("pipeline.bootstrap", "init_two_view"),
    ("pipeline.mapper", "transform_initial_map"),
    ("pipeline.tracker", "track_frame"),
    ("pipeline.tracker", "update_point_stats"),
    ("pipeline.mapper", "add_keyframe"),
    ("pipeline.mapper", "local_ba"),
    ("pipeline.mapper", "prune_weak_points"),
    ("pipeline.depth_filter", "update_candidates"),
    ("pipeline.depth_filter", "promote_converged"),
    ("pipeline.mapper", "check_redundant_keyframes"),
)
# stages inside one of the above, reported beside it and not in "rest"
NESTED = (
    ("solvers.pose", "optimize"),    # the pose IRLS, inside track_frame
)


class StageClock:
    """Wraps the stage functions; ``frame`` collects one frame's times."""

    def __init__(self):
        self.frame = {}
        self._originals = []

    def __enter__(self):
        for mod_name, fn_name in STAGES + NESTED:
            mod = importlib.import_module(f"sdvl_tpu_torch.{mod_name}")
            fn = getattr(mod, fn_name)

            def timed(*a, _fn=fn, _label=fn_name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.frame[_label] = (self.frame.get(_label, 0.0)
                                      + 1e3 * (time.perf_counter() - t0))
                return out

            self._originals.append((mod, fn_name, fn))
            setattr(mod, fn_name, timed)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self._originals:
            setattr(mod, fn_name, fn)


def profiled(st, frames):
    """Feed ``frames`` under torch.profiler; returns per-frame counts and
    times and the key averages."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            st.feed(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    n = len(frames)
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    memcpy = sum(e.count for e in ka if e.key.startswith("cudaMemcpy"))
    syncs = sum(e.count for e in ka if "Synchronize" in e.key)
    line = (f"{n} frames, {1e3 * wall / n:.1f} ms per frame under the "
            f"profiler; per frame {launches / n:.0f} cudaLaunchKernel, "
            f"{memcpy / n:.1f} cudaMemcpy*, {syncs / n:.1f} synchronisations, "
            f"{dev_us / 1e3 / n:.3f} ms of device time; device "
            f"{100 * dev_us / 1e6 / wall:.1f} % busy, "
            f"{100 - 100 * dev_us / 1e6 / wall:.1f} % idle")
    return line, ka


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("profile_slam needs a GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    card = chip_smoke.gpu_line()
    rec = dict(np.load(chip_smoke.SLAM_NPZ))
    frames, _ = chip_smoke.render_preset_frames(rec)
    cfg = chip_smoke.preset_config(localize_only=False,
                                   use_pallas_detect=True)

    def stream():
        # the eager card path: the stage clocks wait for the device, which
        # a graph capture cannot
        return SdvlStream(cfg, seed=0, device="cuda",
                          gumbel_provider=chip_smoke.slam_draws(rec),
                          graphs=False)

    # warm-up run (kernel libraries, allocator), then the stage-timed run
    st = stream()
    for f in frames:
        st.feed(f)
    torch.cuda.synchronize()
    st = stream()
    per_frame = []
    with StageClock() as clock:
        for f in frames:
            clock.frame = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.feed(f)
            torch.cuda.synchronize()
            clock.frame["whole"] = 1e3 * (time.perf_counter() - t0)
            per_frame.append(clock.frame)
    r = st.result()
    groups = chip_smoke.state_groups(r)
    lines = [f"card: {card}", f"torch {torch.__version__}",
             f"states: {r.states.tolist()}",
             f"keyframe frames: {np.nonzero(r.is_keyframe)[0].tolist()}",
             "stage-timed run (device waited for around each stage), ms per "
             "frame:"]
    labels = [fn for _, fn in STAGES]
    nested = [fn for _, fn in NESTED]
    for name, mask in groups.items():
        idx = np.nonzero(mask)[0]
        if not len(idx):
            continue
        mean = {k: float(np.mean([per_frame[i].get(k, 0.0) for i in idx]))
                for k in labels + nested + ["whole"]}
        rest = mean["whole"] - sum(mean[k] for k in labels)
        lines.append(
            f"  {name} ({len(idx)} frames): whole {mean['whole']:.2f}; "
            + ", ".join(f"{k} {mean[k]:.2f}" for k in labels if mean[k] > 0)
            + f", rest {rest:.2f}; inside them: "
            + ", ".join(f"{k} {mean[k]:.2f}" for k in nested))

    # profiled windows on a fresh stream: RUNNING frames, then the
    # keyframe frames each fed alone
    st = stream()
    kf = [int(i) for i in np.nonzero(groups["keyframe"])[0]]
    lo = 10
    for f in frames[:lo]:
        st.feed(f)
    line, ka = profiled(st, frames[lo:lo + 6])
    lines.append(f"profiled RUNNING window: {line}")
    fed = lo + 6
    for i in kf:
        for f in frames[fed:i]:
            st.feed(f)
        line_kf, _ = profiled(st, frames[i:i + 1])
        lines.append(f"profiled keyframe frame {i}: {line_kf}")
        fed = i + 1
    lines += ["", "RUNNING window, top by device time:",
              ka.table(sort_by="self_cuda_time_total", row_limit=20,
                       max_name_column_width=60)]
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_slam.txt"), "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
