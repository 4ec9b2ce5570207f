"""What the metric readers share: the window's latencies and its frames
by kind, outside the traced stretch at its end, and that stretch's
frames."""

from __future__ import annotations

import numpy as np

from slam_bench import stats
from slam_bench.drivers import STATE_RUNNING as RUNNING


def untraced(run) -> list:
    """The window's steps before the traced stretch (all of them in a run
    without one)."""
    return run.steps[:run.trace_at] if run.trace_steps else run.steps


def latencies_ms(run) -> np.ndarray:
    """Each untraced step's time from handing it over to its result read,
    in ms."""
    return np.array([1e3 * (t2 - t0) for t0, _, t2, _ in untraced(run)])


def host_ms(run) -> np.ndarray:
    """Each untraced step's time from handing it over until ``feed``
    returned, in ms."""
    return np.array([1e3 * (t1 - t0) for t0, t1, _, _ in untraced(run)])


def rows(run) -> np.ndarray:
    """The untraced steps' rows, (frames, 10) (see ``program.pack``)."""
    return np.stack([s[3] for s in untraced(run)])


def tracking_frames(run) -> np.ndarray:
    """Which of the window's frames only tracked: RUNNING before and
    after, and not a keyframe, by the program's own ``FrameInfo``."""
    r = rows(run)
    prev = np.concatenate([[RUNNING], r[:-1, 7]])
    return (r[:, 7] == RUNNING) & (prev == RUNNING) & (r[:, 8] == 0)


def traced(run) -> bool:
    return (run.trace is not None and run.trace.get("window_us") is not None
            and run.trace_steps > 0)


def traced_frame_busy_ms(run):
    """Each traced frame's device time, in ms: the union of the device
    intervals that start between its ``feed`` span and the next frame's
    (the end of the traced stretch for the last); None without spans."""
    starts = sorted(a for n, a, _ in run.trace["host"] if n == "feed")
    if not starts:
        return None
    ends = starts[1:] + [run.trace["window_us"][1]]
    out = []
    for a, b in zip(starts, ends):
        out.append(stats.union_length(
            (s, min(e, b)) for _, s, e in run.trace["device"]
            if a <= s < b) / 1e3)
    return out


def untraced_frame_ms(run):
    """The median time from one frame's hand-over to the next's before the
    traced stretch, in ms; None where there are too few frames."""
    t0 = np.array([s[0] for s in untraced(run)])
    return float(np.median(1e3 * np.diff(t0))) if len(t0) > 1 else None
