"""Median latency of the window's tracking frames: RUNNING before and
after, and not a keyframe, by the program's own ``FrameInfo``, in ms."""

import numpy as np

from slam_bench.metrics import _common


def read(run, spec):
    sel = _common.tracking_frames(run)
    if not sel.any():
        return None
    return float(np.median(_common.latencies_ms(run)[sel]))
