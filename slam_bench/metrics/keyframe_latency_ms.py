"""Median over the window's keyframe frames (``FrameInfo.is_keyframe``) of
the time from handing the frame to the program until its result is read
on the host, in ms: the latency spike a map builder feels when a frame
becomes a keyframe (mapping, local BA and depth filters run in its
step)."""

import numpy as np

from slam_bench.metrics import _common


def read(run, spec):
    sel = _common.rows(run)[:, 8] == 1
    if not sel.any():
        return None
    return float(np.median(_common.latencies_ms(run)[sel]))
