"""What a keyframe adds to a frame's latency: the median latency of the
window's keyframe frames less that of its tracking frames (RUNNING before
and after, not a keyframe), in ms."""

import numpy as np

from slam_bench.metrics import _common


def read(run, spec):
    r = _common.rows(run)
    lat = _common.latencies_ms(run)
    kf = r[:, 8] == 1
    track = _common.tracking_frames(run)
    if not kf.any() or not track.any():
        return None
    return float(np.median(lat[kf]) - np.median(lat[track]))
