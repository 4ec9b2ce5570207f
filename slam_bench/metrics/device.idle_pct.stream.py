"""Share of a frame's time in which nothing runs on the device, in %: one
less the median device time of a traced frame (the union of the kernels
that start between its ``feed`` and the next frame's, a tracking frame as
the median frame is) over the median time from one frame's hand-over to
the next's outside the traced stretch. The profiler slows the host
several times over while it records, so the traced stretch's own idle
share would measure the profiler; the device's work it records is the
program's."""

import numpy as np

from slam_bench.metrics import _common


def read(run, spec):
    if not _common.traced(run):
        return None
    busy = _common.traced_frame_busy_ms(run)
    gap = _common.untraced_frame_ms(run)
    if busy is None or gap is None:
        return None
    return 100.0 * (1.0 - float(np.median(busy)) / gap)
