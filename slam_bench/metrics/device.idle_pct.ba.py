"""Share of the traced stretch, one whole solve, in which nothing ran on
the device, in %. A solve is one graph replay after a capture whose host
work the profiler slows somewhat, so the share reads a little high."""

from slam_bench import trace
from slam_bench.metrics import _common


def read(run, spec):
    if not _common.traced(run):
        return None
    w0, w1 = run.trace["window_us"]
    return 100.0 * (1.0 - trace.busy_us(run.trace) / (w1 - w0))
