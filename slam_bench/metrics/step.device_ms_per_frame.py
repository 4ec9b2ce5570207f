"""Union of the device's busy intervals in the traced stretch over its
frames, in ms."""

from slam_bench import trace
from slam_bench.metrics import _common


def read(run, spec):
    if not _common.traced(run):
        return None
    return trace.busy_us(run.trace) / 1e3 / run.trace_steps
