"""Kernel records in the traced stretch over its frames."""

from slam_bench.metrics import _common


def read(run, spec):
    if not _common.traced(run):
        return None
    return len(run.trace["kernels"]) / run.trace_steps
