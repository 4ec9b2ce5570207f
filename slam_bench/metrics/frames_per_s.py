"""Frames whose result the harness read on the host, over the whole
window."""

from slam_bench import stats


def read(run, spec):
    return stats.rate(len(run.steps), run.window_s)
