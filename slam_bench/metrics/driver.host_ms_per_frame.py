"""Median time ``feed`` takes to return, before the result is read, per
frame, in ms: the host's share of a step."""

import numpy as np

from slam_bench.metrics import _common


def read(run, spec):
    return float(np.median(_common.host_ms(run)))
