"""The detection kernel's (``csrc/detect.cu``) share of its roofline: the
least time its bytes need at the HBM peak (``peaks.detect_bytes`` of the
frame's shape) over its mean device time per launch in the traced
stretch, in %."""

import numpy as np

from slam_bench import peaks
from slam_bench.metrics import _common

KERNEL = "detect_levels_kernel"


def read(run, spec):
    if not _common.traced(run):
        return None
    d = [b - a for n, a, b in run.trace["kernels"] if KERNEL in n]
    if not d:
        return None
    cfg = spec["config"]["cfg"]
    levels = cfg.get("SDVL.pyramid_levels", 5)
    div = 1 << (levels - 1)
    h = cfg["Camera.height"] // div * div
    w = cfg["Camera.width"] // div * div
    nbytes = peaks.detect_bytes(h, w, min(cfg.get("SDVL.max_fast_levels", 3),
                                          levels),
                                cfg.get("SDVL.cell_size", 32))
    least_us = 1e6 * nbytes / peaks.HBM_BYTES_PER_S
    return 100.0 * least_us / float(np.mean(d))
