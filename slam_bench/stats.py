"""The arithmetic of the metrics: rates, percentiles, spreads and the busy
and idle time of a device timeline. Plain Python and numpy."""

from __future__ import annotations

import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    order statistics (numpy's default)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(v, q))


def rate(count: int, seconds: float) -> float:
    """Work per second over a window; the window must have length."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median, by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    iv = sorted((float(a), float(b)) for a, b in intervals if b > a)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in iv:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, start: float, end: float) -> list:
    """The idle stretches (start, end) of [start, end] that no interval
    covers, longest first."""
    iv = sorted((max(float(a), start), min(float(b), end))
                for a, b in intervals if b > a)
    out, t = [], start
    for a, b in iv:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return sorted(out, key=lambda g: g[0] - g[1])
