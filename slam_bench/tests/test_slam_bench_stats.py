"""The rate, percentile, spread and idle arithmetic on made-up timelines."""

import math

import numpy as np
import pytest

from slam_bench import drivers, reference, stats, trace
from slam_bench.tests.conftest import spec_of


def test_rate_and_percentiles():
    assert stats.rate(120, 4.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert reference.rank(v, 95) == 95
    assert reference.rank([1.0, math.inf, 2.0], 50) == 2.0
    assert reference.rank([1.0, math.inf], 90) == math.inf
    assert reference.rank([], 50) == math.inf


def test_spread_uses_statistics_quartiles():
    v = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, med, q3 = 9.875, 10.0, 10.125
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union_length(iv) == 4.0
    assert stats.gaps(iv, 0, 10) == [(6, 10), (3, 5)]
    assert stats.gaps([(-5, 20)], 0, 10) == []


def test_trace_reduce_and_breakdown():
    ev = [("bench.feed", False, 0.0, 10.0),
          ("bench.read", False, 10.0, 100.0),
          ("bench.feed", False, 100.0, 110.0),
          ("bench.read", False, 110.0, 200.0),
          ("void detect_levels_kernel<true>(Levels)", True, 12.0, 22.0),
          ("gemm", True, 22.0, 62.0),
          ("Memcpy DtoH", True, 95.0, 99.0),
          ("gemm", True, 120.0, 150.0),
          ("outside", True, 300.0, 400.0),
          ("bench.read", True, 10.0, 100.0)]
    tr = trace.reduce(ev)
    assert tr["window_us"] == (0.0, 200.0)
    assert len(tr["kernels"]) == 3 and len(tr["device"]) == 4
    assert trace.busy_us(tr) == 84.0
    # the idle share of a traced solve: 1 - 84 / 200
    from slam_bench import manifest

    run = drivers.Run("global_ba", trace=tr, trace_steps=2)
    idle = manifest.reader("device.idle_pct.ba")(run, None)
    assert idle == pytest.approx(58.0)
    # a stream's: the median traced frame's device time (54 and 30 us)
    # over the median hand-over to hand-over before the traced stretch
    # (its last two frames)
    t0 = [0.0, 0.1, 0.2, 0.35, 0.45, 0.55, 1.5, 1.6]
    run = drivers.Run("live_map", trace=tr, trace_at=6, trace_steps=2,
                      steps=[(t, t, t, None) for t in t0])
    idle = manifest.reader("device.idle_pct.stream")(run, None)
    assert idle == pytest.approx(100.0 * (1.0 - 0.042 / 100.0))
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "gemm"
    assert b["device_ops"][0][1] == pytest.approx(70e-6)
    assert b["idle_gaps"][0][0] == "read"
    assert b["idle_gaps"][0][1] == pytest.approx(50e-6)
    assert trace.reduce([("x", True, 0.0, 1.0)])["window_us"] is None


def test_metric_readers_on_a_made_up_run():
    from slam_bench import manifest

    run = drivers.Run("live_map")
    run.window_s = 2.0
    rows = np.zeros((8, 10))
    rows[:, 7] = 2
    rows[3, 8] = 1
    run.steps = [(i * 0.25, i * 0.25 + 0.01, i * 0.25 + 0.02 + 0.01 * i,
                  rows[i]) for i in range(8)]
    run.setup_s = 12.5
    run.counters = {"capture_s": 3.0}
    spec = spec_of("tum_f1.map")
    read = {n: manifest.reader(n)(run, spec) for n in (
        "frames_per_s", "keyframe_latency_ms", "setup_s",
        "driver.host_ms_per_frame", "mapping.keyframe_extra_ms",
        "tracking.running_ms", "step.capture_s", "step.kernels_per_frame",
        "kernels.detect_roofline")}
    assert read["frames_per_s"] == 4.0
    lat = [20.0 + 10.0 * i for i in range(8)]
    tracking = np.median([x for i, x in enumerate(lat) if i != 3])
    assert read["keyframe_latency_ms"] == pytest.approx(50.0)
    assert read["setup_s"] == 12.5
    assert read["driver.host_ms_per_frame"] == pytest.approx(10.0)
    assert read["mapping.keyframe_extra_ms"] == pytest.approx(
        50.0 - tracking)
    assert read["tracking.running_ms"] == pytest.approx(tracking)
    assert read["step.capture_s"] == 3.0
    # no trace: the device metrics find nothing to read
    assert read["step.kernels_per_frame"] is None
    assert read["kernels.detect_roofline"] is None


def test_roofline_bytes_of_the_preset_frame():
    from slam_bench import peaks

    # 640x480, three levels, 32-px cells: PERF.md's bound of 0.00096 ms
    b = peaks.detect_bytes(480, 640, 3, 32)
    assert b == 2 * 4 * (640 * 480 + 320 * 240 + 160 * 120) + 8 * 385
    assert b / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.000964, 1e-3)


def test_traced_stretch_closes_the_window(monkeypatch):
    """The profiler records the window's last steps, begun once the
    window's seconds have passed (or when only that many steps are left),
    and the window ends with them."""
    import time

    monkeypatch.setattr(trace, "start", lambda: "prof")
    monkeypatch.setattr(trace, "stop", lambda prof: {"window_us": (0, 1)})

    def step(i):
        time.sleep(0.01)
        return time.perf_counter(), None

    run = drivers.Run("live_map")
    drivers.timed_loop(run, 0.1, 10 ** 6, step, 3, "cpu")
    assert run.trace_steps == 3 and len(run.steps) == run.trace_at + 3
    assert run.steps[run.trace_at][0] - run.steps[0][0] >= 0.1
    run = drivers.Run("live_map")
    drivers.timed_loop(run, 60.0, 8, step, 3, "cpu")
    assert (run.trace_at, run.trace_steps, len(run.steps)) == (5, 3, 8)
    assert run.ran_out
