"""Share of the traced stretch in which the device is idle while the host
is inside a graph's warm-up passes or its capture (the program's
``graph.warmup`` and ``graph.capture`` spans), in %: the part of
``device.idle_pct.ba`` that capturing in every call owns."""

from slam_bench import stats
from slam_bench.metrics import _program


def read(run, spec):
    spans = _program.spans_us(run)
    if spans is None:
        return None
    w0, w1 = run.trace["window_us"]
    idle = stats.gaps([(a, b) for _, a, b in run.trace["device"]], w0, w1)
    capture = [(a, b) for n, a, b in spans
               if n in ("graph.warmup", "graph.capture")]
    return 100.0 * _program.overlap_us(idle, capture) / (w1 - w0)
