"""What the program's own tracer (``sdvl_tpu_torch/utils/trace.py``) kept
of the traced stretch: its spans on the profiler's clock, the global BA's
stage marks and its counters. Every function gives None where the program
has no such tracer or kept nothing, and raises nowhere."""

from __future__ import annotations

from slam_bench.metrics import _common


def tracer():
    """The program's process-wide tracer, or None."""
    from sdvl_tpu_torch.utils import trace

    fn = getattr(trace, "tracer", None)
    return fn() if callable(fn) else None


def stage_ms_per_solve(run, stage: str):
    """Device ms of the global BA's ``stage`` (the time from each of its
    marks to the next mark) per solve of the traced stretch; None where no
    solve of it read its marks or none holds the stage."""
    t = tracer()
    if t is None or not _common.traced(run):
        return None
    reads = [r["stages"] for r in getattr(t, "stages", [])
             if r.get("graph") == "global_ba"]
    if not any(stage in r for r in reads):
        return None
    return sum(r[stage]["ms"] for r in reads if stage in r) / run.trace_steps


def spans_us(run):
    """The program's closed spans as (name, start, end) in the profiler's
    us. The tracer's clock is the host's monotonic one and the profiler's
    is not, so each solve's spans are anchored on it: the program opens its
    ``global_ba`` span first thing in the call that the harness's
    ``global_ba`` span wraps, so the k-th of each start together (within
    microseconds); a span before the first solve takes the first anchor.
    None without spans or where the two counts of solves differ."""
    t = tracer()
    if t is None or not _common.traced(run):
        return None
    events = [e for e in getattr(t, "events", [])
              if e.get("t1_ns") is not None]
    roots = [e for e in events
             if e["name"] == "global_ba" and e["parent"] is None]
    bench = sorted(a for n, a, _ in run.trace["host"] if n == "global_ba")
    if not roots or len(roots) != len(bench):
        return None
    offsets = [b - e["t0_ns"] / 1e3 for e, b in zip(roots, bench)]
    out, k = [], 0
    for e in sorted(events, key=lambda e: e["t0_ns"]):
        while k + 1 < len(roots) and e["t0_ns"] >= roots[k + 1]["t0_ns"]:
            k += 1
        out.append((e["name"], e["t0_ns"] / 1e3 + offsets[k],
                    e["t1_ns"] / 1e3 + offsets[k]))
    return out


def overlap_us(gaps, spans) -> float:
    """The length of the stretches of ``gaps`` (disjoint (start, end)) that
    some span of ``spans`` covers."""
    merged = []
    for a, b in sorted((a, b) for a, b in spans if b > a):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in gaps for c, d in merged)
