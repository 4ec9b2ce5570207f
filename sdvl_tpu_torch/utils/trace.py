"""Structured per-stage tracing and device profiling.

Counterpart of ``sdvl_tpu/utils/trace.py``:

  * :class:`Tracer` -- named spans with host wall-clock aggregation (count /
    mean / p50 / p95 / max), nestable (dotted names), exportable as JSON or
    JSONL; two ``perf_counter`` calls per span.
  * :func:`torch_profile` -- context manager around ``torch.profiler``: the
    device's own timeline, which the host stopwatch cannot see.

Spans measure host-observed latency. Work issued to a CUDA device runs
asynchronously, so a span around code that only issues kernels measures the
issue cost; ``block=True`` synchronises the tracer's device at span exit.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import torch


class Tracer:
    """Named-span wall-clock tracer with summary statistics. ``device`` is
    the CUDA device a ``block=True`` span waits for (none on the CPU)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self._spans: Dict[str, List[float]] = {}
        self._stack: List[str] = []
        self._events: List[dict] = []
        self._keep_events = False

    # ------------------------------------------------------------------ API
    @contextlib.contextmanager
    def span(self, name: str, block: bool = False):
        """Time a region. Nested spans get dotted names (``track.align``)."""
        if not self.enabled:
            yield
            return
        full = ".".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and self.device is not None \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = (time.perf_counter() - t0) * 1e3
            self._stack.pop()
            self._spans.setdefault(full, []).append(dt)
            if self._keep_events:
                self._events.append({"name": full, "t0": t0, "ms": dt})

    def keep_events(self, on: bool = True):
        """Also retain the raw per-span event list (for timelines)."""
        self._keep_events = on

    # -------------------------------------------------------------- reports
    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, xs in sorted(self._spans.items()):
            s = sorted(xs)
            n = len(s)
            out[name] = {
                "n": n,
                "mean_ms": round(sum(s) / n, 3),
                "p50_ms": round(s[n // 2], 3),
                "p95_ms": round(s[min(n - 1, int(n * 0.95))], 3),
                "max_ms": round(s[-1], 3),
                "total_ms": round(sum(s), 1),
            }
        return out

    def report(self) -> str:
        lines = [f"{'span':<28} {'n':>6} {'mean':>8} {'p50':>8} "
                 f"{'p95':>8} {'max':>8}  (ms)"]
        for name, st in self.summary().items():
            lines.append(
                f"{name:<28} {st['n']:>6} {st['mean_ms']:>8.3f} "
                f"{st['p50_ms']:>8.3f} {st['p95_ms']:>8.3f} "
                f"{st['max_ms']:>8.3f}"
            )
        return "\n".join(lines)

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def write_events_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self._events:
                f.write(json.dumps(e) + "\n")

    def reset(self) -> None:
        self._spans.clear()
        self._events.clear()


@contextlib.contextmanager
def torch_profile(logdir: str, timeline: bool = False):
    """Profile the enclosed region with ``torch.profiler`` (host and, where
    CUDA is available, device activity). At exit writes the operator table
    ``key_averages.txt`` into ``logdir``; with ``timeline`` also the Chrome /
    Perfetto trace ``trace.json``, which for a few SLAM frames runs to tens
    of MB. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=60))
    if timeline:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def sync_sites(fn) -> List[str]:
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``; the
    ``file:line`` of each synchronisation it made (none off the card)."""
    import warnings

    if not torch.cuda.is_available():
        fn()
        return []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        was = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(was)
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]
