"""Host spans, device stage marks and counters of the program.

Counterpart of ``sdvl_tpu/utils/trace.py``. One process-wide
:class:`Tracer`, :func:`tracer`, serves the program: the host driver
``SDVL`` uses it where it is given none, the CLI's ``--trace`` enables it,
and ``mapper.global_ba``, ``device_fsm.StageGraph`` and the kernels' build
(``ops/cuda/detect.build_library``) report to it.

* **Spans.** A tracer is *active* while it is enabled or while a
  ``torch.profiler`` records. While active, each span is kept as an event
  (:attr:`Tracer.events`): its name, the index of the event of the span
  open around it on the same thread (``parent``, None at the top), and its
  start and end, ``t0_ns`` and ``t1_ns``, in ns of
  ``time.perf_counter_ns()``, the host's monotonic clock. The profiler's
  events carry another clock; a reader maps one onto the other by a span
  that both open at one moment (the benchmark anchors the program's
  ``global_ba`` span on its own). The summary aggregates each span's host
  wall-clock by its dotted path (``track.align``). While inactive, a span
  costs a flag check and records nothing. No span is a ``record_function``
  or an NVTX range: the profiler would count such a range as device work.
* **Stage marks** (:func:`mark`). A graph captured with ``marks`` (see
  ``StageGraph``) owns a :class:`Stages`, its accumulators on the card. A
  mark captured into it is a one-thread kernel, launched each time a
  replay reaches it (each iteration, in a loop's body), that reads the
  device's ``%globaltimer`` and adds the time since the previous mark to
  that mark's stage (``csrc/graph_if.cu``), so the stages partition the
  replay from its first mark to its last. Marks are captured only while
  the tracer is active, so an untraced graph holds none.
* **Counters** (:meth:`Tracer.count`): always on, for work whose cost
  dwarfs the count (``kernels.builds`` and ``kernels.build_s``, the
  compiler's runs and seconds).

Spans measure host-observed latency. Work issued to a CUDA device runs
asynchronously, so a span around code that only issues kernels measures the
issue cost; ``block=True`` synchronises the tracer's device at span exit.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

import torch

# stage accumulators per graph (csrc/graph_if.cu SDVL_MAX_STAGES)
MAX_STAGES = 16


def _profiling() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) records."""
    return torch.autograd.profiler._is_profiler_enabled


class Tracer:
    """Named spans, stage reads and counters (see the module note).
    ``device`` is the CUDA device a ``block=True`` span waits for (none on
    the CPU)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self.events: List[dict] = []
        self.stages: List[dict] = []
        self.counters: Dict[str, float] = {}
        self._spans: Dict[str, List[float]] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.enabled or _profiling()

    # ------------------------------------------------------------------ API
    @contextlib.contextmanager
    def span(self, name: str, block: bool = False):
        """Time a region (recorded while the tracer is active)."""
        if not self.active:
            yield
            return
        stack = self._stack()
        full = ".".join([s[1] for s in stack] + [name])
        ev = {"name": name, "parent": stack[-1][0] if stack else None,
              "t0_ns": time.perf_counter_ns(), "t1_ns": None}
        with self._lock:
            self.events.append(ev)
            at = len(self.events) - 1
        stack.append((at, name))
        try:
            yield
        finally:
            if block and self.device is not None \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            ev["t1_ns"] = time.perf_counter_ns()
            stack.pop()
            self._spans.setdefault(full, []).append(
                (ev["t1_ns"] - ev["t0_ns"]) / 1e6)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, name: str, value: float = 1) -> None:
        """Add ``value`` to counter ``name``, whether or not the tracer is
        active."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def record_stages(self, graph: str, read: Dict[str, dict]) -> None:
        """Keep one replay's stage read (:meth:`Stages.read`) of ``graph``."""
        self.stages.append({"graph": graph, "t_ns": time.perf_counter_ns(),
                            "stages": read})

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

    def stage_summary(self) -> Dict[str, dict]:
        """Per graph: its stage reads (``reads``), and each stage's device
        ms and marks summed over them."""
        out: Dict[str, dict] = {}
        for r in self.stages:
            g = out.setdefault(r["graph"], {"reads": 0, "ms": {},
                                            "marks": {}})
            g["reads"] += 1
            for name, st in r["stages"].items():
                g["ms"][name] = g["ms"].get(name, 0.0) + st["ms"]
                g["marks"][name] = g["marks"].get(name, 0) + st["marks"]
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
        for graph, g in self.stage_summary().items():
            lines.append(f"stages of {graph} (device ms over {g['reads']} "
                         f"replays): " + ", ".join(
                             f"{n} {ms:.3f}" for n, ms in g["ms"].items()))
        return "\n".join(lines)

    def write_json(self, path: str) -> None:
        """The span summary, the stage reads by graph and the counters."""
        with open(path, "w") as f:
            json.dump({"spans": self.summary(),
                       "stages": self.stage_summary(),
                       "counters": dict(self.counters)}, f, indent=2)

    def reset(self) -> None:
        """Forget the spans, events and stage reads (not the counters,
        which are the process's)."""
        self._spans.clear()
        self.events.clear()
        self.stages.clear()


_TRACER = Tracer(enabled=False)


def tracer() -> Tracer:
    """The process-wide tracer (disabled until enabled)."""
    return _TRACER


# ----------------------------------------------------------- stage marks
_marking = threading.local()


class Stages:
    """A captured graph's stage accumulators on ``device``: ``acc`` holds
    per stage slot its ns, then its marks, then the previous mark's time
    and slot (``csrc/graph_if.cu``). Made before the capture, outside the
    graph's pool; the graph's first mark zeroes them on each replay."""

    def __init__(self, device):
        self.acc = torch.zeros(2 * MAX_STAGES + 2, dtype=torch.int64,
                               device=device)
        self.names: List[str] = []
        self.captured = 0           # marks captured into the graph

    def launch(self, stage: str) -> None:
        from ..ops.cuda import graph_if

        if stage not in self.names:
            if len(self.names) == MAX_STAGES:
                raise ValueError(f"a graph takes at most {MAX_STAGES} "
                                 f"stages: {self.names} + {stage!r}")
            self.names.append(stage)
        graph_if.stage_mark(self.acc, self.names.index(stage),
                            first=self.captured == 0)
        self.captured += 1

    def read(self) -> Dict[str, dict]:
        """Each stage's device ms and marks in the last replay (a host
        read)."""
        v = self.acc.tolist()
        return {n: {"ms": v[i] / 1e6, "marks": v[MAX_STAGES + i]}
                for i, n in enumerate(self.names)}


@contextlib.contextmanager
def marking(stages: Optional[Stages]):
    """Capture this thread's :func:`mark` calls into ``stages`` (none
    where it is None) for the block."""
    was = getattr(_marking, "stages", None)
    _marking.stages = stages
    try:
        yield
    finally:
        _marking.stages = was


def mark(stage: str) -> None:
    """Mark the start of ``stage`` in the graph being captured: launches
    the stage-mark kernel only while the tracer is active, the current
    stream captures and the graph owns accumulators (:func:`marking`), so
    never in a warm-up pass, on an eager path or with tracing off."""
    if not _TRACER.active:
        return
    stages = getattr(_marking, "stages", None)
    if stages is None or not torch.cuda.is_available() \
            or not torch.cuda.is_current_stream_capturing():
        return
    stages.launch(stage)


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
