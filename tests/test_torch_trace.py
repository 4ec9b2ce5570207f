"""The port's tracer (``sdvl_tpu_torch/utils/trace.py``): spans, stage marks
and counters, and the benchmark's readers of them
(``slam_bench/metrics/_program.py`` and the metrics that use it).

On the CPU: the process tracer is inactive by default and records nothing;
it is active while enabled and while a ``torch.profiler`` records, and no
span of it appears among the profiler's events; spans nest, per thread; a
mark launches nothing off the card or outside a capture; the kernels'
build counter, with the compiler stubbed; each reader's arithmetic on a
synthetic run, and each reads nothing from a program without the tracer.

On the card (``cuda``-marked, skipped here with a reason): an untraced
global BA launches no mark and its graph runs the kernels of a traced
capture less its marks; a traced one launches the expected marks, and its
stages sum to the replay's device interval; the clock mapping puts an eager
launch's runtime event inside its span. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import threading
import time
import types
from collections import Counter

import pytest
import torch

from sdvl_tpu_torch.ops.cuda import detect
from sdvl_tpu_torch.utils import trace
from slam_bench import manifest
from slam_bench.metrics import _program

STAGES = ("extract", "gate", "linearize", "pcg_setup", "pcg_loop", "update",
          "writeback", "end")


@pytest.fixture
def enabled():
    """The process tracer, enabled for the test and reset around it."""
    tr = trace.tracer()
    tr.reset()
    tr.enabled = True
    try:
        yield tr
    finally:
        tr.enabled = False
        tr.reset()


def test_process_tracer_is_inactive_by_default_and_records_nothing():
    tr = trace.tracer()
    assert trace.tracer() is tr
    assert not tr.enabled and not tr.active
    n, spans = len(tr.events), tr.summary()
    with tr.span("idle"):
        trace.mark("idle")
    assert len(tr.events) == n and tr.summary() == spans


def test_active_when_enabled():
    tr = trace.Tracer(enabled=False)
    with tr.span("off"):
        pass
    tr.enabled = True
    assert tr.active
    t0 = time.perf_counter_ns()
    with tr.span("on"):
        pass
    t1 = time.perf_counter_ns()
    assert [e["name"] for e in tr.events] == ["on"]
    ev = tr.events[0]
    assert ev["parent"] is None and t0 <= ev["t0_ns"] <= ev["t1_ns"] <= t1
    assert list(tr.summary()) == ["on"]


def test_active_under_a_profiler_and_absent_from_its_events():
    from torch.profiler import ProfilerActivity, profile

    tr = trace.Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tr.active
        with tr.span("program_span_xyz"):
            torch.ones(8) + 1
    assert not tr.active
    assert [e["name"] for e in tr.events] == ["program_span_xyz"]
    names = {e.name for e in prof.events()}
    assert "aten::add" in names
    assert not any("program_span_xyz" in n for n in names)


def test_parents_and_nesting():
    tr = trace.Tracer()
    with tr.span("a"):
        with tr.span("b"):
            with tr.span("c"):
                pass
        with tr.span("b"):
            pass
    with tr.span("d"):
        pass
    names = [e["name"] for e in tr.events]
    parents = [e["parent"] for e in tr.events]
    assert names == ["a", "b", "c", "b", "d"]
    assert parents == [None, 0, 1, 0, None]
    for e in tr.events[1:4]:
        outer = tr.events[e["parent"]]
        assert outer["t0_ns"] <= e["t0_ns"] <= e["t1_ns"] <= outer["t1_ns"]
    assert set(tr.summary()) == {"a", "a.b", "a.b.c", "d"}
    assert tr.summary()["a.b"]["n"] == 2

    # another thread's spans do not nest in this thread's
    def work():
        with tr.span("worker"):
            pass

    with tr.span("main"):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    worker = next(e for e in tr.events if e["name"] == "worker")
    assert worker["parent"] is None


def test_mark_launches_nothing_off_the_card_or_outside_a_capture(
        monkeypatch, enabled):
    from sdvl_tpu_torch.ops.cuda import graph_if

    launched = []
    monkeypatch.setattr(graph_if, "stage_mark",
                        lambda acc, i, first: launched.append((i, first)))
    stages = trace.Stages("cpu")
    trace.mark("linearize")                 # no graph owns marks
    with trace.marking(stages):
        trace.mark("linearize")             # the CPU stream never captures
    assert launched == [] and stages.captured == 0

    # where a stream captures, each mark launches, the first zeroing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with trace.marking(stages):
        for s in ("extract", "gate", "linearize", "gate"):
            trace.mark(s)
    trace.mark("end")                       # outside the graph
    enabled.enabled = False
    with trace.marking(stages):
        trace.mark("end")                   # tracing off
    assert launched == [(0, True), (1, False), (2, False), (1, False)]
    assert stages.names == ["extract", "gate", "linearize"]
    assert stages.captured == 4


def test_stages_read_and_their_bound():
    stages = trace.Stages("cpu")
    stages.names = ["extract", "gate"]
    acc = torch.zeros_like(stages.acc)
    acc[0], acc[1] = 2_500_000, 1_000_000
    acc[trace.MAX_STAGES], acc[trace.MAX_STAGES + 1] = 1, 3
    stages.acc = acc
    assert stages.read() == {"extract": {"ms": 2.5, "marks": 1},
                             "gate": {"ms": 1.0, "marks": 3}}
    stages.names = [f"s{i}" for i in range(trace.MAX_STAGES)]
    with pytest.raises(ValueError, match="at most"):
        stages.launch("one_more")


def test_stage_summary_and_json(tmp_path):
    tr = trace.Tracer()
    for ms in (1.0, 3.0):
        tr.record_stages("global_ba", {"linearize": {"ms": ms, "marks": 2}})
    assert tr.stage_summary() == {"global_ba": {
        "reads": 2, "ms": {"linearize": 4.0}, "marks": {"linearize": 4}}}
    assert "stages of global_ba" in tr.report()


@pytest.mark.parametrize("rc", [0, 1])
def test_the_build_counter(monkeypatch, tmp_path, rc):
    def nvcc(cmd, **kw):
        time.sleep(0.05)
        return types.SimpleNamespace(returncode=rc, stdout="", stderr="")

    monkeypatch.setattr(detect, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(detect, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(detect.subprocess, "run", nvcc)
    counters = trace.tracer().counters
    builds, secs = (counters.get("kernels.builds", 0),
                    counters.get("kernels.build_s", 0.0))
    assert not trace.tracer().active        # counted whether active or not
    if rc:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            detect.build_library()
    else:
        assert detect.build_library(name="x.so") == str(tmp_path / "x.so")
    assert counters["kernels.builds"] == builds + 1
    assert 0.05 <= counters["kernels.build_s"] - secs < 1.0


def test_global_ba_on_the_cpu_is_one_span_and_no_marks(enabled):
    from sdvl_tpu_torch.pipeline import mapper
    from sdvl_tpu_torch.tools import zurich_scale_smoke as z

    intr, _, _, m, _, _ = z.build_map(6, 64, 8, 48, 64, "cpu", workers=0)
    stats = {}
    mapper.global_ba(m, intr, stage_iters=(2, 2), stats=stats)
    assert [e["name"] for e in enabled.events] == ["global_ba"]
    assert "stage_ms" not in stats and enabled.stages == []


# ----------------------------------------------------------- the readers
class FakeTracer:
    def __init__(self, events=(), stages=(), counters=None):
        self.events = list(events)
        self.stages = list(stages)
        self.counters = dict(counters or {})


def _run(device, host, w=(0.0, 1000.0), steps=1):
    tr = dict(window_us=w, device=[("k", a, b) for a, b in device],
              kernels=[], host=list(host))
    return types.SimpleNamespace(trace=tr, trace_steps=steps, trace_at=0,
                                 steps=[None] * steps)


def _ev(name, parent, t0_us, t1_us, base_ns=7_000_000_000):
    return {"name": name, "parent": parent,
            "t0_ns": base_ns + int(t0_us * 1e3),
            "t1_ns": base_ns + int(t1_us * 1e3)}


def test_stage_readers_are_per_solve(monkeypatch):
    reads = [{"graph": "global_ba", "t_ns": 0, "stages": {
        s: {"ms": 10.0 * (k + 1) + i, "marks": 1}
        for i, s in enumerate(STAGES)}} for k in range(2)]
    reads.append({"graph": "step", "t_ns": 0,
                  "stages": {"linearize": {"ms": 1e6, "marks": 1}}})
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer(stages=reads))
    run = _run([], [("global_ba", 0, 900)] * 2, steps=2)
    for s in ("linearize", "pcg_setup", "pcg_loop", "update"):
        i = STAGES.index(s)
        got = manifest.reader(f"global_ba.{s}_ms")(run, {})
        assert got == pytest.approx((10 + i + 20 + i) / 2)
    # a solve on the dense route has no PCG stages
    dense = [{"graph": "global_ba", "t_ns": 0,
              "stages": {"linearize": {"ms": 4.0, "marks": 1}}}]
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer(stages=dense))
    assert manifest.reader("global_ba.pcg_loop_ms")(run, {}) is None
    assert manifest.reader("global_ba.linearize_ms")(run, {}) == 2.0


def test_spans_are_anchored_on_the_harness_solve(monkeypatch):
    # the program's clock runs 7 s ahead of the profiler's, and two solves
    # start 500 us apart on both
    events = [_ev("global_ba", None, 0, 400), _ev("graph.warmup", 0, 10, 50),
              _ev("global_ba", None, 500, 900),
              _ev("graph.capture", 2, 520, 600)]
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer(events))
    host = [("global_ba", 100.0, 500.0), ("read", 500.0, 520.0),
            ("global_ba", 600.0, 1000.0)]
    spans = _program.spans_us(_run([], host, steps=2))
    assert [n for n, _, _ in spans] == ["global_ba", "graph.warmup",
                                        "global_ba", "graph.capture"]
    assert [(a, b) for _, a, b in spans] == [
        pytest.approx(x) for x in [(100.0, 500.0), (110.0, 150.0),
                                   (600.0, 1000.0), (620.0, 700.0)]]
    # solves that do not pair up, or no solve, give nothing
    assert _program.spans_us(_run([], host[:1], steps=2)) is None
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer(events[1:2]))
    assert _program.spans_us(_run([], host[:1])) is None


def test_capture_idle_is_idle_inside_the_capture_spans(monkeypatch):
    # device busy 0-100, 300-400, 700-1000 of a 1000 us window; the
    # capture's spans cover 50-350 and 600-650: idle 100-300 and 600-650
    events = [_ev("global_ba", None, 0, 1000),
              _ev("graph.warmup", 0, 50, 200),
              _ev("graph.warmup", 0, 200, 300),
              _ev("graph.capture", 0, 290, 350),
              _ev("graph.replay", 0, 600, 700),
              _ev("graph.capture", 0, 600, 650)]
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer(events))
    run = _run([(0, 100), (300, 400), (700, 1000)],
               [("global_ba", 0.0, 1000.0)])
    got = manifest.reader("global_ba.capture_idle_pct")(run, {})
    assert got == pytest.approx(100.0 * (200 + 50) / 1000)
    assert _program.overlap_us([(0, 10), (20, 30)], [(5, 25), (8, 9)]) == 10


def test_kernel_build_reader(monkeypatch):
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer(
        counters={"kernels.build_s": 12.5, "kernels.builds": 3}))
    assert manifest.reader("setup.kernel_build_s")(_run([], []), {}) == 12.5
    monkeypatch.setattr(_program, "tracer", lambda: FakeTracer())
    assert manifest.reader("setup.kernel_build_s")(_run([], []), {}) == 0.0


NEW_METRICS = ("global_ba.linearize_ms", "global_ba.pcg_setup_ms",
               "global_ba.pcg_loop_ms", "global_ba.update_ms",
               "global_ba.capture_idle_pct", "setup.kernel_build_s")


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_read_nothing_from_a_program_without_the_tracer(
        monkeypatch, name):
    import sdvl_tpu_torch.utils.trace as program_trace

    monkeypatch.delattr(program_trace, "tracer")
    assert _program.tracer() is None
    run = _run([(0, 10)], [("global_ba", 0.0, 100.0)])
    assert manifest.reader(name)(run, {}) is None


def test_the_manifest_lists_the_new_metrics():
    per_layer = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == ["zurich.ba"]


# -------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the stage-mark kernel "
                    "(csrc/graph_if.cu) and CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _small_map():
    """The Zurich tool's map at its CPU test's scale: 220 of 256 keyframe
    slots (the PCG route), 512 points."""
    from sdvl_tpu_torch.tools import zurich_scale_smoke as z

    intr, _, _, m, _, _ = z.build_map(220, 512, 256, 128, 160, "cuda")
    return intr, z.perturb(m, *z.draws(256, 512, "cuda"))


def _solve_graph(m, intr, stage_iters):
    from sdvl_tpu_torch.pipeline import device_fsm, mapper
    from sdvl_tpu_torch.solvers import ba

    def solve(st):
        trace.mark("extract")
        res = ba.solve(mapper.extract_global_ba(st.m, intr),
                       huber=mapper.huber_threshold(intr),
                       stage_iters=stage_iters)
        trace.mark("end")
        return res.poses, res.points

    return device_fsm.StageGraph("t", solve, device_fsm.StepState(
        m, None, inplace=True), (), shared_map=True, marks=True)


def _replay_kernels(build, replays=1):
    """``build()``, a graph, captured and replayed ``replays`` times under
    the profiler, as the benchmark's traced solve is (for a graph captured
    before the profiler started, the profiler's records of a loop body's
    kernels are not one per launch); the graph, the most records of each
    kernel name that one replay shows (the profiler can drop a record of
    the tens of thousands) and the last replay's device interval (us)."""
    from torch.profiler import ProfilerActivity, profile

    from slam_bench import trace as bench_trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g = build()
        for _ in range(replays):
            g()
            torch.cuda.synchronize()
    events = bench_trace._events(prof)
    launches = sorted(a for n, on_dev, a, _ in events
                      if not on_dev and n.startswith("cudaGraphLaunch"))
    kernels = Counter()
    for i, t0 in enumerate(launches):
        t1 = launches[i + 1] if i + 1 < len(launches) else float("inf")
        dev = [(n, a, b) for n, on_dev, a, b in events
               if on_dev and t0 <= a < t1]
        kernels |= Counter(n for n, _, _ in dev
                           if not n.startswith(("Memcpy", "Memset")))
    return g, kernels, (min(a for _, a, _ in dev),
                        max(b for _, _, b in dev))


def _marks_launched(stage_iters, writeback=True):
    """Marks a replay launches: extract; each LM stage's opening gate and
    the gate between the stages; 4 a LM step (linearize, pcg_setup,
    pcg_loop, update); writeback; end. Each LM loop's body is captured
    once, so the graph holds 1 + 3 + 2 * 4 + writeback + 1 of them."""
    return 1 + 3 + 4 * sum(stage_iters) + writeback + 1


@pytest.mark.cuda
def test_untraced_graph_holds_no_mark_and_a_traced_one_only_marks_more(
        cuda_device, monkeypatch):
    from sdvl_tpu_torch.ops.cuda import graph_if

    intr, m = _small_map()
    stage_iters = (2, 3)
    untraced = _solve_graph(m, intr, stage_iters)
    assert untraced.stages is None
    graph_if.reset_launches()
    untraced()
    assert graph_if.marks() == 0
    # under the profiler the tracer is active: the same capture with the
    # marks stripped, then with them, each replayed twice
    conditions = graph_if.launches()
    with monkeypatch.context() as mp:
        mp.setattr(trace, "mark", lambda stage: None)
        stripped, k0, _ = _replay_kernels(
            lambda: _solve_graph(m, intr, stage_iters), replays=2)
    assert stripped.stages.captured == 0 and graph_if.marks() == 0
    conditions, stripped_conditions = (graph_if.launches(),
                                       graph_if.launches() - conditions)
    traced, k1, _ = _replay_kernels(lambda: _solve_graph(m, intr,
                                                         stage_iters),
                                    replays=2)
    assert traced.stages.captured == 1 + 3 + 2 * 4 + 1
    n = _marks_launched(stage_iters, writeback=False)
    assert graph_if.marks() == 2 * n
    # the same loops ran as often, by the condition kernel's own count
    assert graph_if.launches() - conditions == stripped_conditions
    extra, missing = k1 - k0, k0 - k1
    assert not missing, missing
    assert len(extra) == 1 and "stage_mark" in next(iter(extra)), extra
    assert sum(extra.values()) == n


@pytest.mark.cuda
def test_traced_global_ba_marks_each_stage_and_sums_to_the_replay(
        cuda_device):
    from sdvl_tpu_torch.ops.cuda import graph_if
    from sdvl_tpu_torch.pipeline import mapper

    intr, m = _small_map()
    stage_iters = (3, 4)
    mapper.global_ba(m, intr, stage_iters=stage_iters)   # builds, warms
    tr = trace.tracer()
    tr.reset()
    tr.enabled = True
    graph_if.reset_launches()
    stats = {}
    try:
        mapper.global_ba(m, intr, stage_iters=stage_iters, stats=stats)
    finally:
        tr.enabled = False
    want = _marks_launched(stage_iters)
    assert graph_if.marks() == want
    read = tr.stages[-1]["stages"]
    assert sum(st["marks"] for st in read.values()) == want
    assert read["linearize"]["marks"] == sum(stage_iters)
    assert stats["stage_ms"] == {n: st["ms"] for n, st in read.items()}
    assert set(stats["stage_ms"]) == set(STAGES)
    assert read["end"]["ms"] == 0.0
    names = [e["name"] for e in tr.events]
    assert names[0] == "global_ba" and names.count("graph.warmup") == 2
    for n in ("graph.capture", "graph.replay", "global_ba.read",
              "graph.release"):
        assert names.count(n) == 1, names
    capture_ms = sum((e["t1_ns"] - e["t0_ns"]) / 1e6 for e in tr.events
                     if e["name"] in ("graph.warmup", "graph.capture"))
    assert capture_ms == pytest.approx(1e3 * stats["capture_s"], rel=0.01)
    tr.reset()

    # the stages partition the replay's device interval
    g, _, (a, b) = _replay_kernels(lambda: _solve_graph(m, intr,
                                                        stage_iters))
    total_ms = sum(st["ms"] for st in g.stages.read().values())
    assert total_ms == pytest.approx((b - a) / 1e3, rel=0.05)


@pytest.mark.cuda
def test_the_clock_mapping_holds_an_eager_launch_in_its_span(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from slam_bench import trace as bench_trace

    x = torch.ones(1 << 16, device=cuda_device)
    tr = trace.tracer()
    for _ in range(3):      # the last is measured, once all is warm
        tr.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with bench_trace.span("global_ba"), tr.span("global_ba"):
                time.sleep(0.002)
                with tr.span("eager"):
                    x * 2
                time.sleep(0.002)
            torch.cuda.synchronize()
    events = bench_trace._events(prof)
    run = types.SimpleNamespace(trace=bench_trace.reduce(events),
                                trace_steps=1)
    spans = dict((n, (a, b)) for n, a, b in _program.spans_us(run))
    tr.reset()
    a, b = spans["eager"]
    launches = [(s, e) for n, on_dev, s, e in events
                if not on_dev and n.startswith("cudaLaunchKernel")]
    assert launches
    assert any(a - 20 <= s and e <= b + 20 for s, e in launches), (
        (a, b), launches)
