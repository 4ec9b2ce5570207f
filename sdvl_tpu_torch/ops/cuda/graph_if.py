"""IF and WHILE nodes in CUDA graphs captured from eager torch code.

The counterpart of the reference's ``lax.cond``/``lax.switch`` and
``lax.while_loop``/``fori_loop``/``scan`` inside one device program
(``sdvl_tpu/pipeline/device_fsm.py``, ``sdvl_tpu/solvers/ba.py``): while a
stream captures a graph, :func:`if_node` adds a conditional node on a ()
bool tensor and captures the work of its ``with`` block into the node's
body, so that on replay the body runs only where the tensor is true, with no
read back to the host; :func:`if_else` captures two bodies into an if/else
pair, two IF nodes that one condition kernel sets, the second where the
tensor is false; :func:`while_node` adds a WHILE node whose body runs as
long as a () bool tensor is true when the node starts and when the body
ends; :func:`fori_node` adds a counted WHILE node whose index and compare
live in the condition kernel.
``csrc/graph_if.cu`` adds the nodes (torch of this version has no binding
for conditional nodes); it is built with ``nvcc`` at first use into
``sdvl_tpu_torch/_build/`` and bound through ``ctypes``, as the detection
kernel is, in one translation unit with ``csrc/ba_pcg.cu`` (the whole-map
BA's CG kernels, ``ops/cuda/ba_pcg.py``). Conditional nodes nested in
another's body need CUDA 12.4 or later, in the runtime and the driver:
loading the library checks both.

Every condition kernel adds one to a launch counter on the card
(:func:`launches`): once per IF node or if/else pair and per WHILE node,
and once per WHILE iteration, each time a graph replays; a pair's adds one
to a second counter too (:func:`pairs`). :func:`stage_mark` launches the
stage-mark kernel of ``utils/trace.py``'s marks, which counts its own
launches in a third (:func:`marks`).
:func:`launch_floor` launches an empty kernel, the least a kernel node
costs, for timing beside it.

:func:`capture` wraps ``torch.cuda.graph``: the bodies are captured on
streams of their own, so every allocation of the capturing thread is routed
into the graph's memory pool, whatever its stream. The capture stream and
the body streams are made once per device, before any capture, each with
its cuBLAS workspace (see :func:`_new_stream`).

A body admits the node types that CUDA allows in conditional bodies:
kernels, device-to-device copies, memsets and nested conditionals. A
library call that needs anything else fails at capture, and the capture
then raises: nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

from . import detect

SOURCE = os.path.join(detect._PKG_DIR, "csrc", "graph_if.cu")
# the library holds the whole-map BA's CG kernels too (``ops/cuda/ba_pcg``):
# the BA's graph path loads it anyway, and one build of one translation unit
# costs set-up less than a second library or a second file
SOURCES = (SOURCE, os.path.join(detect._PKG_DIR, "csrc", "ba_pcg.cu"))

# the oldest CUDA (runtime and driver) whose graphs take conditional nodes
# nested in a conditional node's body
MIN_CUDA_VERSION = 12040

# conditional nodes nest at most this deep
MAX_DEPTH = 8

_lib = None
_lib_lock = threading.Lock()
_body_streams = {}   # (device index, nesting depth) -> torch.cuda.Stream
_capture_streams = {}   # device index -> the stream graphs capture on
_depth = threading.local()
# per CUDA device index, the (3,) int64 counts of condition-kernel launches,
# of the if/else pairs among them and of stage-mark launches
_counters = {}


def load_library(verbose: bool = False):
    """Build (once per process) and load the conditional-node library;
    raises where the CUDA runtime or driver is older than 12.4."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(detect.build_library(
                verbose=verbose, source=SOURCES, name="libsdvl_graph_if.so"))
            vp, ull, ci = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int
            p_ull = ctypes.POINTER(ull)
            lib.sdvl_if_begin.argtypes = [vp] * 4 + [p_ull,
                                                     ctypes.POINTER(vp)]
            lib.sdvl_else_begin.argtypes = [vp, vp, ull, vp]
            lib.sdvl_if_end.argtypes = [vp]
            lib.sdvl_while_begin.argtypes = [vp] * 4 + [p_ull]
            lib.sdvl_while_end.argtypes = [vp, ull, vp, vp]
            lib.sdvl_fori_begin.argtypes = [vp, vp, vp, ci, vp, p_ull]
            lib.sdvl_fori_end.argtypes = [vp, ull, vp, ci, vp]
            lib.sdvl_launch_floor.argtypes = [vp]
            lib.sdvl_stage_mark.argtypes = [vp, vp, ci, ci, vp]
            lib.sdvl_cuda_versions.argtypes = [
                ctypes.POINTER(ctypes.c_int)] * 2
            lib.sdvl_error_string.argtypes = [ctypes.c_int]
            lib.sdvl_error_string.restype = ctypes.c_char_p
            lib.sdvl_last_step.restype = ctypes.c_int
            lib.sdvl_stream_create.argtypes = [ctypes.POINTER(vp)]
            lib.sdvl_stream_create.restype = ctypes.c_int
            for fn in (lib.sdvl_if_begin, lib.sdvl_else_begin,
                       lib.sdvl_if_end, lib.sdvl_while_begin,
                       lib.sdvl_while_end, lib.sdvl_fori_begin,
                       lib.sdvl_fori_end, lib.sdvl_launch_floor,
                       lib.sdvl_stage_mark, lib.sdvl_cuda_versions):
                fn.restype = ctypes.c_int
            runtime, driver = ctypes.c_int(), ctypes.c_int()
            _check(lib.sdvl_cuda_versions(ctypes.byref(runtime),
                                          ctypes.byref(driver)),
                   "reading the CUDA versions")
            if min(runtime.value, driver.value) < MIN_CUDA_VERSION:
                raise RuntimeError(
                    f"nested conditional nodes need CUDA 12.4 or later: the "
                    f"runtime is {runtime.value}, the driver {driver.value}")
            _lib = lib
    return _lib


def _counter(dev: int) -> torch.Tensor:
    """The condition kernel's counters of device ``dev``: launches, then
    if/else pairs, then stage marks. A graph holds their address, so
    :func:`capture` makes them before a capture begins."""
    c = _counters.get(dev)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the conditional nodes' launch counter must "
                               "be made before a capture")
        c = _counters[dev] = torch.zeros(3, dtype=torch.int64,
                                         device=torch.device("cuda", dev))
    return c


def _index(device) -> int:
    return torch.cuda.current_device() if device is None \
        else torch.device(device).index or 0


def reset_launches(device=None) -> None:
    """Set the counters of ``device`` (default: the current one), the
    condition kernel's launches and if/else pairs and the stage marks, to
    0."""
    _counter(_index(device)).zero_()


def launches(device=None) -> int:
    """Condition-kernel launches on ``device`` since the last
    :func:`reset_launches` (a host read)."""
    return int(_counter(_index(device))[0])


def pairs(device=None) -> int:
    """The if/else pairs among :func:`launches` (each one launch, setting
    both of its nodes) since the last :func:`reset_launches` (a host
    read)."""
    return int(_counter(_index(device))[1])


def marks(device=None) -> int:
    """Stage-mark launches on ``device`` since the last
    :func:`reset_launches` (a host read)."""
    return int(_counter(_index(device))[2])


def _check(err: int, what: str) -> None:
    if err != 0:
        detail = "" if _lib is None else (
            f" ({_lib.sdvl_error_string(err).decode()}; step "
            f"{_lib.sdvl_last_step()} of csrc/graph_if.cu)")
        raise RuntimeError(f"{what} failed: CUDA error {err}{detail}")


def _new_stream(lib, dev: int) -> torch.cuda.ExternalStream:
    """A CUDA stream of its own on device ``dev`` (torch.cuda.Stream()
    hands out the streams of a pool of 32 in turn, so two of them could
    be one), with its cuBLAS workspace made: torch keeps a workspace per
    (handle, stream) for good, and one made while a graph captures would
    hold that graph's pool after the graph is gone."""
    handle = ctypes.c_void_p()
    with torch.cuda.device(dev):
        _check(lib.sdvl_stream_create(ctypes.byref(handle)),
               "creating a stream")
        stream = torch.cuda.ExternalStream(
            handle.value, device=torch.device("cuda", dev))
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            x = torch.ones((2, 2), device=torch.device("cuda", dev))
            torch.mm(x, x)
            torch.bmm(x[None], x[None])
        torch.cuda.current_stream(dev).wait_stream(stream)
    return stream


def _streams(dev: int) -> None:
    """Make device ``dev``'s capture stream and its body streams (one per
    nesting depth), once, while nothing captures."""
    if dev in _capture_streams:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the conditional nodes' streams must be made "
                           "before a capture")
    lib = load_library()
    for depth in range(MAX_DEPTH):
        _body_streams[(dev, depth)] = _new_stream(lib, dev)
    _capture_streams[dev] = _new_stream(lib, dev)


@contextlib.contextmanager
def _body_stream(device: torch.device):
    """Make the body stream of the current nesting depth current for the
    block; yields ``(parent stream, body stream)``."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    depth = getattr(_depth, "n", 0)
    if depth >= MAX_DEPTH:
        raise RuntimeError(f"conditional nodes nest at most {MAX_DEPTH} "
                           f"deep")
    _streams(dev)
    body = _body_streams[(dev, depth)]
    parent = torch.cuda.current_stream(dev)
    _depth.n = depth + 1
    try:
        with torch.cuda.stream(body):
            yield parent, body
    finally:
        _depth.n = depth


def _check_pred(pred: torch.Tensor, what: str) -> None:
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"{what} takes a () bool CUDA tensor, got "
                         f"{tuple(pred.shape)} {pred.dtype} {pred.device}")


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block into an IF node on ``pred`` (a () bool CUDA
    tensor) of the graph that the current stream is capturing. The block
    runs on a body stream that is made current for it."""
    _check_pred(pred, "an IF node")
    lib = load_library()
    counter = _counter(pred.device.index).data_ptr()
    with _body_stream(pred.device) as (parent, body):
        _check(lib.sdvl_if_begin(parent.cuda_stream, body.cuda_stream,
                                 pred.data_ptr(), counter, None, None),
               "adding an IF node")
        try:
            yield
        finally:
            _check(lib.sdvl_if_end(body.cuda_stream),
                   "ending the capture of an IF body")


def if_else(pred: torch.Tensor, body, orelse):
    """Capture ``body()`` into an IF node on ``pred`` (a () bool CUDA
    tensor) of the graph that the current stream is capturing, and
    ``orelse(out)``, ``out`` being what ``body`` returned, into a second IF
    node that the same condition kernel sets to ``not pred``: on replay one
    of the two runs, for one condition-kernel launch. Both hang off that
    kernel, and the parent stream's next work depends on both. Each runs
    on a body stream made current for it. Returns ``out``."""
    _check_pred(pred, "an if/else pair")
    lib = load_library()
    counter = _counter(pred.device.index).data_ptr()
    else_handle, kernel_node = ctypes.c_ulonglong(), ctypes.c_void_p()
    with _body_stream(pred.device) as (parent, stream):
        _check(lib.sdvl_if_begin(parent.cuda_stream, stream.cuda_stream,
                                 pred.data_ptr(), counter,
                                 ctypes.byref(else_handle),
                                 ctypes.byref(kernel_node)),
               "adding the IF node of an if/else pair")
        try:
            out = body()
        finally:
            _check(lib.sdvl_if_end(stream.cuda_stream),
                   "ending the capture of an IF body")
    with _body_stream(pred.device) as (parent, stream):
        _check(lib.sdvl_else_begin(parent.cuda_stream, stream.cuda_stream,
                                   else_handle.value, kernel_node.value),
               "adding the else node of an if/else pair")
        try:
            orelse(out)
        finally:
            _check(lib.sdvl_if_end(stream.cuda_stream),
                   "ending the capture of an else body")
    return out


class Loop:
    """What :func:`while_node` yields. ``pred`` is the () bool tensor the
    condition kernel at the end of the body reads: the node's own
    predicate unless the block sets another before it ends."""

    def __init__(self, pred: torch.Tensor):
        self.pred = pred


@contextlib.contextmanager
def while_node(pred: torch.Tensor):
    """Capture the block into a WHILE node on ``pred`` (a () bool CUDA
    tensor) of the graph that the current stream is capturing: on replay
    the body runs while the predicate is true, read when the node starts
    from ``pred`` and where the block ends from the yielded
    :class:`Loop`'s ``pred``, where it lies (the block computes it; its
    address is fixed within the graph, and the Loop holds it until the
    end kernel is recorded). The block runs on a body stream that is made
    current for it."""
    _check_pred(pred, "a WHILE node")
    lib = load_library()
    counter = _counter(pred.device.index).data_ptr()
    handle = ctypes.c_ulonglong()
    loop = Loop(pred)
    with _body_stream(pred.device) as (parent, body):
        _check(lib.sdvl_while_begin(parent.cuda_stream, body.cuda_stream,
                                    pred.data_ptr(), counter,
                                    ctypes.byref(handle)),
               "adding a WHILE node")
        try:
            yield loop
        finally:
            end = loop.pred
            ok = end.dtype == torch.bool and end.numel() == 1 and end.is_cuda
            # the capture ends whatever the block set, so the stream is
            # usable; a wrong predicate raises after it
            _check(lib.sdvl_while_end(body.cuda_stream, handle.value,
                                      (end if ok else pred).data_ptr(),
                                      counter),
                   "ending the capture of a WHILE body")
            _check_pred(end, "the end of a WHILE body")


@contextlib.contextmanager
def fori_node(index: torch.Tensor, n: int):
    """Capture the block into a counted WHILE node of the graph that the
    current stream is capturing: on replay the block runs ``n`` times, with
    ``index`` (a () int32 CUDA tensor made before the node) 0, 1, ...,
    n - 1. The condition kernel before the node writes 0 and the one at
    the end of the body adds 1 and compares with ``n``: the loop has no
    other kernel of its own. The block runs on a body stream that is made
    current for it."""
    if index.dtype != torch.int32 or index.numel() != 1 or not index.is_cuda:
        raise ValueError(f"a counted loop's index is a () int32 CUDA "
                         f"tensor, got {tuple(index.shape)} {index.dtype} "
                         f"{index.device}")
    lib = load_library()
    counter = _counter(index.device.index).data_ptr()
    handle = ctypes.c_ulonglong()
    with _body_stream(index.device) as (parent, body):
        _check(lib.sdvl_fori_begin(parent.cuda_stream, body.cuda_stream,
                                   index.data_ptr(), int(n), counter,
                                   ctypes.byref(handle)),
               "adding a counted WHILE node")
        try:
            yield
        finally:
            _check(lib.sdvl_fori_end(body.cuda_stream, handle.value,
                                     index.data_ptr(), int(n), counter),
                   "ending the capture of a counted WHILE body")


def launch_floor() -> None:
    """One launch of an empty one-thread kernel on the current stream: what
    a kernel node costs at the least, timed beside the condition kernel."""
    _check(load_library().sdvl_launch_floor(
        torch.cuda.current_stream().cuda_stream), "the empty kernel's launch")


def stage_mark(acc: torch.Tensor, stage: int, first: bool) -> None:
    """One launch of the stage-mark kernel on the current stream: the
    time since the previous mark goes to the previous mark's slot of
    ``acc`` (a graph's ``utils.trace.Stages``), and mark ``stage`` counts
    itself; ``first`` zeroes the slots instead."""
    _check(load_library().sdvl_stage_mark(
        torch.cuda.current_stream(acc.device).cuda_stream, acc.data_ptr(),
        int(stage), int(first), _counter(acc.device.index).data_ptr()),
        "a stage mark")


@contextlib.contextmanager
def warm_body(device: torch.device):
    """Run the block eagerly on the stream :func:`if_node` would capture it
    on, after the current stream's work and before what follows it: the
    pass before a capture, which loads the kernels and library handles of
    each body on its own stream. On the CPU it just runs the block."""
    if device.type != "cuda":
        yield
        return
    with _body_stream(device) as (parent, body):
        body.wait_stream(parent)
        try:
            yield
        finally:
            parent.wait_stream(body)


class Capture:
    """What :func:`capture` yields. ``pool_bytes`` is set when the block
    ends: what the capture added to the graph's pool (to
    ``torch.cuda.memory_reserved``)."""

    pool_bytes = None


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)``, with every allocation this
    thread makes during the capture (on the capture stream and on the IF
    bodies' streams) taken from the pool: ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` that graphs which never run at the
    same time share), else a private one. When the block ends the graphs
    captured into a pool hold the only references to it, so the pool is
    freed with the last of them. Yields a :class:`Capture`."""
    dev = torch.cuda.current_device()
    _streams(dev)
    _counter(dev)
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
    out = Capture()
    with torch.cuda.graph(graph, pool=pool, stream=_capture_streams[dev]):
        # torch routes the capture stream's allocations to the pool; route
        # this thread's instead (the entry is removed at capture_end)
        torch._C._cuda_endAllocateToPool(dev, pool)
        torch._C._cuda_beginAllocateCurrentThreadToPool(dev, pool)
        try:
            reserved = torch.cuda.memory_reserved(dev)
            yield out
        finally:
            # drop the reference the routing took; the graph's own keeps
            # the pool until the graph is freed
            torch._C._cuda_releasePool(dev, pool)
    out.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
