"""IF nodes in CUDA graphs captured from eager torch code.

The counterpart of the reference's ``lax.cond``/``lax.switch`` inside one
device program (``sdvl_tpu/pipeline/device_fsm.py``): while a stream
captures a graph, :func:`if_node` adds a conditional node on a () bool
tensor and captures the work of its ``with`` block into the node's body, so
that on replay the body runs only where the tensor is true, with no read
back to the host. ``csrc/graph_if.cu`` adds the node (torch of this
version has no binding for conditional nodes); it is built with ``nvcc``
at first use into ``sdvl_tpu_torch/_build/`` and bound through ``ctypes``,
as the detection kernel is.

:func:`capture` wraps ``torch.cuda.graph``: the bodies are captured on
streams of their own, so every allocation of the capturing thread is routed
into the graph's memory pool, whatever its stream.

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

_lib = None
_lib_lock = threading.Lock()
_body_streams = {}   # (device index, nesting depth) -> torch.cuda.Stream
_depth = threading.local()


def load_library(verbose: bool = False):
    """Build (once per process) and load the IF-node library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(detect.build_library(
                verbose=verbose, source=SOURCE, name="libsdvl_graph_if.so"))
            lib.sdvl_if_begin.argtypes = [ctypes.c_void_p] * 3
            lib.sdvl_if_end.argtypes = [ctypes.c_void_p]
            lib.sdvl_if_begin.restype = lib.sdvl_if_end.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


@contextlib.contextmanager
def _body_stream(device: torch.device):
    """Make the body stream of the current nesting depth current for the
    block; yields ``(parent stream, body stream)``."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    depth = getattr(_depth, "n", 0)
    body = _body_streams.get((dev, depth))
    if body is None:
        body = _body_streams[(dev, depth)] = torch.cuda.Stream(device=dev)
    parent = torch.cuda.current_stream(dev)
    _depth.n = depth + 1
    try:
        with torch.cuda.stream(body):
            yield parent, body
    finally:
        _depth.n = depth


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the block into an IF node on ``pred`` (a () bool CUDA
    tensor) of the graph that the current stream is capturing. The block
    runs on a body stream that is made current for it."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"an IF node takes a () bool CUDA tensor, got "
                         f"{tuple(pred.shape)} {pred.dtype} {pred.device}")
    lib = load_library()
    with _body_stream(pred.device) as (parent, body):
        _check(lib.sdvl_if_begin(parent.cuda_stream, body.cuda_stream,
                                 pred.data_ptr()), "adding an IF node")
        try:
            yield
        finally:
            _check(lib.sdvl_if_end(body.cuda_stream),
                   "ending the capture of an IF body")


@contextlib.contextmanager
def warm_body(device: torch.device):
    """Run the block eagerly on the stream :func:`if_node` would capture it
    on, after the current stream's work and before what follows it: the
    pass before a capture, which loads the kernels and library handles of
    each body on its own stream."""
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
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
    out = Capture()
    with torch.cuda.graph(graph, pool=pool):
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
