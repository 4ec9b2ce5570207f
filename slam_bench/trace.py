"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
frames or solves inside the window, reduced to device intervals, kernel
records and the harness's own host spans (``record_function`` names that
start with ``bench.``)."""

from __future__ import annotations

import contextlib

from . import stats

HOST_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str):
    """A host span of the harness, visible in the trace as
    ``bench.<name>`` (a no-op outside a profiler)."""
    import torch

    with torch.profiler.record_function(HOST_PREFIX + name):
        yield


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    return prof


def stop(prof) -> dict:
    """Stop the profiler and reduce its events."""
    import torch

    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    return reduce(_events(prof))


def _events(prof):
    """(name, on_device, start_us, end_us) of every event of the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        try:
            a, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        except AttributeError:
            a, d = e.start_us(), e.duration_us()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, a, a + d))
    return out


def reduce(events) -> dict:
    """From (name, on_device, start_us, end_us) events: the window (first
    to last harness span), the device intervals in it, the kernels (device
    events that are not copies or fills) by name, and the host spans."""
    host = [(n[len(HOST_PREFIX):], a, b) for n, dev, a, b in events
            if not dev and n.startswith(HOST_PREFIX)]
    # the harness's spans come back on the device too, as annotations
    device = [(n, a, b) for n, dev, a, b in events
              if dev and not n.startswith(HOST_PREFIX)]
    if not host:
        return dict(window_us=None, kernels=0, device=[], host=[])
    w0 = min(a for _, a, _ in host)
    w1 = max(b for _, _, b in host)
    inside = [(n, a, b) for n, a, b in device if b > w0 and a < w1]
    kernels = [(n, a, b) for n, a, b in inside
               if not n.startswith(("Memcpy", "Memset"))]
    return dict(window_us=(w0, w1), device=inside, kernels=kernels,
                host=host)


def busy_us(tr: dict) -> float:
    w0, w1 = tr["window_us"]
    return stats.union_length((max(a, w0), min(b, w1))
                              for _, a, b in tr["device"])


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the harness span the host was in at the gap's
    middle (``host`` where none), in seconds."""
    by = {}
    for n, a, b in tr["device"]:
        by[n] = by.get(n, 0.0) + (b - a) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = tr["window_us"]
    idle = stats.gaps([(a, b) for _, a, b in tr["device"]], w0, w1)[:top]
    named = []
    for a, b in idle:
        mid = 0.5 * (a + b)
        inner = [(hb - ha, n) for n, ha, hb in tr["host"]
                 if ha <= mid <= hb]
        named.append([min(inner)[1] if inner else "host", (b - a) / 1e6])
    return dict(device_ops=[[n, s] for n, s in ops], idle_gaps=named)
