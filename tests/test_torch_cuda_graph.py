"""The device-resident step on the card: each tracking frame one CUDA graph
replay.

Needs an NVIDIA GPU and ``nvcc`` (the IF nodes are bound through
``csrc/graph_if.cu``); skips with a reason anywhere else. This file imports
no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q

On the small full-SLAM sequence of ``tests/test_torch_graph_step.py``
(bootstrap, tracked keyframes, a LOST stretch reaching the relocalizer's
sweep of every keyframe) and in serving mode:

* the graph path equals the eager card path (``graphs=False``) bit for bit:
  every frame's info and the final map and carry;
* a tracking frame makes no synchronising call
  (``torch.cuda.set_sync_debug_mode("error")`` around its ``feed``);
* ``feed(block=False)`` returns before the frame is done;
* a graph's private memory pool is freed with the graph: serving streams
  built and dropped leave the card's reserved memory where it was.
"""

import dataclasses
import gc

import pytest
import torch

from sdvl_tpu_torch.pipeline.device_fsm import STATE_LOST
from sdvl_tpu_torch.pipeline.stream import SdvlStream
from torch_port_helpers import graph_step_scene


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: CUDA graphs and their IF "
                    "nodes have no CPU mode (chip_smoke.py runs these "
                    "checks on the card)")
    return torch.device("cuda")


def _leaves(tree):
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _run(cfg, frames, graphs, state=None):
    st = SdvlStream(cfg, device="cuda", graphs=graphs)
    if state is not None:
        st._adopt(*state)
    for f in frames:
        st.feed(f)
    torch.cuda.synchronize()
    return st


def _serving(cfg, st):
    """A localizer's config and ``(map, carry)`` from a SLAM stream's:
    LOST, the map shared (serving never writes it), the carry copied."""
    cfg = dataclasses.replace(
        cfg, sdvl=dataclasses.replace(cfg.sdvl, localize_only=True))
    carry = type(st.carry)(*(
        tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()
        for v in st.carry))
    dev = carry.pose.device
    return cfg, (st.m, carry._replace(
        state=torch.tensor(STATE_LOST, dtype=torch.int32, device=dev),
        lost_frames=torch.tensor(3, dtype=torch.int32, device=dev)))


@pytest.mark.cuda
def test_graph_replay_equals_eager_card_path(cuda_device):
    cfg, frames = graph_step_scene()
    eager = _run(cfg, frames, graphs=False)
    graph = _run(cfg, frames, graphs=True)
    rows = torch.stack(graph._rows)
    boot = int(torch.argmax((rows[:, 18] > 0.5).long()))
    # every frame after the bootstrap is a replay
    assert graph.runner.replays == len(frames) - boot - 1
    assert torch.equal(rows, torch.stack(eager._rows))
    for a, b in zip(_leaves(eager.m) + _leaves(eager.carry),
                    _leaves(graph.m) + _leaves(graph.carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # serving the map built on the eager path, from LOST on every frame
    runs = []
    for g in (False, True):
        loc_cfg, state = _serving(cfg, eager)
        runs.append(_run(loc_cfg, frames[4:16], g, state))
    assert runs[1].runner.replays == 12
    assert torch.equal(torch.stack(runs[0]._rows), torch.stack(runs[1]._rows))


@pytest.mark.cuda
def test_tracking_frames_do_not_synchronise(cuda_device):
    cfg, frames = graph_step_scene()
    st = SdvlStream(cfg, device="cuda")
    tracked = 0
    for f in frames:
        if not st.runner.tracking:
            st.feed(f)                  # FIRST, SECOND: eager, read back
            continue
        if st.runner.graph is None:
            st.feed(f)                  # the capture synchronises once
            continue
        torch.cuda.set_sync_debug_mode("error")
        try:
            st.feed(f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        tracked += 1
    rows = torch.stack(st._rows)
    boot = int(torch.argmax((rows[:, 18] > 0.5).long()))
    assert tracked == len(frames) - boot - 2
    assert (rows[:, 14] == STATE_LOST).sum() >= 4


@pytest.mark.cuda
def test_feed_returns_before_the_frame_is_done(cuda_device):
    cfg, frames = graph_step_scene()
    st = SdvlStream(cfg, device="cuda")
    for f in frames[:6]:
        st.feed(f)
    torch.cuda.synchronize()
    assert st.runner.graph is not None
    st.feed(frames[6], block=False)
    done = torch.cuda.Event()
    done.record()
    assert not done.query(), "the replayed frame had finished on return"
    torch.cuda.synchronize()
    assert done.query()


@pytest.mark.cuda
def test_dropped_streams_free_their_graphs(cuda_device):
    cfg, frames = graph_step_scene()
    slam = _run(cfg, frames, graphs=False)

    def serve():
        loc_cfg, state = _serving(cfg, slam)
        st = _run(loc_cfg, frames[4:10], True, state)
        assert st.runner.graph is not None and st.runner.pool_bytes > 0
        return st.runner.pool_bytes

    serve()      # the first makes what every stream shares (tables, handles)
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved()
    pools = [serve() for _ in range(3)]
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == start, (
        start, torch.cuda.memory_reserved(), pools)
