"""The device-resident step on the card: each frame one CUDA graph replay.

Needs an NVIDIA GPU and ``nvcc`` (the IF nodes are bound through
``csrc/graph_if.cu``); skips with a reason anywhere else. This file imports
no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q

On the small full-SLAM sequence of ``tests/test_torch_graph_step.py``
(bootstrap, tracked keyframes, a LOST stretch reaching the relocalizer's
sweep of every keyframe) and in serving mode:

* the graph path, captured at the stream's first frame, equals the eager
  card path (``graphs=False``) bit for bit: every frame's info and the
  final map and carry;
* no frame after the capture frame, FIRST and SECOND included, makes a
  synchronising call (``torch.cuda.set_sync_debug_mode("error")`` around
  its ``feed``);
* ``feed_chunk`` is one replay per chunk (a WHILE node over the step) and
  equals the per-frame graph path bit for bit, from frame 0;
* the long live-mapping run (``tools.long_run.run_protocol`` at the CPU
  test's scale: eviction, pruning, a blackout and its relocalization) as
  one replay per chunk equals ``graphs=False`` bit for bit: rows, map
  counters and the final map;
* global BA (``mapper.global_ba``) is one replay, bit-identical to
  ``graphs=False``, on the dense and on the PCG route, with its CG counts;
* ``MultiStream`` of 3 streams, in full SLAM mode and serving a frozen
  map: each ``feed`` is one replay of the batch graph over all streams,
  each ``feed_chunk`` one replay of the chunk graph of its length, none
  synchronises once its graph exists, and rows, maps and carries equal
  ``graphs=False`` bit for bit (the frozen map unchanged);
* ``global_ba(mesh=...)`` over an nccl mesh of one rank is one replay (its
  all-reduces in the WHILE bodies), within ``tests/test_torch_dist.py``'s
  tolerances of the eager mesh path and of one process, and its pool is
  freed with it;
* the Zurich-capacity tool (``tools.zurich_scale_smoke``) and the capacity
  probe (``tools.capacity_probe``) at their CPU tests' scales: global BA
  over 220 of 256 filled slots one replay, serving over that map one
  capture for the per-frame feeds (the warm reloc step a replay, the LOST
  carry written in place) and one for the chunk graph, the probe one
  replay per chunk at 8 and 72 slots; each bit-identical to
  ``graphs=False``;
* ``feed(block=False)`` returns before the frame is done;
* a graph's private memory pool is freed with the graph: serving streams
  built and dropped leave the card's reserved memory where it was.

The host driver ``SDVL``, whose stages each replay a CUDA graph of their
own on the card (on the same sequence, with ten keyframe slots: its local
BA takes a window of ten):

* its graph path equals ``graphs=False`` bit for bit: every frame's state,
  counts, keyframe flag and pose, the trajectory and the final map;
* a frame that captures no graph, FIRST and SECOND included, synchronises
  once (the batched read), under ``set_sync_debug_mode("warn")``;
* the async mapper on the graph path tracks as the sequential driver does
  (the criteria of ``tests/test_torch_runtime.py``, on the port's own
  320x240 ``PlaneScene``), its work replayed from its graphs;
* dropping a driver gives its graphs' pool back.
"""

import dataclasses
import gc
import warnings

import numpy as np
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
    # every frame is a replay of the graph captured at frame 0
    assert graph.runner.replays == len(frames)
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
    """Every frame after the capture frame (the first), FIRST and SECOND
    included, makes no synchronising call."""
    cfg, frames = graph_step_scene()
    st = SdvlStream(cfg, device="cuda")
    st.feed(frames[0])                  # the capture synchronises
    for f in frames[1:]:
        torch.cuda.set_sync_debug_mode("error")
        try:
            st.feed(f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    rows = torch.stack(st._rows)
    states = rows[:, 14].long().tolist()
    assert states[0] == 1 and 1 in states[1:]      # SECOND after frame 0
    assert (rows[:, 14] == STATE_LOST).sum() >= 4
    assert st.runner.replays == len(frames)


@pytest.mark.cuda
def test_feed_chunk_is_one_replay_per_chunk(cuda_device):
    """Chunks from frame 0 (through the bootstrap and a LOST stretch): one
    replay each, no synchronisation after the capture, every row and the
    final state bit-identical to the per-frame graph path."""
    cfg, frames = graph_step_scene()
    one = _run(cfg, frames, graphs=True)
    st = SdvlStream(cfg, device="cuda")
    sizes = (8, 8, 8, len(frames) - 24)
    at = 0
    for i, t in enumerate(sizes):
        replays = st.runner.replays
        torch.cuda.set_sync_debug_mode("error" if i else 0)
        try:
            st.feed_chunk(np.stack(frames[at:at + t]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert st.runner.replays == replays + 1
        at += t
    torch.cuda.synchronize()
    assert sorted(st.runner.chunk_graphs) == sorted(set(sizes))
    assert torch.equal(torch.stack(st._rows), torch.stack(one._rows))
    for a, b in zip(_leaves(one.m) + _leaves(one.carry),
                    _leaves(st.m) + _leaves(st.carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(one.last_corners, st.last_corners):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_long_run_replays_equal_the_eager_card_path(cuda_device):
    """The long live-mapping run (``tools.long_run.run_protocol``) at the
    CPU test's scale (``tests/test_torch_long_run.py``: 320x240, 6
    keyframe slots, 360 frames in chunks of 16, 5 black frames at 0.65),
    eagerly and as one replay per chunk: the store fills and evicts, prunes
    and relocalizes after the blackout, and every row, the map's counters
    and the final map are bit-identical between the two."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene
    from sdvl_tpu_torch.pipeline import config as tcfg
    from sdvl_tpu_torch.tools import long_run

    cfg = tcfg.Config(
        camera=tcfg.CameraConfig(width=320, height=240, fx=210.0, fy=210.0,
                                 u0=159.5, v0=119.5, dist=(0, 0, 0, 0, 0)),
        sdvl=tcfg.SdvlConfig(min_avg_shift=5.0, max_keyframes=6,
                             min_keyframe_its=4, min_init_corners=30,
                             max_points=1024, max_candidates=256,
                             min_matches=15, map_scale=4.0))
    runs = {}
    for graphs in (False, True):
        kept = []
        _, _, stats = long_run.run_protocol(
            cfg, PlaneScene(fx=210.0, fy=210.0, cx=159.5, cy=119.5,
                            width=320, height=240, plane_z=4.0, extent=12.0),
            360, chunk=16, blackout_frac=0.65, blackout_len=5, span=10.0,
            device="cuda", graphs=graphs,
            on_chunk=lambda s, f: (kept.append(s), f()))
        runs[graphs] = kept[-1], stats
    (eager, s_eager), (graph, s_graph) = runs[False], runs[True]
    assert s_graph["replays"] == s_graph["chunks"] == 23
    assert s_eager["replays"] == 0
    assert torch.equal(torch.stack(graph._rows), torch.stack(eager._rows))
    for name in ("n_keyframes", "n_evicted", "n_pruned"):
        assert int(getattr(graph.m, name)) == int(getattr(eager.m, name))
    for a, b in zip(_leaves(eager.m) + _leaves(eager.carry),
                    _leaves(graph.m) + _leaves(graph.carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert s_graph["evictions"] > 0 and s_graph["prunes"] > 0, s_graph
    assert s_graph["reloc_after_blackout"], s_graph
    assert s_graph["keyframes_live"] <= 6 < s_graph[
        "keyframes_total_inserted"], s_graph


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [12, 208])
def test_global_ba_replay_equals_eager(cuda_device, n_slots):
    """``mapper.global_ba`` on the stream's map padded to ``n_slots``
    keyframe slots (dense Cholesky at 12, PCG at 208): one replay,
    bit-identical to ``graphs=False``, CG counts included."""
    from sdvl_tpu_torch.pipeline import mapper
    from sdvl_tpu_torch.pipeline.config import intrinsics

    cfg, frames = graph_step_scene()
    m = _pad_slots(_run(cfg, frames[:22], graphs=False).m, n_slots)
    intr = intrinsics(cfg)
    runs = {}
    for graphs in (False, True):
        # the graph path's checked warm-up pass raises on a synchronising
        # call (StageGraph), and the replay reads nothing back
        stats = {}
        runs[graphs] = (mapper.global_ba(m, intr, graphs=graphs,
                                         stats=stats), stats)
    (eager, se), (graph, sg) = runs[False], runs[True]
    assert sg["replays"] == 1
    for a, b in zip(_leaves(eager), _leaves(graph)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(se["cg_iterations"], sg["cg_iterations"])
    assert (sg["cg_iterations"].numel() > 0) == (n_slots > 200)
    assert not torch.equal(graph.kf_pose, m.kf_pose)


def _pad_slots(m, n_slots):
    """``m`` with its keyframe slots padded with empty ones."""
    K = m.kf_valid.shape[0]
    pad = n_slots - K

    def grow(t, dim=0):
        shape = list(t.shape)
        shape[dim] = pad
        return torch.cat([t, torch.zeros(shape, dtype=t.dtype,
                                         device=t.device)], dim)

    return m._replace(
        kf_pose=grow(m.kf_pose), kf_valid=grow(m.kf_valid),
        kf_frame_id=grow(m.kf_frame_id),
        kf_pyr=tuple(grow(p) for p in m.kf_pyr),
        obs_mask=grow(m.obs_mask), obs_px=grow(m.obs_px),
        obs_level=grow(m.obs_level))


def _multi_run(cfg, frames, graphs, sizes, frozen_map=None):
    """``MultiStream`` of 3 streams (seeds 0, 1, 2) fed ``frames`` in turn:
    a ``None`` in ``sizes`` is one ``feed``, a number a ``feed_chunk`` of
    that many frames. On the graph path each call adds one replay to its
    graph, and a call whose graph exists runs under
    ``set_sync_debug_mode("error")``."""
    from sdvl_tpu_torch.dist.multi_stream import MultiStream

    ms = MultiStream(cfg, 3, seed=0, device="cuda", graphs=graphs,
                     frozen_map=frozen_map)
    at = 0
    for size in sizes:
        name = "batch_frame" if size is None else f"batch_chunk_{size}"
        replays = ms.replays.get(name, 0)
        torch.cuda.set_sync_debug_mode(
            "error" if graphs and name in ms.batch_graphs else 0)
        try:
            if size is None:
                ms.feed(np.repeat(frames[at][None], 3, axis=0))
                at += 1
            else:
                ms.feed_chunk(np.repeat(
                    np.stack(frames[at:at + size])[:, None], 3, axis=1))
                at += size
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert ms.replays.get(name, 0) == replays + graphs
    torch.cuda.synchronize()
    return ms


def _assert_multi_equal(a, b):
    assert torch.equal(torch.cat(a._rows), torch.cat(b._rows))
    maps = (([a.m], [b.m]) if a.frozen else (a.m, b.m))
    for ma, mb in zip(*maps):
        for x, y in zip(_leaves(ma), _leaves(mb)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    for ca, cb in zip(a.carries, b.carries):
        for x, y in zip(_leaves(ca), _leaves(cb)):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
def test_multi_stream_is_one_replay_per_batch_and_per_chunk(cuda_device):
    """3 full-SLAM streams from frame 0 (bootstrap, keyframes, the LOST
    stretch): 4 frame batches, then chunks of 8 over the rest; one graph
    per kind, one replay per call, bit-identical to ``graphs=False``."""
    cfg, frames = graph_step_scene()
    sizes = [None] * 4 + [8] * ((len(frames) - 4) // 8)
    eager = _multi_run(cfg, frames, False, sizes)
    graph = _multi_run(cfg, frames, True, sizes)
    assert graph.replays == {"batch_frame": 4,
                             "batch_chunk_8": len(sizes) - 4}
    assert all(b > 0 for b in graph.pool_bytes.values())
    rows = torch.cat(graph._rows)
    assert rows.shape == (4 + 8 * (len(sizes) - 4), 3, 21)
    assert (rows[:, :, 14] == 2).any() and (rows[:, :, 14] == 3).any()
    _assert_multi_equal(eager, graph)


@pytest.mark.cuda
def test_multi_stream_serves_a_frozen_map_in_one_replay(cuda_device):
    """3 streams serving one frozen map (LOST at the start): per-frame
    batches, then chunks of 4; the map never written, bit-identical to
    ``graphs=False``."""
    cfg, frames = graph_step_scene()
    slam = _run(cfg, frames[:22], graphs=False)
    runs = {}
    for graphs in (False, True):
        loc_cfg, state = _serving(cfg, slam)
        before = [t.clone() for t in _leaves(state[0])]
        runs[graphs] = _multi_run(loc_cfg, frames[4:16], graphs,
                                  [None] * 4 + [4, 4], frozen_map=state)
        assert runs[graphs].m is state[0]
        for x, y in zip(before, _leaves(state[0])):
            assert torch.equal(x, y), "the frozen map changed"
    assert runs[True].replays == {"batch_frame": 4, "batch_chunk_4": 2}
    assert (torch.cat(runs[True]._rows)[-4:, :, 14] == 2).all()
    _assert_multi_equal(runs[False], runs[True])


@pytest.mark.cuda
def test_global_ba_over_nccl_is_one_replay(cuda_device, tmp_path):
    """``global_ba(mesh=...)`` over an nccl mesh of one rank, on the
    stream's map at 12 slots (Cholesky) and 208 (PCG): one replay that
    reads nothing back, within 5e-4 (poses) and 5e-3 (points) of the eager
    mesh path and of one process, gated observations equal; dropping the
    graph gives its pool back."""
    import torch.distributed as dist

    from sdvl_tpu_torch.dist import mesh as tmesh
    from sdvl_tpu_torch.pipeline import mapper
    from sdvl_tpu_torch.pipeline.config import intrinsics

    cfg, frames = graph_step_scene()
    m12 = _run(cfg, frames[:22], graphs=False).m
    intr = intrinsics(cfg)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh(axis="point")
        for n_slots in (12, 208):
            m = _pad_slots(m12, n_slots)
            one = mapper.global_ba(m, intr)
            eager = mapper.global_ba(m, intr, mesh=mesh, graphs=False)
            gc.collect()
            torch.cuda.empty_cache()
            start = torch.cuda.memory_reserved()
            stats = {}
            graph = mapper.global_ba(m, intr, mesh=mesh, stats=stats)
            assert stats["replays"] == 1 and stats["pool_bytes"] > 0
            for ref in (eager, one):
                kv, pv = ref.kf_valid, ref.pt_valid
                assert float((graph.kf_pose - ref.kf_pose)[kv].abs().max()
                             ) <= 5e-4
                assert float((graph.pt_pos - ref.pt_pos)[pv].abs().max()
                             ) <= 5e-3
                assert torch.equal(graph.obs_mask, ref.obs_mask)
            assert not torch.equal(graph.kf_pose, m.kf_pose)
            del stats
            gc.collect()
            torch.cuda.empty_cache()
            assert torch.cuda.memory_reserved() <= start
    finally:
        dist.destroy_process_group()


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


# ------------------------------------------------------------ host driver
def _host_run(graphs, frames=None, count_syncs=False):
    """``SDVL`` over the sequence; per frame its info and, with
    ``count_syncs``, the synchronisations and whether a graph was
    captured."""
    from sdvl_tpu_torch.pipeline.sdvl import SDVL

    cfg, seq = graph_step_scene(max_keyframes=10)
    slam = SDVL(cfg, device="cuda", graphs=graphs)
    infos, syncs, captured = [], [], []
    for f in seq if frames is None else seq[:frames]:
        n_graphs = len(slam._graphs)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                infos.append(slam.handle_frame(f))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        captured.append(len(slam._graphs) > n_graphs)
    torch.cuda.synchronize()
    return slam, infos, syncs, captured


def _host_rows(slam, infos):
    head = [[i["n_matches"], i["n_attempts"], i["keyframe"]] + list(i["pose"])
            for i in infos]
    return ([i["state"] for i in infos], np.asarray(head),
            np.stack([p for _, p in slam.trajectory]))


@pytest.mark.cuda
def test_host_graph_path_equals_eager_card_path(cuda_device):
    eager, ie, _, _ = _host_run(graphs=False)
    graph, ig, _, _ = _host_run(graphs=True)
    states, head, traj = _host_rows(graph, ig)
    want = _host_rows(eager, ie)
    assert states == want[0]
    assert "LOST" in states and sum(i["keyframe"] for i in ig) >= 2
    np.testing.assert_array_equal(head, want[1])
    np.testing.assert_array_equal(traj, want[2])
    for a, b in zip(_leaves(eager.m), _leaves(graph.m)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {"detect", "bootstrap", "seed", "match_initial", "preprocess",
            "track", "map_update", "keyframe"} <= set(graph._graphs), sorted(
        graph._graphs)
    assert any(k.startswith("relocalize_") for k in graph._graphs)


@pytest.mark.cuda
def test_host_tracking_frames_synchronise_once(cuda_device):
    """Every frame that captures no graph synchronises once: tracking
    frames, and FIRST and SECOND frames (their stages' replays)."""
    _, infos, syncs, captured = _host_run(graphs=True, count_syncs=True)
    tracked = [n for i, n, c in zip(infos, syncs, captured)
               if i["state"] in ("RUNNING", "LOST") and not c]
    assert len(tracked) > 20
    assert tracked == [1] * len(tracked), syncs
    booting = [n for i, n, c in zip(infos, syncs, captured)
               if i["state"] in ("FIRST_FRAME", "SECOND_FRAME") and not c]
    assert booting and booting == [1] * len(booting), syncs


@pytest.mark.cuda
def test_async_mapper_graph_path_tracks_like_sequential(cuda_device):
    from sdvl_tpu_torch.io import evaluate
    from sdvl_tpu_torch.io.synthetic import PlaneScene
    from sdvl_tpu_torch.pipeline import config as tcfg
    from sdvl_tpu_torch.pipeline.runtime import AsyncMapper
    from sdvl_tpu_torch.pipeline.sdvl import SDVL, TrackingState

    # tests/torch_port_helpers.py::small_scene, rendered by the port
    scene = PlaneScene(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320,
                       height=240, plane_z=4.0)
    cfg = tcfg.Config(
        camera=tcfg.CameraConfig(width=320, height=240, fx=210.0, fy=210.0,
                                 u0=159.5, v0=119.5, dist=(0, 0, 0, 0, 0)),
        sdvl=tcfg.SdvlConfig(cell_size=32, min_avg_shift=5.0,
                             max_keyframes=10, min_keyframe_its=5,
                             min_init_corners=30, max_points=512,
                             max_candidates=256, min_matches=15,
                             map_scale=4.0))
    poses = scene.trajectory(26)
    slam = SDVL(cfg, seed=0, device="cuda")
    mapper = AsyncMapper(slam)
    try:
        infos = [slam.handle_frame(scene.render(p)) for p in poses]
        mapper.barrier()
        replays = {k: g.replays for k, g in mapper._graphs.items()}
    finally:
        mapper.stop()
    assert replays.get("frame", 0) > 0 and replays.get("keyframe", 0) > 0, (
        replays)
    assert slam.state == TrackingState.RUNNING
    running = [i for i, inf in enumerate(infos) if inf["state"] == "RUNNING"]
    assert len(running) >= 18
    n_matches = np.asarray([infos[i]["n_matches"] for i in running])
    assert (n_matches >= 15).mean() > 0.8, n_matches
    assert int(slam.m.pt_valid.sum()) >= 30
    assert int(slam.m.kf_valid.sum()) >= 2
    est = np.stack([infos[i]["pose"] for i in running])
    gt = np.stack([poses[i] for i in running])
    ate = evaluate.ate_rmse(evaluate.positions_from_poses(est),
                            evaluate.positions_from_poses(gt),
                            with_scale=True)
    extent = float(np.linalg.norm(
        np.ptp(evaluate.positions_from_poses(gt), axis=0)))
    assert ate < 0.05 * max(extent, 1e-6), (ate, extent)


@pytest.mark.cuda
def test_dropped_host_driver_frees_its_graphs(cuda_device):
    def run():
        slam = _host_run(graphs=True, frames=16)[0]
        assert slam.pool_bytes > 0
        return slam.pool_bytes

    run()        # the first makes what every driver shares
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved()
    pools = [run() for _ in range(2)]
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == start, (
        start, torch.cuda.memory_reserved(), pools)


@pytest.mark.cuda
def test_nested_bodies_keep_streams_of_their_own(cuda_device):
    """Conditional bodies nested four deep, captured after 64 streams were
    drawn from torch's pool of 32 (which hands its streams out in turn):
    each depth's body has a stream of its own, so the capture works and the
    replay runs every body."""
    from sdvl_tpu_torch.ops.cuda import graph_if
    from sdvl_tpu_torch.pipeline.device_fsm import device_while

    pool = [torch.cuda.Stream() for _ in range(64)]
    x = torch.zeros((), device=cuda_device)
    yes = torch.ones((), dtype=torch.bool, device=cuda_device)

    def level(k):
        if k == 0:
            x.add_(1.0)
        elif k % 2:
            with graph_if.if_node(yes):
                level(k - 1)
        else:
            device_while(lambda c: c < 2, lambda c: (level(k - 1), c + 1)[1],
                         torch.zeros((), dtype=torch.int32,
                                     device=cuda_device), max_iters=2)

    g = torch.cuda.CUDAGraph()
    with graph_if.capture(g):
        level(4)
    g.replay()
    torch.cuda.synchronize()
    assert float(x) == 4.0       # two WHILE levels of two iterations each
    streams = [s.cuda_stream for s in graph_if._body_streams.values()]
    assert len(set(streams)) == len(streams)
    assert not set(streams) & {s.cuda_stream for s in pool}


def _replay_kernels(g):
    """The CUDA kernels one replay of ``g`` runs, by name (torch.profiler),
    the condition kernel's as ``"condition"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    return ["condition" if "set_condition_kernel" in e.name else e.name
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
def test_if_else_pairs_take_both_branches_nested_three_deep(cuda_device,
                                                            monkeypatch):
    """``device_if`` with an else, three pairs deep: every combination of
    the three predicates picks its leaf on replay, as the eager path does,
    with one condition-kernel launch per pair that runs (3 a replay, each
    counted as a pair) and no ``logical_not``; a pair with empty bodies
    replays one kernel."""
    from sdvl_tpu_torch.ops.cuda import graph_if
    from sdvl_tpu_torch.pipeline.device_fsm import device_if

    preds = [torch.zeros((), dtype=torch.bool, device=cuda_device)
             for _ in range(3)]
    base = torch.zeros((), device=cuda_device)

    def level(k, code):
        if k == 3:
            return base + float(code)
        return device_if(preds[k], lambda: level(k + 1, 2 * code + 1),
                         lambda: level(k + 1, 2 * code))

    nots = []
    real_not = torch.logical_not
    monkeypatch.setattr(torch, "logical_not",
                        lambda *a, **k: nots.append(1) or real_not(*a, **k))
    level(0, 0)                 # eagerly first: loads every kernel
    g = torch.cuda.CUDAGraph()
    with graph_if.capture(g):
        out = level(0, 0)
    assert not nots, "the captured if/else pairs called logical_not"
    for code in range(8):
        for k, p in enumerate(preds):
            p.fill_(bool(code >> (2 - k) & 1))
        graph_if.reset_launches()
        g.replay()
        torch.cuda.synchronize()
        assert float(out) == code == float(level(0, 0))
        assert graph_if.launches() == 3 and graph_if.pairs() == 3
    g_pair = torch.cuda.CUDAGraph()
    with graph_if.capture(g_pair):
        device_if(preds[0], lambda: None, lambda: None)
    assert _replay_kernels(g_pair) == ["condition"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 17])
def test_device_fori_counts_in_its_condition_kernel(cuda_device, n):
    """``device_fori`` of n iterations inside a WHILE node of 3: bit for bit
    the eager loops, with 1 + n condition launches per inner loop and no
    loop-control kernel of its own (a replay of an empty body runs the
    condition kernel alone, n + 1 times)."""
    from sdvl_tpu_torch.ops.cuda import graph_if
    from sdvl_tpu_torch.pipeline.device_fsm import device_fori, device_while

    j0 = torch.zeros((), dtype=torch.int32, device=cuda_device)
    acc0 = torch.linspace(0.5, 2.0, 5, device=cuda_device)

    def outer(c):
        j, acc = c
        acc = device_fori(n, lambda i, a: a * 1.5 + (i + 2 * j).float(), acc)
        return j + 1, acc

    def run():
        return device_while(lambda c: c[0] < 3, outer, (j0, acc0),
                            max_iters=3)

    want = run()
    g = torch.cuda.CUDAGraph()
    with graph_if.capture(g):
        got = run()
    graph_if.reset_launches()
    g.replay()
    torch.cuda.synchronize()
    assert int(got[0]) == 3 and torch.equal(got[1], want[1])
    assert graph_if.launches() == 1 + 3 + 3 * (1 + n)
    assert graph_if.pairs() == 0
    g_empty = torch.cuda.CUDAGraph()
    with graph_if.capture(g_empty):
        device_fori(n, lambda i, a: a, acc0)
    assert _replay_kernels(g_empty) == ["condition"] * (n + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [0, 1, 6])
def test_while_node_reads_its_predicate_where_cond_wrote_it(cuda_device,
                                                            limit):
    """A WHILE node whose ``cond`` is a leaf of the carry (read in the
    carry's own buffer) and one whose ``cond`` is computed from a tensor
    the graph reads on every replay: both stop on the right iteration,
    replay after replay."""
    from sdvl_tpu_torch.ops.cuda import graph_if
    from sdvl_tpu_torch.pipeline.device_fsm import device_while

    top = torch.full((), limit, dtype=torch.int32, device=cuda_device)
    i0 = torch.zeros((), dtype=torch.int32, device=cuda_device)

    def leaf_body(c):
        i, _ = c
        return i + 1, i + 1 < top

    g = torch.cuda.CUDAGraph()
    with graph_if.capture(g):
        leaf = device_while(lambda c: c[1], leaf_body, (i0, i0 < top),
                            max_iters=8)
        bound = device_while(lambda c: c < top, lambda c: c + 1, i0,
                             max_iters=8)
    for want in (limit, limit + 2):
        top.fill_(want)
        graph_if.reset_launches()
        g.replay()
        torch.cuda.synchronize()
        assert int(leaf[0]) == want and int(bound) == want
        assert graph_if.launches() == 2 * (1 + want)


@pytest.mark.cuda
def test_zurich_global_ba_replay_equals_eager(cuda_device):
    """The Zurich tool's global BA at the CPU test's scale
    (``tests/test_torch_zurich_scale.py``: 220 of 256 keyframe slots filled,
    512 points, 128x160): one replay with no synchronisation before its
    result, bit-identical to ``graphs=False`` (map, CG counts), and the
    tool's ``e1 < 0.35 * e0``."""
    from sdvl_tpu_torch.tools import zurich_scale_smoke as z

    intr, _, _, m, _, _ = z.build_map(220, 512, 256, 128, 160, "cuda")
    noise = z.draws(256, 512, "cuda")
    runs = {g: z.run_global_ba(m, intr, *noise, graphs=g)
            for g in (False, True)}
    eager, graph = runs[False], runs[True]
    assert graph["replays"] == 1 and graph["sync_sites"] == []
    for a, b in zip(_leaves(eager["map"]), _leaves(graph["map"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert eager["cg_iterations"] == graph["cg_iterations"]
    assert len(graph["cg_iterations"]) == 10
    assert graph["e1"] == eager["e1"] < 0.35 * graph["e0"]


@pytest.mark.cuda
def test_zurich_serving_replays_equal_eager(cuda_device):
    """The Zurich tool's serving phase at the CPU test's scale
    (``tests/test_torch_zurich_serve.py``: 220 of 256 slots, 320x240): on
    the graph path one capture for the per-frame feeds (the cold reloc
    step), one for the chunk graph, one replay per feed or chunk, the warm
    reloc step a replay on the cold step's runner, the standalone
    relocalizer a replay per call; every frame's pose, state and counts and
    each lane budget's result bit-identical to ``graphs=False``."""
    from sdvl_tpu_torch.tools import zurich_scale_smoke as z

    intr, scene, cfg, m, kf_poses, _ = z.build_map(220, 512, 256, 240, 320,
                                                   "cuda")
    phase = dict(chunk=8, steady=8, n_chunks=2, lanes=(16, 64, 240))
    q = z.query_views(scene, kf_poses, n=17)
    runs = {}
    for graphs in (False, True):
        calls = []

        def on_feed(st, feed):
            g0 = (st.runner.graph, len(st.runner.chunk_graphs))
            n0 = st.runner.replays
            feed()
            calls.append((st.runner, st.runner.replays - n0,
                          (st.runner.graph, len(st.runner.chunk_graphs))
                          != g0))

        stats, res, lanes = z.serve_smoke(m, intr, cfg, kf_poses, q,
                                          device="cuda", graphs=graphs,
                                          on_feed=on_feed, **phase)
        runs[graphs] = stats, res, lanes, calls
    (se, re_, le, ce), (sg, rg, lg, cg) = runs[False], runs[True]
    assert all(c[0] is cg[0][0] for c in cg)
    assert [c[1] for c in cg] == [1] * len(cg)
    # captures: the cold reloc step and the first chunk (index 2 + steady)
    assert [i for i, c in enumerate(cg) if c[2]] == [0, 10]
    assert sg["serve_captures"] == 2 and se["serve_replays"] == 0
    assert sg["reloc_lane_replays"] == {16: 9, 64: 9, 240: 9}
    for name in ("poses_raw", "states", "n_matches", "quality"):
        np.testing.assert_array_equal(getattr(rg, name), getattr(re_, name))
    assert sg["serve_relocalized"] and sg["serve_final_state"] == "RUNNING"
    for n in phase["lanes"]:
        for a, b in zip(le[n], lg[n]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_capacity_probe_replays_equal_eager(cuda_device):
    """The capacity probe at the CPU test's scale
    (``tests/test_torch_capacity_probe.py``: 320x240, 512 point and 256
    candidate slots, 64 frames in chunks of 16) at 8 and 72 keyframe slots:
    one replay per chunk, no synchronisation in a chunk that captures
    nothing, and every frame and the final map bit-identical to
    ``graphs=False``."""
    from sdvl_tpu_torch.tools import capacity_probe as cp

    scene, cfg = cp.probe_config(240, 320)
    cfg = dataclasses.replace(cfg, sdvl=dataclasses.replace(
        cfg.sdvl, max_points=512, max_candidates=256))
    _, frames = cp.probe_frames(scene, 64)
    for K in (8, 72):
        runs = {}
        for graphs in (False, True):
            kept = []
            out = cp.probe_one(K, frames, cfg, device="cuda", graphs=graphs,
                               on_chunk=lambda s, f: (kept.append(s), f()))
            runs[graphs] = out, kept[-1]
        (oe, se), (og, sg) = runs[False], runs[True]
        assert og["replays_per_chunk"] == [1] * 4
        assert og["syncs_after_capture"] == 0
        assert oe["replays_per_chunk"] == [0] * 4
        assert og["capture_s"].keys() == {16}
        assert torch.equal(torch.stack(sg._rows), torch.stack(se._rows))
        for a, b in zip(_leaves(se.m) + _leaves(se.carry),
                        _leaves(sg.m) + _leaves(sg.carry)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert sum(og["is_keyframe"]) >= 2 and og["states"][-1] == 2
