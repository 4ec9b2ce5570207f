"""``dist.multi_stream.MultiStream`` serving one frozen shared map.

Mirrors ``tests/test_localize.py:104-125`` at the 160x128 set-up (and
configuration) of ``tests/test_torch_multi_stream.py``: the port's lone
``SdvlStream`` builds a map over lane 0's 18 frames and writes it as a
stream snapshot; the port's ``MultiStream`` serves THAT FILE to 4 streams
on frames 6-17 (a re-visit), stream ``i`` seeded ``7 + i`` and fed the
pose-RANSAC draws of ``PRNGKey(7 + i)``, and so does the reference's
``sdvl_tpu.dist.multi_stream.MultiStream`` (``frozen_map=`` the same file,
4 streams on 4 devices of the conftest's CPU mesh, seed 7): its carries
start LOST with ``lost_frames=3`` at the snapshot's pose, the semantics the
port's frozen mode copies.

Tolerances: against the reference, per-frame states and match counts equal
and trajectories within 1e-4 (``tests/test_multi_stream.py``'s criterion).
Every stream must track to the end within the reference test's ATE (8 % of
the extent). Streams 0 and 3 must equal a lone ``SdvlStream.localizer`` on
the same file with the same draws exactly (the same operations on the CPU:
the localizer's first frame relocalizes from the snapshot's pose, which is
all a fresh carry keeps). The map stays bit-identical before and after
serving.

The batch functions the card captures, run here eagerly, against
per-stream stepping (each stream's own ``StepRunner`` on the shared map,
frame by frame with its draws) bit for bit, rows and carries: the chunk
of 12 frames (``batch_chunk``) and 12 per-frame feeds (``batch_frame``);
chunks of 5 and 7 equal the per-frame feeds.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu.dist.mesh import make_mesh
from sdvl_tpu.dist.multi_stream import MultiStream as JMulti
from sdvl_tpu_torch.dist.multi_stream import MultiStream as TMulti
from sdvl_tpu_torch.io import evaluate
from sdvl_tpu_torch.io.snapshot import save_stream_snapshot
from sdvl_tpu_torch.io.synthetic import PlaneScene
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from sdvl_tpu_torch.pipeline.device_fsm import FrameInfo, StepRunner
from sdvl_tpu_torch.pipeline.stream import NoiseSource
from test_torch_multi_stream import (N_FRAMES, _configs, _providers,
                                     assert_states_equal, step_per_stream)
from torch_port_helpers import (N, assert_info_is_result, assert_info_like,
                                lane_counts_of, ransac_gumbel)

torch.set_num_threads(1)

QUERY = slice(6, 18)


def _leaves(m):
    out = []
    for v in m:
        out.extend(v if isinstance(v, tuple) else [v])
    return out


@pytest.fixture(scope="module")
def frozen_run(tmp_path_factory):
    cfg_j, cfg_t = _configs()
    scene = PlaneScene(fx=120.0, fy=120.0, cx=79.5, cy=63.5, width=160,
                       height=128, plane_z=4.0)
    poses = scene.trajectory(N_FRAMES, translation_amp=1.0)
    frames = [scene.render(p) for p in poses]
    st = TStream(cfg_t, seed=0, device="cpu",
                 gumbel_provider=_providers(cfg_t, 1, 0)[0])
    for f in frames:
        st.feed(f)
    snap = str(tmp_path_factory.mktemp("frozen") / "lane0.npz")
    save_stream_snapshot(st, snap)
    # serving draws pose noise only: stream i's from PRNGKey(7 + i)
    n_hyp, n_lanes = lane_counts_of(cfg_t)
    providers = [
        (lambda key: lambda i: ransac_gumbel(key, i, n_hyp, n_lanes))(
            np.asarray(jax.random.PRNGKey(7 + s))) for s in range(4)]
    query = np.stack(frames[QUERY])
    tm = TMulti(cfg_t, 4, seed=7, frozen_map=snap, device="cpu",
                gumbel_providers=providers)
    before = [t.clone() for t in _leaves(tm.m)]
    t_chunk = tm.feed_chunk(np.repeat(query[:, None], 4, axis=1))  # (T, 4, ..)
    # the reference serving the same file, one stream per mesh device
    jm = JMulti(cfg_j, make_mesh(4, axis="stream"), n_streams=4, seed=7,
                frozen_map=snap)
    j_chunk = jm.feed_chunk(np.repeat(query[:, None], 4, axis=1))
    lone = []
    for i in (0, 3):
        ls = TStream.localizer(cfg_t, snap, seed=7 + i, device="cpu",
                               gumbel_provider=providers[i])
        ls.feed_chunk(query)
        lone.append(ls.result())
    return dict(cfg_t=cfg_t, stream=st, snap=snap, query=query,
                poses=np.stack(poses[QUERY]), port=tm.result(), lone=lone,
                jax=jm.result(), t_chunk=t_chunk, j_chunk=j_chunk,
                tm=tm, before=before, cfg_j=cfg_j, providers=providers)


def _assert_streams_match_jax(info_t, info_j):
    """The criteria of ``test_frozen_streams_match_jax`` on returned infos:
    the reference's leaves, states and match counts equal, poses within
    1e-4."""
    assert_info_like(info_t, info_j)
    np.testing.assert_array_equal(N(info_t.state), np.asarray(info_j.state))
    np.testing.assert_array_equal(N(info_t.n_matches),
                                  np.asarray(info_j.n_matches))
    np.testing.assert_allclose(N(info_t.pose), np.asarray(info_j.pose),
                               atol=1e-4)


def test_frozen_feed_chunk_returns_the_references_frame_info(frozen_run):
    """``feed_chunk`` on the shared map returns one FrameInfo with
    (T, N, ...) leaves: the reference's, and what ``result()`` reports."""
    info = frozen_run["t_chunk"]
    T = QUERY.stop - QUERY.start
    assert info.pose.shape == (T, 4, 7) and info.is_keyframe.shape == (T, 4)
    _assert_streams_match_jax(info, frozen_run["j_chunk"])
    for i, r in enumerate(frozen_run["port"]):
        assert_info_is_result(FrameInfo(*(x[:, i] for x in info)), r,
                              slice(None))


def test_frozen_feed_returns_the_references_frame_info(frozen_run):
    """``feed`` on the shared map returns one FrameInfo with (N, ...)
    leaves: the reference's on the same first query frame and draws."""
    batch = np.repeat(frozen_run["query"][:1], 4, axis=0)
    tm = TMulti(frozen_run["cfg_t"], 4, seed=7, frozen_map=frozen_run["snap"],
                device="cpu", gumbel_providers=frozen_run["providers"])
    jm = JMulti(frozen_run["cfg_j"], make_mesh(4, axis="stream"),
                n_streams=4, seed=7, frozen_map=frozen_run["snap"])
    info = tm.feed(batch)
    assert info.pose.shape == (4, 7) and info.state.shape == (4,)
    _assert_streams_match_jax(info, jm.feed(batch))
    for i, r in enumerate(tm.result()):
        assert_info_is_result(FrameInfo(*(x[None, i] for x in info)), r,
                              slice(None))


def test_frozen_streams_match_lone_localizers(frozen_run):
    p_gt = evaluate.positions_from_poses(frozen_run["poses"])
    extent = float(np.linalg.norm(np.ptp(p_gt, axis=0)))
    assert len(frozen_run["port"]) == 4
    for r in frozen_run["port"]:
        running = r.states == 2
        assert r.state_name() == "RUNNING" and running[-4:].all()
        p_est = evaluate.positions_from_poses(r.trajectory[running])
        ate = evaluate.ate_rmse(p_est, p_gt[running], with_scale=True)
        assert ate < 0.08 * max(extent, 1e-6), (ate, extent)
    for rl, rt in zip(frozen_run["lone"], (frozen_run["port"][0],
                                           frozen_run["port"][3])):
        np.testing.assert_array_equal(rt.states, rl.states)
        np.testing.assert_array_equal(rt.trajectory, rl.trajectory)


def test_frozen_streams_match_jax(frozen_run):
    assert len(frozen_run["jax"]) == 4
    for rj, rt in zip(frozen_run["jax"], frozen_run["port"]):
        assert rt.n_frames == rj.n_frames == QUERY.stop - QUERY.start
        np.testing.assert_array_equal(rt.states, rj.states)
        np.testing.assert_array_equal(rt.n_matches, rj.n_matches)
        np.testing.assert_allclose(rt.trajectory, rj.trajectory, atol=1e-4)


def test_frozen_map_is_shared_and_untouched(frozen_run):
    tm = frozen_run["tm"]
    assert tm.m.kf_valid.ndim == 1              # one map, no stream dim
    assert len(tm.carries) == 4
    after = _leaves(tm.m)
    assert len(after) == len(frozen_run["before"])
    for a, b in zip(frozen_run["before"], after):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_frozen_live_tuple_adopted_by_reference(frozen_run):
    st = frozen_run["stream"]
    live = (st.m, st.carry)
    ms = TMulti(frozen_run["cfg_t"], 2, seed=7, frozen_map=live,
                device="cpu")
    assert ms.m is live[0] and ms.cfg.sdvl.localize_only
    for c in ms.carries:
        assert int(c.state) == 3 and int(c.lost_frames) == 3
        assert torch.equal(c.pose, live[1].pose)
        assert int(c.frame_id) == 0
    ms.feed(np.repeat(frozen_run["query"][:1], 2, axis=0))
    assert ms.result(1).n_frames == 1


def test_frozen_capacity_mismatch_raises(frozen_run):
    cfg = dataclasses.replace(frozen_run["cfg_t"], sdvl=dataclasses.replace(
        frozen_run["cfg_t"].sdvl, max_points=128))
    with pytest.raises(ValueError, match="capacities"):
        TMulti(cfg, 2, frozen_map=frozen_run["snap"], device="cpu")


def _batches(frozen_run):
    return np.repeat(frozen_run["query"][:, None], 4, axis=1)   # (T, 4, ..)


@pytest.fixture(scope="module")
def frozen_per_frame(frozen_run):
    """The 4 streams fed the query one frame batch at a time."""
    tm = TMulti(frozen_run["cfg_t"], 4, seed=7, frozen_map=frozen_run["snap"],
                device="cpu", gumbel_providers=frozen_run["providers"])
    for b in _batches(frozen_run):
        tm.feed(b)
    return tm


@pytest.fixture(scope="module")
def frozen_per_stream(frozen_run):
    """Stream i as its own ``StepRunner`` on the one shared map, from the
    carry ``MultiStream`` starts it with, fed stream i's draws."""
    fresh = TMulti(frozen_run["cfg_t"], 4, seed=7,
                   frozen_map=frozen_run["snap"], device="cpu")
    cfg = fresh.cfg
    runners = [StepRunner(cfg, False, fresh.m, c, frozen_map=True)
               for c in fresh.carries]
    noises = [NoiseSource(cfg, 7 + i, "cpu", frozen_run["providers"][i])
              for i in range(4)]
    before = [t.clone() for t in _leaves(fresh.m)]
    rows, states = step_per_stream(cfg, runners, noises, _batches(frozen_run))
    for a, b in zip(before, _leaves(fresh.m)):
        assert torch.equal(a, b), "per-stream stepping wrote the map"
    return dict(rows=rows, carries=[c for _, c in states[-1]])


def _assert_carries_equal(tm, carries):
    assert_states_equal([()] * len(carries), tm.carries,
                        [((), c) for c in carries])


def test_frozen_batch_chunk_equals_per_stream_stepping(frozen_run,
                                                       frozen_per_stream):
    tm = frozen_run["tm"]
    assert torch.equal(torch.cat(tm._rows), frozen_per_stream["rows"])
    _assert_carries_equal(tm, frozen_per_stream["carries"])


def test_frozen_batch_frame_equals_per_stream_stepping(frozen_per_frame,
                                                       frozen_per_stream):
    assert torch.equal(torch.cat(frozen_per_frame._rows),
                       frozen_per_stream["rows"])
    _assert_carries_equal(frozen_per_frame, frozen_per_stream["carries"])


def test_frozen_feed_chunk_over_uneven_chunks_equals_per_frame_feed(
        frozen_run, frozen_per_frame):
    tm = TMulti(frozen_run["cfg_t"], 4, seed=7, frozen_map=frozen_run["snap"],
                device="cpu", gumbel_providers=frozen_run["providers"])
    before = [t.clone() for t in _leaves(tm.m)]
    batches = _batches(frozen_run)
    tm.feed_chunk(batches[:5])
    tm.feed_chunk(batches[5:])
    assert torch.equal(torch.cat(tm._rows), torch.cat(frozen_per_frame._rows))
    _assert_carries_equal(tm, frozen_per_frame.carries)
    for a, b in zip(before, _leaves(tm.m)):
        assert torch.equal(a, b), "the frozen map changed"
