"""The port's ``dist.multi_stream.MultiStream`` against the JAX package's.

Mirrors ``tests/test_multi_stream.py``: 2 streams at 160x128 over 18
``PlaneScene`` frames each (stream ``i`` on a trajectory of amplitude
``1 + 0.3 i``), in full SLAM mode with a map per stream. The JAX run is
``sdvl_tpu.dist.multi_stream.MultiStream`` on the conftest's CPU mesh (2 of
its 8 devices on the ``stream`` axis); the port runs on the CPU, each
stream fed the random draws its JAX lane derives from ``PRNGKey(seed + i)``.
The frozen shared-map mode is in ``tests/test_torch_multi_stream_frozen.py``.

The configuration is ``tests/test_multi_stream.py``'s as written, ground-
plane alignment on. The alignment's plane RANSAC is where the packages can
part: on lane 1's noisy bootstrap map its two best hypotheses score alike
and one point sits 8e-6 inside the 0.1 inlier threshold of the winner, so
float32 rounding of the seed points picks different planes in the two
packages, and world frames 0.1 rad apart (the JAX fit on the port's points picks the
port's plane: ``test_lane_one_plane_choice_is_a_tie``). Lane 0's plane
agrees.

Tolerances: per-frame states and keyframe flags equal on both lanes. Lane
0's trajectory within 1e-3 of JAX (the full-SLAM criterion against JAX of
``tests/test_torch_slam.py``; measured 1.1e-4: the world's yaw about the
plane normal follows float32 noise, see ``tests/test_torch_cli_parity.py``)
and, re-expressed in the first camera's frame (the world before the
alignment), within 1e-4 (``tests/test_multi_stream.py``'s criterion between
a lane and a lone stream; measured 2.0e-5). Lane 1's, in the first camera's
frame, within 1e-3 (measured 1.9e-4). The port against itself (chunked
feeding, lane 0 against a lone ``SdvlStream``) exactly, being the same
operations on the CPU.

The batch functions the card captures, run here eagerly: ``feed`` runs
``MultiStream.batch_frame`` and ``feed_chunk`` ``batch_chunk``; each must
equal per-stream stepping (each stream's own ``StepRunner``, the step
``SdvlStream`` runs, frame by frame with its lane's draws) bit for bit:
rows, maps and carries. ``feed_chunk`` over uneven chunk lengths equals
per-frame ``feed`` from frame 0.
"""

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu.dist.mesh import make_mesh
from sdvl_tpu.dist.multi_stream import MultiStream as JMulti
from sdvl_tpu.io.synthetic import PlaneScene
from sdvl_tpu.pipeline import config as jcfg
from sdvl_tpu_torch.core import se3
from sdvl_tpu_torch.dist.multi_stream import MultiStream as TMulti
from sdvl_tpu_torch.pipeline import config as tcfg
from sdvl_tpu_torch.pipeline.device_fsm import (FrameInfo, StepRunner,
                                                cropped_shape, init_state)
from sdvl_tpu_torch.pipeline.stream import NoiseSource
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from torch_port_helpers import (N, assert_info_is_result, assert_info_like,
                                jax_draws)

torch.set_num_threads(1)

N_FRAMES = 18


def _configs():
    """``tests/test_multi_stream.py``'s configuration, in both packages."""
    cam = dict(width=160, height=128, fx=120.0, fy=120.0, u0=79.5, v0=63.5,
               dist=(0, 0, 0, 0, 0))
    sdvl = dict(cell_size=16, min_avg_shift=3.0, max_keyframes=6,
                min_keyframe_its=5, min_init_corners=15, min_matches=8,
                max_points=256, max_candidates=64, map_scale=4.0)
    return tuple(c.Config(camera=c.CameraConfig(**cam),
                          sdvl=c.SdvlConfig(**sdvl)) for c in (jcfg, tcfg))


def _providers(cfg_t, n, seed):
    """Stream i's JAX draws: its lane's carry holds PRNGKey(seed + i)."""
    return [jax_draws(cfg_t, np.asarray(jax.random.PRNGKey(seed + i)))
            for i in range(n)]


@pytest.fixture(scope="module")
def multi_run():
    cfg_j, cfg_t = _configs()
    scene = PlaneScene(fx=120.0, fy=120.0, cx=79.5, cy=63.5, width=160,
                       height=128, plane_z=4.0)
    seqs = [[scene.render(p) for p in
             scene.trajectory(N_FRAMES, translation_amp=1.0 + 0.3 * i)]
            for i in range(2)]
    batches = [np.stack([seqs[0][t], seqs[1][t]]) for t in range(N_FRAMES)]
    jm = JMulti(cfg_j, make_mesh(2, axis="stream"), n_streams=2, seed=0)
    j_infos = [jm.feed(b) for b in batches]
    providers = _providers(cfg_t, 2, 0)
    tm = TMulti(cfg_t, 2, seed=0, device="cpu", gumbel_providers=providers)
    t_infos = [tm.feed(b) for b in batches]
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, seqs=seqs, batches=batches,
                providers=providers, jax=jm.result(), port=tm.result(),
                tm=tm, j_infos=j_infos, t_infos=t_infos)


@pytest.fixture(scope="module")
def chunk_run(multi_run):
    """6 per-frame feeds, then a 6-frame chunk, in both packages; the
    chunk's returned FrameInfos and the port's results."""
    b = multi_run["batches"]
    jm = JMulti(multi_run["cfg_j"], make_mesh(2, axis="stream"), n_streams=2,
                seed=0)
    tm = TMulti(multi_run["cfg_t"], 2, seed=0, device="cpu",
                gumbel_providers=multi_run["providers"])
    for t in range(6):
        jm.feed(b[t])
        tm.feed(b[t])
    chunk = np.stack(b[6:12])
    return dict(jax=jm.feed_chunk(chunk), port=tm.feed_chunk(chunk),
                results=tm.result(), tm=tm)


def _leaves(tree):
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _clone_tree(tree):
    out = [_clone_tree(v) if isinstance(v, tuple) else v.clone()
           for v in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def step_per_stream(cfg_t, runners, noises, frames):
    """Each stream's ``StepRunner`` stepped frame by frame:
    ``frames[t][i]`` is stream i's frame t; the packed rows (T, N, 21) and
    each stream's (map, carry) after every frame (clones)."""
    ch, cw = cropped_shape(cfg_t)
    rows, states = [], []
    for t, batch in enumerate(frames):
        row = []
        for r, src, f in zip(runners, noises, batch):
            img = torch.from_numpy(np.ascontiguousarray(f[:ch, :cw]))
            row.append(r.step(img, src.pose(t, 1)[0], src.boot)[0])
        rows.append(torch.stack(row))
        states.append([(_clone_tree(r.st.m), _clone_tree(r.st.carry))
                       for r in runners])
    return torch.stack(rows), states


def assert_states_equal(maps, carries, want):
    """Maps and carries of a MultiStream's streams against per-stream
    (map, carry) pairs, bit for bit."""
    assert len(maps) == len(carries) == len(want)
    for m, c, (wm, wc) in zip(maps, carries, want):
        for a, b in zip(_leaves(m) + _leaves(c), _leaves(wm) + _leaves(wc),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def per_stream(multi_run):
    """Stream i (seed i, lane i's draws) as its own ``StepRunner`` over its
    18 frames."""
    cfg = multi_run["cfg_t"]
    runners = [StepRunner(cfg, False, *init_state(cfg, i, device="cpu"))
               for i in range(2)]
    noises = [NoiseSource(cfg, i, "cpu", multi_run["providers"][i])
              for i in range(2)]
    rows, states = step_per_stream(cfg, runners, noises,
                                   multi_run["batches"])
    return dict(rows=rows, states=states)


def _assert_lanes_match_jax(info_t, info_j):
    """The criteria of ``test_streams_match_jax`` on returned infos (the
    stream axis last of the leading ones): states and keyframe flags equal
    on both lanes, lane 0's pose within 1e-3."""
    assert_info_like(info_t, info_j)
    np.testing.assert_array_equal(N(info_t.state), np.asarray(info_j.state))
    np.testing.assert_array_equal(N(info_t.is_keyframe),
                                  np.asarray(info_j.is_keyframe))
    np.testing.assert_allclose(N(info_t.pose)[..., 0, :],
                               np.asarray(info_j.pose)[..., 0, :], atol=1e-3)


def _from_first_camera(trajectory):
    """World->camera poses (N, 7) re-expressed in the first camera's frame,
    the world before the ground-plane alignment."""
    traj = torch.from_numpy(np.asarray(trajectory, np.float64))
    return se3.compose(traj, se3.inverse(traj[:1])).numpy()


def test_streams_match_jax(multi_run):
    for rj, rt in zip(multi_run["jax"], multi_run["port"]):
        assert rt.n_frames == N_FRAMES
        np.testing.assert_array_equal(rt.states, rj.states)
        np.testing.assert_array_equal(rt.is_keyframe, rj.is_keyframe)
    (j0, j1), (t0, t1) = multi_run["jax"], multi_run["port"]
    np.testing.assert_allclose(t0.trajectory, j0.trajectory, atol=1e-3)
    np.testing.assert_allclose(_from_first_camera(t0.trajectory),
                               _from_first_camera(j0.trajectory), atol=1e-4)
    np.testing.assert_allclose(_from_first_camera(t1.trajectory),
                               _from_first_camera(j1.trajectory), atol=1e-3)


def test_lane_one_plane_choice_is_a_tie(multi_run):
    """Why lane 1's world differs from JAX's: the port's lone stream over
    lane 1's frames (equal to lane 1, see
    ``test_lane_zero_matches_lone_stream``) is stopped at its ground-plane
    alignment. On its seed points the reference's ``fit_plane_ransac``
    returns the port's plane (normals within 1e-5), and the RANSAC's two
    best hypotheses tie, the first of them with a point within 1e-4 of its
    inlier threshold, closer than the packages' points are apart."""
    from sdvl_tpu.core import geometry as jgeometry
    from sdvl_tpu_torch.core import geometry as tgeometry
    from sdvl_tpu_torch.pipeline import mapper as tmapper

    cfg_t = multi_run["cfg_t"]
    seen = []
    align = tmapper.transform_initial_map

    def spy(m, gumbel, dist_thresh=0.1):
        seen.append((m.pt_pos.clone(), m.pt_valid.clone(), gumbel.clone(),
                     dist_thresh))
        return align(m, gumbel, dist_thresh)

    mp = pytest.MonkeyPatch()
    mp.setattr(tmapper, "transform_initial_map", spy)
    try:
        st = TStream(cfg_t, seed=1, device="cpu",
                     gumbel_provider=multi_run["providers"][1])
        for f in multi_run["seqs"][1]:
            st.feed(f)
            if seen:
                break
    finally:
        mp.undo()
    pts, valid, gumbel, thresh = seen[0]
    (n_t, _), _ = tgeometry.fit_plane_ransac(pts, valid, gumbel, thresh)
    key = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    (n_j, _), _ = jax.jit(lambda p, v: jgeometry.fit_plane_ransac(
        p, v, key, thresh=thresh))(pts.numpy(), valid.numpy())
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)

    idx = tgeometry.sample_without_replacement(gumbel, valid, 3)
    a, b, c = (pts[idx[:, k]].double() for k in range(3))
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    dist = (pts.double() @ n.T - torch.sum(n * a, dim=-1)).abs()  # (P, I)
    scores = torch.sum((dist < thresh) & valid[:, None], dim=0)
    top2 = torch.topk(scores, 2).values
    assert int(top2[0]) == int(top2[1]), scores
    best = int(torch.argmax(scores))
    margin = (dist[:, best] - thresh).abs()[valid].min()
    assert float(margin) < 1e-4, float(margin)


def test_streams_progress_independently(multi_run):
    results = multi_run["port"]
    for r in results:
        assert r.state_name() == "RUNNING", r.states
    assert not np.allclose(results[0].trajectory, results[1].trajectory)
    assert len(multi_run["tm"].m) == 2 and len(multi_run["tm"].carries) == 2


def test_feed_returns_the_references_frame_info(multi_run):
    """``feed`` returns one FrameInfo with (N, ...) leaves in the
    reference's dtypes, lane for lane the reference's numbers, and the
    numbers ``result()`` then reports."""
    for info_t, info_j in zip(multi_run["t_infos"], multi_run["j_infos"]):
        assert info_t.pose.shape == (2, 7)
        _assert_lanes_match_jax(info_t, info_j)
    stacked = FrameInfo(*map(torch.stack, zip(*multi_run["t_infos"])))
    for i, r in enumerate(multi_run["port"]):
        assert_info_is_result(FrameInfo(*(x[:, i] for x in stacked)), r,
                              slice(None))


def test_feed_chunk_returns_the_references_frame_info(chunk_run):
    """``feed_chunk`` returns one FrameInfo with (T, N, ...) leaves, as
    the reference's scan does."""
    info = chunk_run["port"]
    assert info.pose.shape == (6, 2, 7) and info.state.shape == (6, 2)
    _assert_lanes_match_jax(info, chunk_run["jax"])
    for i, r in enumerate(chunk_run["results"]):
        assert_info_is_result(FrameInfo(*(x[:, i] for x in info)), r,
                              slice(6, 12))


def test_feed_chunk_matches_per_frame(multi_run, chunk_run):
    """6 per-frame feeds, then a 6-frame chunk: the per-frame run's first
    12 frames exactly (bootstrap and tracking both cross the seam)."""
    for rc, rf in zip(chunk_run["results"], multi_run["port"]):
        np.testing.assert_array_equal(rc.states, rf.states[:12])
        np.testing.assert_array_equal(rc.trajectory, rf.trajectory[:12])
        np.testing.assert_array_equal(rc.n_matches, rf.n_matches[:12])


def test_lane_zero_matches_lone_stream(multi_run):
    st = TStream(multi_run["cfg_t"], seed=0, device="cpu",
                 gumbel_provider=multi_run["providers"][0])
    for f in multi_run["seqs"][0]:
        st.feed(f)
    solo, lane0 = st.result(), multi_run["tm"].result(0)
    np.testing.assert_array_equal(lane0.states, solo.states)
    np.testing.assert_array_equal(lane0.trajectory, solo.trajectory)


def test_batch_frame_equals_per_stream_stepping(multi_run, per_stream):
    """``feed`` (``batch_frame``, eagerly) over 18 frames: every row, and
    each stream's map and carry, equal per-stream stepping bit for bit."""
    tm = multi_run["tm"]
    assert torch.equal(torch.cat(tm._rows), per_stream["rows"])
    assert_states_equal(tm.m, tm.carries, per_stream["states"][-1])
    assert tm.batch_graphs == {}


def test_batch_chunk_equals_per_stream_stepping(chunk_run, per_stream):
    """6 feeds, then ``batch_chunk`` (eagerly) over 6 frames: the 12 rows,
    maps and carries equal per-stream stepping at frame 12."""
    tm = chunk_run["tm"]
    rows = torch.cat(tm._rows)
    assert rows.shape == (12, 2, 21)
    assert torch.equal(rows, per_stream["rows"][:12])
    assert_states_equal(tm.m, tm.carries, per_stream["states"][11])


def test_feed_chunk_over_uneven_chunks_equals_per_frame_feed(multi_run):
    """Chunks of 5, 7 and 6 frames from frame 0 (the bootstrap in the
    first, tracking across both seams): every row, map and carry of the
    per-frame run, bit for bit."""
    b = multi_run["batches"]
    tm = TMulti(multi_run["cfg_t"], 2, seed=0, device="cpu",
                gumbel_providers=multi_run["providers"])
    at = 0
    for t in (5, 7, 6):
        info = tm.feed_chunk(np.stack(b[at:at + t]))
        assert info.state.shape == (t, 2)
        at += t
    ref = multi_run["tm"]
    assert torch.equal(torch.cat(tm._rows), torch.cat(ref._rows))
    assert_states_equal(tm.m, tm.carries, list(zip(ref.m, ref.carries)))
