"""The port's long live-mapping run against the JAX package's, at the JAX
package's CI scale.

``tests/test_long_run.py``'s scene and config (320x240, 6 keyframe / 1024
point / 256 candidate slots) over 360 frames of ``long_trajectory(span=10)``
in chunks of 16, with 5 black frames at 0.65 of the run: the keyframe store
fills past capacity and evicts, redundant keyframes are pruned and their
anchors re-homed, weak points are reaped, point and candidate slots are
recycled, and the black frames send the stream LOST until it relocalizes
against the map it built. The JAX tool's ``run_protocol``
(``tools/long_run.py``) and the port's (``sdvl_tpu_torch.tools.long_run``,
CPU, fed the JAX run's random draws) run once each; the JAX run's map and
carry are kept before every chunk.

Two comparisons, with these tolerances:

* **Chunk by chunk from the reference's state.** Before each chunk the JAX
  run's map and carry are handed to the port, which runs the chunk. Every
  frame's state and ``n_corners`` equal; keyframe flags equal and
  ``n_matches`` within 2 up to a chunk's first divergence, which must be a
  one-match flip at the keyframe policy's threshold (at most 2 chunks);
  poses within 1e-3 on 90 % of the frames and within 5e-3 on all
  (``tests/test_torch_slam_long.py``'s bounds; a quaternion and its
  negation are one rotation; in the bootstrap's chunk, which sets the
  world's gauge, camera centres once the Sim(3) between the runs' worlds
  is taken out); after every chunk that did not diverge the map's counters
  (``n_keyframes``, ``n_evicted``, ``n_pruned``) and its keyframe slots
  (``kf_valid``, ``kf_frame_id``) equal the JAX run's, and the live points
  within 2 %. So every eviction, prune and relocalization of the run is
  made by the port from the same state, as the reference made it.
* **The free run.** Both packages from an empty map. The world's yaw is set
  by float32 noise in the ground-plane alignment (``ROADMAP.md``, "How the
  SLAM parity tests compare worlds"), so the two runs track the same
  frames in worlds turned about 1e-3 apart, and the map's float drift
  moves a match count by one on a few frames. On this sequence that flips
  one keyframe decision: frame 108, where the policy's "10 % of the
  matches lost" threshold lies between the two runs' counts (41 and 42
  against a high-water mark of 46); the port handed the JAX state at the
  start of that chunk makes the reference's decision (the chunk-by-chunk
  comparison, in which one chunk of the 23 parts the same way, at frame
  156, and every other chunk ends with the reference's map structure).
  Up to that first divergence, which the test requires to be such a
  one-match flip at the threshold: states, keyframe flags and
  ``n_corners`` equal, ``n_matches`` within 2, camera centres within 1e-3
  on 90 % of the tracked frames and within 5e-3 on all
  (``tests/test_torch_slam_long.py``'s bounds) once the Sim(3) between the
  runs' worlds is taken out. Over the whole
  run: states equal on every frame (the same LOST segments), a
  relocalization after the blackout in both, ``tests/test_long_run.py``'s
  assertions on the port's run, and keyframe insertions, evictions and
  prunes each within 5 of the JAX run's (30, 8, 17). After the first
  divergence these counts follow float32 rounding, the reference's too:
  the JAX package run from the port's state after the bootstrap's chunk
  ends at 32, 11, 16; the port fed the draws of JAX seeds 0, 1, 2 at 29,
  10, 13-14 / 30, 11, 14 / 28, 9, 14, and run from the JAX state after
  the bootstrap's chunk at 29, 8, 15. Over these runs of both packages
  each count spans 4 or less; the bound is that span and one more.

The port's trajectories equal the JAX tool's exactly, its frames hash as
the JAX package renders them, and its ``stats`` carry the JAX tool's keys.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from sdvl_tpu.io.synthetic import PlaneScene as JScene
from sdvl_tpu.pipeline import stream as j_stream
from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig
from sdvl_tpu_torch.io.snapshot import carry_from_numpy, map_from_numpy
from sdvl_tpu_torch.io.synthetic import PlaneScene as TScene
from sdvl_tpu_torch.pipeline import config as tcfg
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from sdvl_tpu_torch.tools import long_run as t_long
from make_torch_fixtures import frames_sha256, long_setup
from torch_port_helpers import N, jax_draws, tree_to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
from tools import long_run as j_long  # noqa: E402

torch.set_num_threads(1)

K = 6
N_FRAMES = 360
CHUNK = 16
PROTOCOL = dict(n_frames=N_FRAMES, chunk=CHUNK, blackout_frac=0.65,
                blackout_len=5, span=10.0)
SCENE = dict(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320, height=240,
             plane_z=4.0, extent=12.0)
CAM = dict(width=320, height=240, fx=210.0, fy=210.0, u0=159.5, v0=119.5,
           dist=(0, 0, 0, 0, 0))
SDVL = dict(min_avg_shift=5.0, max_keyframes=K, min_keyframe_its=4,
            min_init_corners=30, max_points=1024, max_candidates=256,
            min_matches=15, map_scale=4.0)
COUNTERS = ("n_keyframes", "n_evicted", "n_pruned")


def _host(tree) -> dict:
    """A JAX MapState / SlamCarry copied to numpy (the stream donates its
    buffers to the next chunk)."""
    return {k: tuple(np.array(x) for x in v) if isinstance(v, tuple)
            else np.array(v) for k, v in tree_to_numpy(tree).items()}


@pytest.fixture(scope="module")
def runs():
    """The JAX tool's run (its state kept around every chunk) and the
    port's free run, fed the JAX draws."""
    cfg_j = Config(camera=CameraConfig(**CAM), sdvl=SdvlConfig(**SDVL))
    cfg_t = tcfg.Config(camera=tcfg.CameraConfig(**CAM),
                        sdvl=tcfg.SdvlConfig(**SDVL))
    states = []       # (map, carry) before each chunk, and after the last
    feed = j_stream.SdvlStream.feed_chunk
    streams = []

    def kept(self, imgs, block=False):
        streams.append(self)
        states.append((_host(self.m), _host(self.carry)))
        return feed(self, imgs, block)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_stream.SdvlStream, "feed_chunk", kept)
    try:
        rj, _, sj = j_long.run_protocol(cfg_j, JScene(**SCENE), **PROTOCOL)
    finally:
        mp.undo()
    js = streams[-1]
    states.append((_host(js.m), _host(js.carry)))
    draws = jax_draws(cfg_t, js.carry.key)
    kept_t = []
    rt, _, st = t_long.run_protocol(
        cfg_t, TScene(**SCENE), device="cpu", gumbel_provider=draws,
        on_chunk=lambda s, f: (kept_t.append(s), f()), **PROTOCOL)
    return dict(cfg_t=cfg_t, draws=draws, rj=rj, sj=sj, states=states,
                rt=rt, st=st, ts=kept_t[-1])


@pytest.mark.parametrize("name, kw", [
    ("long_trajectory", dict(n_frames=N_FRAMES, span=10.0)),
    ("long_trajectory", dict(n_frames=200, span=6.0, legs=3,
                             loiter=(0.3, 0.6))),
    ("lawnmower_trajectory", dict(n_frames=13000)),
    ("lawnmower_trajectory", dict(n_frames=2400, ax=12.0, y0=-6.0, y1=6.0,
                                  k=5)),
], ids=["ci", "loiter", "tool", "card"])
def test_trajectories_equal_the_jax_tools(name, kw):
    want = getattr(j_long, name)(**kw)
    got = getattr(t_long, name)(**kw)
    assert len(got) == len(want) == kw["n_frames"]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.fixture(scope="module")
def frames():
    """The protocol's frames as the JAX package renders them."""
    scene = JScene(**SCENE)
    poses = j_long.long_trajectory(N_FRAMES, span=10.0)
    b0 = int(N_FRAMES * PROTOCOL["blackout_frac"])
    return [np.zeros((240, 320), np.uint8) if b0 <= i < b0 + 5 else
            np.round(np.clip(scene.render(p), 0, 255)).astype(np.uint8)
            for i, p in enumerate(poses)]


def test_frames_and_stats_keys(runs, frames):
    """The port fed the frames the JAX package renders, and its ``stats``
    hold the JAX tool's keys with values of the same kind."""
    sj, st = runs["sj"], runs["st"]
    assert st["frames_sha256"] == frames_sha256(frames)
    assert set(sj) <= set(st), set(sj) - set(st)
    for k, v in sj.items():
        assert type(st[k]) is type(v) or v is None or st[k] is None, k
    assert st["chunks"] == -(-N_FRAMES // CHUNK) and st["replays"] == 0


def test_chunk_by_chunk_from_the_reference_state(runs, frames):
    """Each chunk from the JAX run's map and carry: the port makes the
    reference's frames and map maintenance, eviction, pruning and the
    blackout's relocalization included."""
    rj, states, cfg_t, draws = (runs["rj"], runs["states"], runs["cfg_t"],
                                runs["draws"])
    assert len(states) == -(-N_FRAMES // CHUNK) + 1
    events = {k: 0 for k in COUNTERS}
    dist, diverged = [], []
    for c, at in enumerate(range(0, N_FRAMES, CHUNK)):
        (mj, cj), (mj_next, _) = states[c], states[c + 1]
        d = draws._replace(pose=lambda i, at=at: draws.pose(at + i))
        ts = TStream(cfg_t, seed=0, device="cpu", gumbel_provider=d)
        ts._adopt(map_from_numpy(mj, device="cpu"),
                  carry_from_numpy(cj, device="cpu"))
        ts.feed_chunk(np.stack(frames[at:at + CHUNK]))
        r = ts.result()
        sl = slice(at, at + CHUNK)
        where = f"chunk at frame {at}"
        np.testing.assert_array_equal(r.states, rj.states[sl], err_msg=where)
        np.testing.assert_array_equal(r.n_corners, rj.n_corners[sl],
                                      err_msg=where)
        # the port's history is the reference's up to the chunk
        kf_t, nm_t = rj.is_keyframe.copy(), rj.n_matches.copy()
        kf_t[sl], nm_t[sl] = r.is_keyframe, r.n_matches
        first = _first_divergence(kf_t, rj.is_keyframe, nm_t, rj.n_matches,
                                  at)
        if first < at + len(r.states):
            _assert_threshold_flip(kf_t, rj.is_keyframe, nm_t, rj.n_matches,
                                   first)
            diverged.append(first)
        same = slice(0, first - at)
        if at:
            dist.append(_pose_dist(r.poses_raw[same], rj.poses_raw[sl][same]))
        else:   # the bootstrap sets the world's gauge: take it out
            tracked = r.states[same] == 2
            dist.append(_sim3_residuals(rj.trajectory[sl][same][tracked],
                                        r.trajectory[same][tracked]))
        if first < at + len(r.states):
            continue
        for k in COUNTERS:
            assert int(getattr(ts.m, k)) == int(mj_next[k]), (where, k)
            events[k] += int(mj_next[k]) - int(mj[k])
        np.testing.assert_array_equal(N(ts.m.kf_valid), mj_next["kf_valid"],
                                      err_msg=where)
        np.testing.assert_array_equal(N(ts.m.kf_frame_id),
                                      mj_next["kf_frame_id"], err_msg=where)
        pts_t, pts_j = int(ts.m.pt_valid.sum()), int(mj_next["pt_valid"].sum())
        assert abs(pts_t - pts_j) <= 0.02 * pts_j + 1, (where, pts_t, pts_j)
    dist = np.concatenate(dist)
    assert (dist <= 1e-3).mean() >= 0.9 and dist.max() <= 5e-3, dist
    # one chunk of the 23 diverges on this sequence (at frame 156)
    assert len(diverged) <= 2, diverged
    # the chunks held to the reference's map evicted, pruned, relocalized
    assert events["n_evicted"] > 0 and events["n_pruned"] > 0, events
    assert events["n_keyframes"] > K, events
    assert (rj.states == 3).any()


def _first_divergence(kf_t, kf_j, nm_t, nm_j, start=0) -> int:
    """The first frame from ``start`` on whose keyframe flag differs or
    whose match counts lie more than 2 apart; their length if none."""
    apart = np.flatnonzero((kf_t != kf_j) | (np.abs(nm_t - nm_j) > 2))
    apart = apart[apart >= start]
    return int(apart[0]) if len(apart) else len(kf_t)


def _lost_ratio(is_kf, n_matches, i):
    """The keyframe policy's "matches lost" ratio of frame ``i``: against
    the high-water mark of the matches since the last keyframe before
    it."""
    last = np.flatnonzero(is_kf[:i])[-1]
    return 1.0 - n_matches[i] / max(n_matches[last:i].max(), 1)


def _assert_threshold_flip(kf_t, kf_j, nm_t, nm_j, i):
    """Frame ``i``'s keyframe decisions part because one match puts the two
    runs on either side of the policy's 10 % threshold (a tie of float32
    rounding, not a fault)."""
    assert kf_t[i] != kf_j[i], i
    assert abs(int(nm_t[i]) - int(nm_j[i])) == 1, (i, nm_t[i], nm_j[i])
    lost = sorted((_lost_ratio(kf_t, nm_t, i), _lost_ratio(kf_j, nm_j, i)))
    assert lost[0] <= 0.1 < lost[1], (i, lost)


def _pose_dist(a, b):
    """Per frame, the largest difference between poses ``a`` and ``b`` (N,
    7), a quaternion and its negation being one rotation."""
    sign = np.where(np.sum(a[:, :4] * b[:, :4], axis=1) < 0, -1.0, 1.0)
    b = np.concatenate([b[:, :4] * sign[:, None], b[:, 4:]], axis=1)
    return np.abs(a - b).max(axis=1)


def _sim3_residuals(a, b):
    """Per frame, the distance between the camera centre of ``b``
    Sim(3)-aligned onto ``a``'s and ``a``'s."""
    from sdvl_tpu_torch.io import evaluate

    pa = evaluate.positions_from_poses(a)
    pb = evaluate.positions_from_poses(b)
    s, R, t = evaluate.umeyama(pb, pa, True)
    return np.linalg.norm((s * (R @ pb.T)).T + t - pa, axis=1)


def test_free_run_matches_jax_up_to_its_first_divergence(runs):
    rj, rt = runs["rj"], runs["rt"]
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.n_corners, rj.n_corners)
    first = _first_divergence(rt.is_keyframe, rj.is_keyframe, rt.n_matches,
                              rj.n_matches)
    # the first divergence (frame 108 on this sequence) is a keyframe
    # decision that one match flips at the policy's threshold
    if first < N_FRAMES:
        _assert_threshold_flip(rt.is_keyframe, rj.is_keyframe, rt.n_matches,
                               rj.n_matches, first)
    running = np.flatnonzero(rj.states[:first] == 2)
    assert len(running) > 60, first
    d = _sim3_residuals(rj.trajectory[running], rt.trajectory[running])
    assert (d <= 1e-3).mean() >= 0.9 and d.max() <= 5e-3, d


def test_free_run_over_the_whole_run(runs):
    """The same LOST segments and relocalization, the CI twin's assertions
    on the port's run, the map counters near the reference's."""
    sj, st, rj, rt = runs["sj"], runs["st"], runs["rj"], runs["rt"]
    assert st["lost_segments"] == sj["lost_segments"] != []
    assert sj["reloc_after_blackout"] and st["reloc_after_blackout"]
    # tests/test_long_run.py's assertions
    assert st["final_state"] == "RUNNING", st
    assert st["tracked_ratio"] > 0.85, st
    assert st["keyframes_live"] <= K, st
    assert st["keyframes_total_inserted"] >= K + 3, st
    assert st["evictions"] > 0, st
    assert (rt.states == 3).any(), st
    assert st["ate_rmse"] is not None and st["ate_rmse"] < 0.25, st
    for k in ("keyframes_total_inserted", "evictions", "prunes"):
        assert abs(st[k] - sj[k]) <= 5, (k, st[k], sj[k])
    # every live point's anchor is a live keyframe
    ts = runs["ts"]
    anchors = N(ts.m.pt_anchor_kf)[N(ts.m.pt_valid)]
    assert N(ts.m.kf_valid)[anchors].all()


def test_the_tool_runs_on_the_card_unless_told_otherwise():
    """``python -m sdvl_tpu_torch.tools.long_run`` defaults to the card and
    raises where there is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_long.main(["--frames", "16", "--kf", "2"])


RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_long_run_record.npz")


def test_long_record_is_the_jax_tools_run_cut_to_size():
    """``tests/data/torch_long_run_record.npz`` (the card's phase ``long``
    is held to it) is the JAX tool's configuration at the recorded depth,
    every recorded seed meets the tool's assertions, and the port builds
    the same configuration and path from its numbers."""
    assert os.path.getsize(RECORD) < 1e6
    rec = np.load(RECORD)
    proto = json.loads(bytes(rec["protocol"]).decode())
    stats = json.loads(bytes(rec["jax_stats"]).decode())
    K, n = proto["kf"], proto["frames"]
    assert len(stats) == len(rec["seeds"]) >= 2
    for st in stats:
        t_long.check_stats(st, K)
        assert st["frames"] == n
    assert rec["jax_state"].shape == rec["jax_n_matches"].shape == (
        len(stats), n)
    assert rec["jax_trajectory"].shape == (len(stats), n, 7)
    assert n % proto["chunk"] == 0 and proto["points"] == 160 * K
    scene_j, cfg_j = long_setup(K)
    cfg_t, scene_t = t_long.long_run_config(K, proto["points"])
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    np.testing.assert_array_equal(scene_t.tex, scene_j.tex)
    np.testing.assert_array_equal(
        np.stack(t_long.lawnmower_trajectory(n, **proto["path"])),
        np.stack(j_long.lawnmower_trajectory(n, **proto["path"])))

