"""The slice as a whole: JAX ``SdvlStream.localizer`` vs the port's.

A JAX SLAM stream maps a 320x240 ``PlaneScene`` and writes a stream
snapshot; both localizers load THAT FILE, start LOST, relocalize and track
the same query frames with the same pose-RANSAC noise (the port is handed the
Gumbel numbers the JAX stream draws from its key). The port detects on the
CPU tensor with the kernel's plain version, under the border rule that
``use_pallas_detect`` picks; it is held against both JAX routes, the key set
alike on both configs: the plain one, and the Pallas kernel in interpret
mode (``sdvl_tpu.ops.pallas.detect.fast_shi_tomasi_map`` is swapped for its
``interpret=True`` form from here; ``ops/fast.py`` imports it at call
time).

Tolerances: per-frame state and quality equal; ``n_matches`` within +-2 (a
match on a threshold may flip under different float32 rounding); poses within
1e-3 (each frame runs ~40 Gauss-Newton iterations from the previous frame's
result, so rounding differences carry over and are damped by convergence);
the map bit-identical before and after serving.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import sdvl_tpu.ops.pallas.detect as pallas_detect
from sdvl_tpu.io.snapshot import load_stream_arrays as j_load
from sdvl_tpu.io.snapshot import save_stream_snapshot
from sdvl_tpu.pipeline.stream import SdvlStream as JStream
from sdvl_tpu_torch.io.snapshot import load_stream_arrays as t_load
from sdvl_tpu_torch.ops.cuda import detect as t_detect
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from torch_port_helpers import (N, assert_info_is_result, assert_info_like,
                                mapped_stream, ransac_gumbel)

torch.set_num_threads(1)

N_MAP = 30
QUERY = slice(8, 24)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    cfg_j, cfg_t, frames, poses_gt, slam = mapped_stream(N_MAP)
    assert slam.result().state_name() == "RUNNING"
    snap = str(tmp_path_factory.mktemp("torch_serve") / "map.npz")
    save_stream_snapshot(slam, snap)
    return cfg_j, cfg_t, frames, poses_gt, snap


def _leaves(m):
    out = []
    for v in m:
        out.extend(v if isinstance(v, tuple) else [v])
    return out


def _serve(mapped, fused: bool, monkeypatch, query=None, **knobs):
    """Both localizers over the query frames (default ``frames[QUERY]``),
    with ``knobs`` set on both configs. Returns (jax result, torch result,
    port map before, port map after, launch count delta, port stream)."""
    cfg_j, cfg_t, frames, _, snap = mapped
    if knobs:
        cfg_j = dataclasses.replace(cfg_j, sdvl=dataclasses.replace(
            cfg_j.sdvl, **knobs))
        cfg_t = dataclasses.replace(cfg_t, sdvl=dataclasses.replace(
            cfg_t.sdvl, **knobs))
    if fused:
        monkeypatch.setattr(
            pallas_detect, "fast_shi_tomasi_map",
            functools.partial(pallas_detect.fast_shi_tomasi_map,
                              interpret=True))
        cfg_j, cfg_t = (dataclasses.replace(c, sdvl=dataclasses.replace(
            c.sdvl, use_pallas_detect=True)) for c in (cfg_j, cfg_t))
    if query is None:
        query = frames[QUERY]

    jloc = JStream.localizer(cfg_j, snap, seed=1, donate=False)
    key, fid0 = jloc.carry.key, int(jloc.carry.frame_id)
    s = cfg_j.sdvl
    n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
    n_lanes = int(jloc.carry.last_idx.shape[0])
    noise = [ransac_gumbel(key, fid0 + i, n_hyp, n_lanes)
             for i in range(len(query))]
    for f in query:
        jloc.feed(f)
    rj = jloc.result()

    tloc = TStream.localizer(cfg_t, snap, seed=1, device="cpu",
                             gumbel_provider=lambda i: noise[i])
    before = [t.clone() for t in _leaves(tloc.m)]
    launches = t_detect.launches()
    half = len(query) // 2
    for f in query[:half]:                      # frame by frame ...
        tloc.feed(f)
    tloc.feed_chunk(np.stack(query[half:]), block=True)   # ... and chunked
    rt = tloc.result()
    return rj, rt, before, _leaves(tloc.m), \
        t_detect.launches() - launches, tloc


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_localizer_matches_jax(mapped, fused, monkeypatch):
    rj, rt, before, after, launches, tloc = _serve(mapped, fused, monkeypatch)
    n = rj.n_frames
    assert rt.n_frames == n == QUERY.stop - QUERY.start
    # the JAX localizer itself must have relocalized and tracked
    running = rj.states == 2
    assert int(np.argmax(running)) <= 5 and running[-5:].all()
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.quality, rj.quality)
    np.testing.assert_array_equal(rt.is_keyframe, rj.is_keyframe)
    assert np.abs(rt.n_matches - rj.n_matches).max() <= 2
    assert np.abs(rt.n_attempts - rj.n_attempts).max() <= 2
    np.testing.assert_allclose(rt.poses_raw, rj.poses_raw, atol=1e-3)
    np.testing.assert_allclose(rt.trajectory, rj.trajectory, atol=1e-3)
    # the map is frozen, bit for bit
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    # on the CPU the wrapper takes the plain version: no kernel launch
    assert launches == 0
    # detection ran on every frame whatever the route
    assert int(tloc.last_corners.valid.sum()) > 10
    assert int(tloc.carry.frame_id) == N_MAP + n


def test_feed_chunk_returns_the_references_frame_info(mapped):
    """``feed_chunk`` returns one FrameInfo with (T, ...) leaves: the
    reference's leaves and numbers (this file's tolerances) on the same
    query frames and noise, and what ``result()`` then reports."""
    cfg_j, cfg_t, frames, _, snap = mapped
    query = np.stack(frames[QUERY])
    jloc = JStream.localizer(cfg_j, snap, seed=1, donate=False)
    key, fid0 = jloc.carry.key, int(jloc.carry.frame_id)
    s = cfg_j.sdvl
    n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
    n_lanes = int(jloc.carry.last_idx.shape[0])
    noise = [ransac_gumbel(key, fid0 + i, n_hyp, n_lanes)
             for i in range(len(query))]
    info_j = jloc.feed_chunk(query)
    tloc = TStream.localizer(cfg_t, snap, seed=1, device="cpu",
                             gumbel_provider=lambda i: noise[i])
    info = tloc.feed_chunk(query)
    assert info.pose.shape == (len(query), 7)
    assert_info_like(info, info_j)
    for k in ("state", "quality", "is_keyframe"):
        np.testing.assert_array_equal(N(getattr(info, k)),
                                      np.asarray(getattr(info_j, k)))
    assert np.abs(N(info.n_matches) - np.asarray(info_j.n_matches)).max() \
        <= 2
    np.testing.assert_allclose(N(info.pose), np.asarray(info_j.pose),
                               atol=1e-3)
    assert_info_is_result(info, tloc.result(), slice(None))


def test_lost_recovery_and_escalation_match_jax(mapped, monkeypatch):
    """Tracking, then six black frames (BAD quality three times, then LOST:
    the bounded two-lane relocalization fails, and after one more failed
    frame the all-keyframe sweep runs), then real frames again: the port
    goes through the same states as the reference and recovers with it."""
    _, _, frames, _, _ = mapped
    black = np.zeros_like(np.asarray(frames[0]))
    query = list(frames[8:12]) + [black] * 6 + list(frames[12:18])
    rj, rt, before, after, _, _ = _serve(
        mapped, False, monkeypatch, query=query,
        reloc_max_keyframes=2, reloc_escalate_after=1)
    states = rj.states.tolist()
    assert states[3] == 2 and 3 in states[4:10], states     # RUNNING -> LOST
    assert states[-1] == 2, states                          # and back
    assert (rj.quality[4:10] == 0).all()
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.quality, rj.quality)
    assert np.abs(rt.n_matches - rj.n_matches).max() <= 2
    good = rj.quality != 0
    np.testing.assert_allclose(rt.poses_raw[good], rj.poses_raw[good],
                               atol=1e-3)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_snapshot_loader_round_trip(mapped):
    """The JAX snapshot file through both loaders: every field equal (the
    port widens uint32 words and index fields to int64, values kept)."""
    *_, snap = mapped
    mj, cj = j_load(snap)
    mt, ct = t_load(snap, device="cpu")
    for tree_j, tree_t in ((mj, mt), (cj, ct)):
        assert tree_j._fields == tree_t._fields
        for name in tree_j._fields:
            vj, vt = getattr(tree_j, name), getattr(tree_t, name)
            if isinstance(vj, tuple):
                assert len(vj) == len(vt) > 0
                for a, b in zip(vj, vt):
                    np.testing.assert_array_equal(N(b), np.asarray(a))
            else:
                assert tuple(vt.shape) == tuple(np.shape(vj)), name
                np.testing.assert_array_equal(N(vt), np.asarray(vj))
    assert mt.pt_desc.dtype == torch.int64 and int(mt.pt_desc.min()) >= 0
    assert mt.obs_level.dtype == torch.int64
    assert int(ct.state) == 2 and int(ct.frame_id) == N_MAP


def test_snapshot_loader_rejects_other_format(mapped, tmp_path):
    import json

    *_, snap = mapped
    with np.load(snap) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["host_json"] = np.frombuffer(
        json.dumps({"format_version": 99}).encode(), dtype=np.uint8)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="snapshot format"):
        t_load(bad, device="cpu")


def test_snapshot_counters_default_to_zero(mapped, tmp_path):
    """Counters added after snapshots existed load as 0 when missing."""
    *_, snap = mapped
    with np.load(snap) as z:
        arrays = {k: z[k] for k in z.files
                  if k not in ("map.n_evicted", "map.n_pruned")}
    old = str(tmp_path / "old.npz")
    np.savez(old, **arrays)
    mt, _ = t_load(old, device="cpu")
    assert int(mt.n_evicted) == 0 and int(mt.n_pruned) == 0
    assert mt.n_evicted.dtype == torch.int32


def test_capacity_mismatch_raises(mapped):
    _, cfg_t, _, _, snap = mapped
    other = dataclasses.replace(cfg_t, sdvl=dataclasses.replace(
        cfg_t.sdvl, max_points=256))
    with pytest.raises(ValueError, match="capacities"):
        TStream.localizer(other, snap, device="cpu")


def test_cuda_without_a_card_raises(mapped):
    """No fallback that hides the device: the default device is "cuda" and
    a machine without one refuses, in the stream and in the loader."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the refusal cannot be shown")
    _, cfg_t, _, _, snap = mapped
    with pytest.raises(RuntimeError, match="cuda"):
        TStream.localizer(cfg_t, snap)
    with pytest.raises(RuntimeError, match="cuda"):
        t_load(snap)


def test_default_noise_comes_from_the_generator(mapped):
    """Without a provider the stream draws its RANSAC noise from its own
    torch.Generator: same seed, same run; and it still localizes."""
    _, cfg_t, frames, _, snap = mapped
    runs = []
    for _ in range(2):
        loc = TStream.localizer(cfg_t, snap, seed=3, device="cpu")
        loc.feed_chunk(np.stack(frames[8:14]))
        runs.append(loc.result())
    np.testing.assert_array_equal(runs[0].poses_raw, runs[1].poses_raw)
    assert runs[0].state_name() == "RUNNING"
    assert (runs[0].n_matches[runs[0].states == 2] >= 15).all()
