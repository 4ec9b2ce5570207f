"""The host driver on fixed storage, on the CPU.

``SDVL`` keeps its map and its inter-frame device state (``last_pyr``,
``last_pose``, ``xi_model``, ``last_match_idx``, ``last_match_ok``) in
storage written in place, so that on the card each stage is a CUDA graph
replay over the same tensors; here every stage runs eagerly on that
storage. On the small full-SLAM sequence of ``tests/test_torch_graph_step.py``
(a 128x160 ``PlaneScene`` with tracked keyframes, then featureless frames
that send it LOST long enough for the relocalizer to sweep every keyframe):

* every map and carry leaf keeps its storage from frame to frame;
* the trajectory and states match the JAX package's host driver on the same
  frames and draws, with the tolerances of ``tests/test_torch_host_fsm.py``:
  states and keyframe flags equal, ``n_matches`` within 1 on at most 15 % of
  RUNNING frames, trajectories within 1e-3 (within 1e-2 on the frames that
  coast into the LOST stretch and the good frame they coast from: see the
  test);
* a tracking frame reads one thing back to the host: the batched row of
  counts and poses (``sdvl._host_read``);
* the async mapper, with a map of its own published into the tracker's,
  tracks as the sequential driver does, with the criteria of
  ``tests/test_torch_runtime.py``, and leaves the tracker's map in its
  storage holding the mapper's last map.
"""

from __future__ import annotations

import sys

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu_torch.io import evaluate
from sdvl_tpu_torch.pipeline import sdvl as tsdvl
from sdvl_tpu_torch.pipeline.runtime import AsyncMapper
from sdvl_tpu_torch.pipeline.sdvl import SDVL, TrackingState
from torch_port_helpers import (graph_step_scene, jax_config, jax_draws,
                                small_scene)

torch.set_num_threads(1)


def _leaves(tree):
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _storage(slam):
    return [t.data_ptr() for t in _leaves(slam.m) + _leaves(slam._st.carry)]


def _traj(slam):
    return np.stack([p for _, p in slam.trajectory])


@pytest.fixture(scope="module")
def scene():
    # the host drivers' local BA takes a window of 10 keyframes
    return graph_step_scene(max_keyframes=10)


@pytest.fixture(scope="module")
def runs(scene):
    """The JAX host driver and the port's over the sequence, the port fed
    the JAX driver's draws, its storage recorded after every frame."""
    from sdvl_tpu.pipeline.sdvl import SDVL as JSDVL

    cfg, frames = scene
    draws = jax_draws(cfg, np.asarray(jax.random.PRNGKey(0)))
    js = JSDVL(jax_config(cfg), seed=0)
    ts = SDVL(cfg, seed=0, device="cpu", gumbel_provider=draws)
    ij, it, ptrs = [], [], []
    for f in frames:
        ij.append(js.handle_frame(f))
        it.append(ts.handle_frame(f))
        ptrs.append(_storage(ts))
    return js, ts, ij, it, ptrs


def test_storage_keeps_its_addresses(runs):
    """The run bootstraps, inserts tracked keyframes and goes LOST, and
    every leaf of the map and of the inter-frame state keeps its
    ``data_ptr()`` throughout."""
    _, ts, _, it, ptrs = runs
    states = [i["state"] for i in it]
    boot = next(n for n, i in enumerate(it) if i["keyframe"])
    assert any(i["keyframe"] for i in it[boot + 1:]), "no tracked keyframe"
    assert states.count("LOST") >= 4, states
    assert ts.last_pyr is not None and ts.last_match_idx is not None
    assert all(p == ptrs[0] for p in ptrs)


def test_host_driver_matches_jax_through_lost(runs):
    js, ts, ij, it, _ = runs
    assert [i["state"] for i in it] == [i["state"] for i in ij]
    assert [i["keyframe"] for i in it] == [i["keyframe"] for i in ij]
    running = np.asarray([i["state"] == "RUNNING" for i in ij])
    diff = np.abs(np.asarray([i["n_matches"] for i in it])
                  - np.asarray([i["n_matches"] for i in ij]))[running]
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.15, diff.tolist()
    # a BAD frame coasts on the motion model fitted on the good frame
    # before it, so it carries that frame's difference, once more for each
    # frame coasted. Before the blank frames that good frame (21) is the
    # one ill-conditioned pose solve of the run: in the first camera's frame
    # the reference's own two drivers put it 4.3e-4 apart (1.5e-3 after
    # three coasted frames) where every other frame agrees within 3e-5; the
    # port, solving in float64, 2.2e-3 (8.0e-3). Those frames are held
    # within 1e-2, the others within 1e-3.
    bad = np.asarray([i["state"] == "RUNNING"
                      and i["n_matches"] < ts.cfg.sdvl.min_matches
                      for i in ij])
    coast = bad | np.append(bad[1:], False)
    assert 0 < coast.sum() <= 4, coast
    tt, tj = _traj(ts), _traj(js)
    np.testing.assert_allclose(tt[~coast], tj[~coast], atol=1e-3)
    np.testing.assert_allclose(tt[coast], tj[coast], atol=1e-2)
    assert (int(ts.m.kf_valid.sum())
            == int(np.asarray(js.m.kf_valid).sum()))


_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__")


def test_tracking_frame_reads_once(scene):
    """On a RUNNING or LOST frame nothing reads a tensor back but the one
    batched read of ``(n_matches, n_attempts, pose, predicted pose)``."""
    cfg, frames = scene
    slam = SDVL(cfg, seed=0, device="cpu")
    mp = pytest.MonkeyPatch()
    allowed = [False]
    reads = []
    real_read = tsdvl._host_read

    def counted(row):
        allowed[0] = True
        try:
            reads[-1] += 1
            return real_read(row)
        finally:
            allowed[0] = False

    def guard(name):
        real = getattr(torch.Tensor, name)

        def fn(self, *a, **kw):
            if not allowed[0]:
                raise AssertionError(f"Tensor.{name} outside _host_read")
            return real(self, *a, **kw)
        return fn

    states = []
    for f in frames:
        if slam.state in (TrackingState.FIRST_FRAME,
                          TrackingState.SECOND_FRAME):
            slam.handle_frame(f)        # eager, read back
            continue
        states.append(slam.state.name)
        reads.append(0)
        mp.setattr(tsdvl, "_host_read", counted)
        for name in _READS:
            mp.setattr(torch.Tensor, name, guard(name))
        try:
            slam.handle_frame(f)
        finally:
            mp.undo()
    assert len(reads) > 20 and "LOST" in states
    assert reads == [1] * len(reads), reads


def test_async_mapper_with_two_maps_tracks_like_sequential():
    """``tests/test_torch_runtime.py``'s run and criteria with the mapper's
    own map: the tracker's map keeps its storage, the mapper's is another,
    and after ``stop`` the tracker's holds the mapper's last map."""
    _, cfg, frames, poses = small_scene(26)
    slam = SDVL(cfg, seed=0, device="cpu",
                gumbel_provider=jax_draws(cfg,
                                          np.asarray(jax.random.PRNGKey(0))))
    ptrs = _storage(slam)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    mapper = AsyncMapper(slam)
    try:
        infos = [slam.handle_frame(img) for img in frames]
        mapper.barrier()
        own = mapper._st.m
        assert own.pt_pos.data_ptr() != slam.m.pt_pos.data_ptr()
    finally:
        mapper.stop()
        sys.setswitchinterval(interval)
    assert not mapper.thread.is_alive()
    assert _storage(slam) == ptrs
    for a, b in zip(_leaves(own), _leaves(slam.m)):
        assert torch.equal(a, b)

    assert slam.state == TrackingState.RUNNING
    assert mapper.processed > 0
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
