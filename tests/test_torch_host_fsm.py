"""The host driver: the port's ``SDVL`` against the JAX package's ``SDVL``
and against the port's own stream, and host-driver snapshots across the two
packages.

Both drivers run the 320x240 ``PlaneScene`` frames of the other slice tests
from an empty map, the port fed the random draws the JAX driver derives
from ``fold_in(key, 0 | 1 | frame_id)``; both configs set
``use_pallas_detect``, so the JAX driver detects with its Pallas kernel in
interpret mode and the port under that kernel's border rule
(``torch_port_helpers.detect_route``).

Tolerances: per-frame states and keyframe flags equal; ``n_matches`` within
1 on at most 15 % of RUNNING frames (the criteria of
``tests/test_stream_fsm.py``: a match on a threshold may flip under other
float32 rounding); trajectories within 1e-3 against JAX (the ground-plane
rotation amplifies float32 differences of the bootstrap, see
``tests/test_torch_slam.py``) and within 1e-4 against the port's stream
(the criterion of ``tests/test_stream_fsm.py``); a resumed port session
within 1e-6 of the uninterrupted one (``tests/test_snapshot.py``).
"""

import dataclasses
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu.io import snapshot as jsnap
from sdvl_tpu.pipeline.sdvl import SDVL as JSDVL
from sdvl_tpu_torch.io import snapshot as tsnap
from sdvl_tpu_torch.pipeline.sdvl import SDVL as TSDVL
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from torch_port_helpers import (detect_route, jax_draws, small_scene,
                                with_knobs)

torch.set_num_threads(1)

N_FRAMES = 30
N_SAVE = 12


def _traj(slam):
    return np.stack([p for _, p in slam.trajectory])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port host drivers over the frames, each saving a
    snapshot after ``N_SAVE`` frames."""
    tmp = tmp_path_factory.mktemp("host")
    cfg_j, cfg_t, frames, poses = small_scene(N_FRAMES)
    cfg_j = with_knobs(cfg_j, use_pallas_detect=True)
    cfg_t = with_knobs(cfg_t, use_pallas_detect=True)
    draws = jax_draws(cfg_t, np.asarray(jax.random.PRNGKey(0)))
    js = JSDVL(cfg_j, seed=0)
    ts = TSDVL(cfg_t, seed=0, device="cpu", gumbel_provider=draws)
    ij, it = [], []
    with detect_route("pallas"):
        for i, f in enumerate(frames):
            if i == N_SAVE:
                jsnap.save_snapshot(js, str(tmp / "jax.npz"))
                tsnap.save_snapshot(ts, str(tmp / "port.npz"))
            ij.append(js.handle_frame(f))
            it.append(ts.handle_frame(f))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, frames=frames, poses=poses,
                draws=draws, js=js, ts=ts, ij=ij, it=it, tmp=tmp)


def _matches_close(a, b, running):
    diff = np.abs(np.asarray(a) - np.asarray(b))[running]
    assert diff.max() <= 1, (a, b)
    assert (diff > 0).mean() <= 0.15, (a, b)


def test_host_driver_matches_reference(runs):
    ij, it = runs["ij"], runs["it"]
    assert [i["state"] for i in it] == [i["state"] for i in ij]
    assert [i["keyframe"] for i in it] == [i["keyframe"] for i in ij]
    assert runs["ts"].state.name == "RUNNING"
    running = np.asarray([i["state"] == "RUNNING" for i in ij])
    assert running.sum() >= 20
    _matches_close([i["n_matches"] for i in it],
                   [i["n_matches"] for i in ij], running)
    np.testing.assert_allclose(_traj(runs["ts"]), _traj(runs["js"]),
                               atol=1e-3)
    np.testing.assert_allclose(runs["ts"].get_pose(),
                               np.asarray(runs["js"].get_pose()), atol=1e-3)
    assert runs["ts"].frame_id == runs["js"].frame_id == N_FRAMES
    assert (int(runs["ts"].m.kf_valid.sum())
            == int(np.asarray(runs["js"].m.kf_valid).sum()))


def test_host_driver_matches_the_stream(runs):
    """Same port functions, same decisions: the host driver and the stream
    give the same trajectory (the reference's criterion between its two
    drivers)."""
    st = TStream(runs["cfg_t"], seed=0, device="cpu",
                 gumbel_provider=runs["draws"])
    for f in runs["frames"]:
        st.feed(f)
    r = st.result()
    np.testing.assert_allclose(r.trajectory, _traj(runs["ts"]), atol=1e-4)
    host_matches = np.asarray([i["n_matches"] for i in runs["it"]])
    running = r.states == 2
    running[np.argmax(running)] = False   # bootstrap frame: inlier count
    _matches_close(r.n_matches, host_matches, running)
    assert (r.is_keyframe == np.asarray([i["keyframe"]
                                         for i in runs["it"]])).all()


def test_port_snapshot_resumes_identically(runs):
    ts2 = TSDVL(runs["cfg_t"], seed=0, device="cpu",
                gumbel_provider=runs["draws"])
    tsnap.load_snapshot(ts2, str(runs["tmp"] / "port.npz"))
    assert ts2.frame_id == N_SAVE and ts2.state.name == "RUNNING"
    for f in runs["frames"][N_SAVE:]:
        ts2.handle_frame(f)
    np.testing.assert_allclose(_traj(ts2), _traj(runs["ts"]), rtol=0,
                               atol=1e-6)
    assert int(ts2.m.pt_valid.sum()) == int(runs["ts"].m.pt_valid.sum())
    assert int(ts2.m.kf_valid.sum()) == int(runs["ts"].m.kf_valid.sum())


def test_snapshots_cross_packages(runs):
    """A port snapshot resumes in the JAX driver, a JAX snapshot in the
    port's, each continuing as the other package's uninterrupted run."""
    js2 = JSDVL(runs["cfg_j"], seed=0)
    jsnap.load_snapshot(js2, str(runs["tmp"] / "port.npz"))
    ts2 = TSDVL(runs["cfg_t"], seed=0, device="cpu",
                gumbel_provider=runs["draws"])
    tsnap.load_snapshot(ts2, str(runs["tmp"] / "jax.npz"))
    assert js2.frame_id == ts2.frame_id == N_SAVE
    assert js2.state.name == ts2.state.name == "RUNNING"
    with detect_route("pallas"):
        for f in runs["frames"][N_SAVE:]:
            js2.handle_frame(f)
            ts2.handle_frame(f)
    np.testing.assert_allclose(_traj(js2), _traj(runs["js"]), atol=1e-3)
    np.testing.assert_allclose(_traj(ts2), _traj(runs["ts"]), atol=1e-3)


def test_capacity_mismatch_rejected(runs):
    cfg = runs["cfg_t"]
    bad = dataclasses.replace(
        cfg, sdvl=dataclasses.replace(cfg.sdvl, max_points=256))
    slam = TSDVL(bad, seed=0, device="cpu")
    with pytest.raises(ValueError, match="capacities"):
        tsnap.load_snapshot(slam, str(runs["tmp"] / "jax.npz"))


def test_atomic_save_never_corrupts(runs, tmp_path):
    dst = tmp_path / "c.npz"
    tsnap.save_snapshot(runs["ts"], str(dst))
    before = dst.read_bytes()
    with mock.patch("numpy.savez_compressed",
                    side_effect=RuntimeError("disk full")):
        with pytest.raises(RuntimeError):
            tsnap.save_snapshot(runs["ts"], str(dst))
    assert dst.read_bytes() == before
    assert not list(tmp_path.glob("*.tmp"))


def test_tum_trajectory_export(runs, tmp_path):
    out = tmp_path / "traj.txt"
    tsnap.save_trajectory_tum(runs["ts"], str(out))
    rows = np.loadtxt(out)
    assert rows.shape == (N_FRAMES, 8)
    assert np.isfinite(rows).all()


@pytest.fixture(scope="module")
def own_draws(runs):
    """The port's host driver on its own draws (no provider) over the
    frames, saving a snapshot after ``N_SAVE``; the same session resumed
    from that snapshot without a provider; the port's stream on its own
    draws."""
    frames, cfg = runs["frames"], runs["cfg_t"]
    snap = str(runs["tmp"] / "own.npz")
    whole = TSDVL(cfg, seed=3, device="cpu")
    for i, f in enumerate(frames):
        if i == N_SAVE:
            tsnap.save_snapshot(whole, snap)
        whole.handle_frame(f)
    resumed = TSDVL(cfg, seed=0, device="cpu")   # the snapshot's seed wins
    tsnap.load_snapshot(resumed, snap)
    for f in frames[N_SAVE:]:
        resumed.handle_frame(f)
    st = TStream(cfg, seed=3, device="cpu")
    for f in frames:
        st.feed(f)
    return whole, resumed, st.result()


def test_resume_without_provider_continues_the_session(own_draws):
    """Each frame's noise is keyed by its frame id: a session resumed
    without a provider draws what the uninterrupted one drew (within 1e-6,
    the criterion of ``tests/test_snapshot.py``)."""
    whole, resumed, _ = own_draws
    assert whole.state.name == "RUNNING"
    assert resumed.frame_id == whole.frame_id == N_FRAMES
    # the snapshot carries the trajectory so far
    np.testing.assert_allclose(_traj(resumed), _traj(whole), rtol=0,
                               atol=1e-6)
    assert int(resumed.m.pt_valid.sum()) == int(whole.m.pt_valid.sum())
    assert int(resumed.m.kf_valid.sum()) == int(whole.m.kf_valid.sum())


def test_own_draws_agree_between_drivers(own_draws):
    """Without a provider, the host driver and the stream with one seed
    draw the same numbers (keyed draws; the host driver draws only on
    tracking frames): same trajectory within 1e-4 and same keyframes."""
    whole, _, r = own_draws
    np.testing.assert_allclose(r.trajectory, _traj(whole), atol=1e-4)
    assert r.state_name() == "RUNNING"
    assert (r.states == 2).sum() >= 20
