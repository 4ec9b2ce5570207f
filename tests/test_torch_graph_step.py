"""The device-resident step on the CPU: branches as device predicates, the
state written in place.

Every decision of a tracking frame is a ``device_fsm.device_if`` (an IF node
of the CUDA graph on the card); a stream's state is fixed storage written in
place (``StepRunner``). Here, eagerly:

* in full SLAM mode, over a bootstrap, tracked keyframes and a LOST stretch
  that reaches the relocalizer's sweep of every keyframe, the in-place
  runner holds to the reference: the JAX package's stream
  (``sdvl_tpu.pipeline.device_fsm``'s step) on the same frames, fed to both
  with the JAX stream's own draws, at the tolerances of
  ``test_torch_slam.py``: states, keyframe flags and quality equal,
  ``n_matches`` within 2 (a match on a threshold may flip under different
  float32 rounding; on the featureless frames it does), trajectories
  within 1e-3 (float32 rounding in the bootstrap's solves);
* the in-place runner equals the functional step (``make_step``, the
  counterpart of the reference's: the state rebound every frame, nothing
  written) bit for bit, in full SLAM mode on that run and in serving mode;
* every map and carry leaf keeps its storage from frame to frame;
* a tracking frame reads nothing back to the host except through
  ``device_if``'s one read per decision, and makes exactly the decisions its
  state calls for.

The relocalizer's two sweeps differ in shape; the port's run records both
(the reference's, a ``lax.cond``, cannot be observed from outside, and its
states show it took the same path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from sdvl_tpu_torch.pipeline import device_fsm, relocalize
from sdvl_tpu_torch.pipeline.device_fsm import (STATE_LOST, STATE_RUNNING,
                                                StepRunner, init_state,
                                                make_step, pack_info)
from sdvl_tpu_torch.pipeline.stream import (NoiseSource, SdvlStream,
                                            SlamResult, unpack_infos)
from torch_port_helpers import graph_step_scene, jax_config, jax_draws

torch.set_num_threads(1)

N_FRAMES = 36


@pytest.fixture(scope="module")
def scene():
    return graph_step_scene()


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX stream over the frames: its result, and its draws for the
    port."""
    from sdvl_tpu.pipeline.stream import SdvlStream as JStream

    cfg, frames = scene
    js = JStream(jax_config(cfg), seed=0, donate=False)
    for f in frames:
        js.feed(f)
    return js.result(), jax_draws(cfg, js.carry.key)


def _leaves(tree):
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _run_functional(cfg, frames, m, carry, draws=None):
    step = make_step(cfg, undistort=False)
    noise = NoiseSource(cfg, 0, "cpu", draws)
    rows = []
    for i, f in enumerate(frames):
        m, carry, info, _ = step(m, carry, torch.from_numpy(f), None,
                                 noise.pose(i, 1)[0], noise.boot)
        rows.append(pack_info(info))
    return m, carry, torch.stack(rows)


def _run_inplace(cfg, frames, m, carry, tracking=False, each=None,
                 draws=None):
    runner = StepRunner(cfg, False, m, carry, tracking=tracking)
    noise = NoiseSource(cfg, 0, "cpu", draws)
    rows = []
    for i, f in enumerate(frames):
        row, _ = runner.step(torch.from_numpy(f), noise.pose(i, 1)[0],
                             noise.boot)
        rows.append(row)
        if each is not None:
            each(runner)
    return runner, torch.stack(rows)


def _lost_carry(carry):
    """A serving carry: LOST, three failed frames behind it."""
    return carry._replace(
        state=torch.tensor(STATE_LOST, dtype=torch.int32),
        lost_frames=torch.tensor(3, dtype=torch.int32),
        xi_model=torch.zeros(6))


@pytest.fixture(scope="module")
def slam_runs(scene, jax_run):
    """The functional step and the in-place runner over the sequence, fed
    the JAX stream's draws, with the relocalizer's lane counts recorded."""
    cfg, frames = scene
    draws = jax_run[1]
    mp = pytest.MonkeyPatch()
    sweeps = []
    real = relocalize.relocalize

    def recorded(*args, **kw):
        sweeps.append(kw["max_kf"])
        return real(*args, **kw)

    mp.setattr(relocalize, "relocalize", recorded)
    try:
        want = _run_functional(cfg, frames, *init_state(cfg, device="cpu"),
                               draws=draws)
        ptrs = []
        runner, rows = _run_inplace(
            cfg, frames, *init_state(cfg, device="cpu"),
            each=lambda r: ptrs.append([t.data_ptr() for t in
                                        _leaves(r.st.m)
                                        + _leaves(r.st.carry)]),
            draws=draws)
    finally:
        mp.undo()
    return cfg, want, runner, rows, ptrs, sweeps


def _assert_equal(want, runner, rows):
    m, carry, want_rows = want
    assert torch.equal(rows, want_rows), (
        "packed infos differ at frames "
        f"{torch.nonzero((rows != want_rows).any(1)).flatten().tolist()}")
    for name, a, b in (("map", m, runner.st.m),
                       ("carry", carry, runner.st.carry)):
        for field, x, y in zip(a._fields, a, b):
            for u, v in zip(_leaves((x,)), _leaves((y,))):
                assert u.dtype == v.dtype and torch.equal(u, v), \
                    f"{name}.{field}"


def _assert_scene_path(cfg, rows, sweeps):
    """The run bootstraps, inserts a tracked keyframe, goes LOST and
    escalates the relocalizer to every keyframe."""
    states = rows[:, 14].long()
    is_kf = rows[:, 18] > 0.5
    boot = int(torch.argmax(is_kf.long()))
    assert 0 < boot and states[boot] == STATE_RUNNING
    assert is_kf[boot + 1:].any(), "no tracked keyframe"
    assert (states == STATE_LOST).sum() >= 4, "no LOST stretch"
    s = cfg.sdvl
    # both relocalizer sweeps ran: nearest lanes, then every keyframe
    assert s.reloc_max_keyframes in sweeps and s.max_keyframes in sweeps


def test_inplace_step_matches_jax_slam(slam_runs, jax_run):
    """Full SLAM mode against the reference's step, through the bootstrap,
    tracked keyframes and a LOST stretch whose relocalizer escalates to
    every keyframe."""
    cfg, _, _, rows, _, sweeps = slam_runs
    _assert_scene_path(cfg, rows, sweeps)
    rj = jax_run[0]
    rt = SlamResult(unpack_infos(rows.numpy()))
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.is_keyframe, rj.is_keyframe)
    assert np.abs(rt.n_matches - rj.n_matches).max() <= 2, (
        rt.n_matches.tolist(), rj.n_matches.tolist())
    np.testing.assert_array_equal(rt.quality, rj.quality)
    np.testing.assert_allclose(rt.trajectory, rj.trajectory, atol=1e-3)


def test_inplace_step_equals_functional_step_slam(slam_runs):
    """Full SLAM mode: bit for bit, on the run held to the reference."""
    cfg, want, runner, rows, _, sweeps = slam_runs
    _assert_scene_path(cfg, rows, sweeps)
    _assert_equal(want, runner, rows)


def test_inplace_step_equals_functional_step_localize(slam_runs, scene):
    """Serving against the built map (frozen, never written), from LOST:
    bit for bit."""
    cfg, (m, carry, _), *_ = slam_runs
    frames = scene[1]
    cfg = dataclasses.replace(
        cfg, sdvl=dataclasses.replace(cfg.sdvl, localize_only=True))
    query = frames[4:16]
    before = [t.clone() for t in _leaves(m)]
    want = _run_functional(cfg, query, m, _lost_carry(carry))
    clone = lambda tree: type(tree)(*(  # noqa: E731
        tuple(t.clone() for t in v) if isinstance(v, tuple) else v.clone()
        for v in tree))
    runner, rows = _run_inplace(cfg, query, m,
                                _lost_carry(clone(carry)), tracking=True)
    assert runner.st.m is m
    assert (rows[:, 14] == STATE_RUNNING).any(), "never relocalized"
    _assert_equal(want, runner, rows)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(m)))


def test_state_keeps_its_storage(slam_runs):
    """Every MapState and SlamCarry leaf keeps its data_ptr() on every
    frame: what a replayed graph reads and writes."""
    *_, ptrs, _ = slam_runs
    assert len(ptrs) == N_FRAMES
    assert all(p == ptrs[0] for p in ptrs)


_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__")


def test_tracking_frame_reads_only_its_predicates(scene):
    """On a tracking frame nothing reads a tensor back except device_if,
    once per decision: LOST or not (and, LOST with escalation, the sweep),
    then in full SLAM mode good or not and, on a good frame, keyframe or
    not."""
    cfg, frames = scene
    st = SdvlStream(cfg, device="cpu")
    mp = pytest.MonkeyPatch()
    allowed = [False]
    reads = []
    real_read = device_fsm._host_read

    def counted(pred):
        allowed[0] = True
        try:
            reads[-1] += 1
            return real_read(pred)
        finally:
            allowed[0] = False

    def guard(name):
        real = getattr(torch.Tensor, name)

        def fn(self, *a, **kw):
            if not allowed[0]:
                raise AssertionError(f"Tensor.{name} outside device_if")
            return real(self, *a, **kw)
        return fn

    before = []
    for f in frames:
        if not st.runner.tracking:      # FIRST / SECOND: eager, read back
            st.feed(f)
            continue
        before.append(st.runner.st.carry.state.clone())
        reads.append(0)
        mp.setattr(device_fsm, "_host_read", counted)
        for name in _READS:
            mp.setattr(torch.Tensor, name, guard(name))
        try:
            info = st.feed(f)
        finally:
            mp.undo()
        reads[-1] = (reads[-1], int(info.quality) != 0)
    assert len(reads) > 20
    for state, (n, good) in zip(before, reads):
        lost = int(state) == STATE_LOST
        assert n == 2 + lost + good, (int(state), n, good)
