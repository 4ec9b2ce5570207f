"""The device loops on the CPU: ``device_fsm.device_while`` and
``device_fori`` (WHILE nodes of a CUDA graph on the card, Python loops
here), the PCG solve that runs on them, and ``SdvlStream.feed_chunk`` (on
the card one replay of a WHILE node over the step, here one eager step per
frame).

* ``device_while``'s eager loop gives the same carry whatever
  ``check_every`` (the body freezes its carry once the predicate is false)
  and reads the predicate once per ``check_every`` iterations; within
  ``warming()`` its body runs once and nothing is read back; so does
  ``device_fori``'s, which eagerly reads nothing back;
* ``solvers/ba.py::_schur_solve_cg`` against the JAX ``_schur_solve_cg``:
  the same iteration count as the reference's ``while_loop`` (counted by
  running its cond and body eagerly), ``dc``/``dp`` within the tolerances
  of ``tests/test_torch_global_ba.py`` (1e-4 of the largest entry), and
  bit-identical between a host read every iteration and every
  ``CG_CHECK_EVERY``;
* ``SdvlStream.feed_chunk`` equals per-frame ``feed`` from frame 0 through
  the bootstrap on the small sequence of ``tests/test_torch_graph_step.py``:
  every frame's packed info and the final map and carry, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.solvers import ba as jba
from sdvl_tpu_torch.pipeline import device_fsm
from sdvl_tpu_torch.pipeline.device_fsm import (device_fori, device_while,
                                                warming)
from sdvl_tpu_torch.pipeline.stream import SdvlStream
from sdvl_tpu_torch.solvers import ba as tba
from torch_port_helpers import (N, T, graph_step_scene, synthetic_ba_problem)

torch.set_num_threads(1)


def _counted_reads(monkeypatch):
    reads = []
    real = device_fsm._host_read

    def counted(pred):
        reads.append(bool(pred))
        return real(pred)

    monkeypatch.setattr(device_fsm, "_host_read", counted)
    return reads


def _collatz(c):
    """A frozen-lane loop body: halve or 3n+1 until 1, counting steps;
    the carry stops moving once it is 1."""
    n, steps = c
    active = n != 1
    nxt = torch.where(n % 2 == 0, n // 2, 3 * n + 1)
    return (torch.where(active, nxt, n),
            steps + active.to(torch.int64))


@pytest.mark.parametrize("start", [1, 6, 27])
def test_device_while_result_does_not_depend_on_check_every(start,
                                                            monkeypatch):
    reads = _counted_reads(monkeypatch)
    carry = (torch.tensor(start), torch.tensor(0))
    out = {}
    for every in (1, 8):
        reads.clear()
        out[every] = device_while(lambda c: c[0] != 1, _collatz, carry,
                                  max_iters=200, check_every=every)
        steps = int(out[every][1])
        # one read before every `every`-th iteration, the last one false
        assert len(reads) == -(-steps // every) + 1 and reads[-1] is False
    want = {1: 0, 6: 8, 27: 111}[start]
    for every in (1, 8):
        assert int(out[every][0]) == 1 and int(out[every][1]) == want


def test_device_while_stops_at_max_iters():
    out = device_while(lambda c: c < 100, lambda c: c + 1,
                       torch.tensor(0), max_iters=7, check_every=3)
    assert int(out) == 7


def test_loops_run_their_body_once_while_warming(monkeypatch):
    reads = _counted_reads(monkeypatch)
    calls = []

    def body(c):
        calls.append(1)
        return c + 1

    def fori_body(i, c):
        calls.append(2)
        return c + i

    with warming():
        a = device_while(lambda c: c < 100, body, torch.tensor(0),
                         max_iters=100)
        b = device_fori(10, fori_body, torch.tensor(5))
    assert calls == [1, 2] and not reads
    assert int(a) == 1 and int(b) == 5


def test_device_fori_reads_nothing_back(monkeypatch):
    reads = _counted_reads(monkeypatch)
    out = device_fori(5, lambda i, c: (c[0] + i, c[1] * 2),
                      (torch.tensor(0), torch.tensor(1.0)))
    assert not reads
    assert int(out[0]) == 10 and float(out[1]) == 32.0


@pytest.mark.parametrize("K,n_fixed", [(10, 2), (16, 6), (24, 21)])
def test_schur_solve_cg_counts_and_updates_match_reference(K, n_fixed,
                                                           monkeypatch):
    """One PCG solve of a seeded reduced system against the reference's:
    the iteration count its while_loop runs, the updates within 1e-4 of
    their largest entry; the port's eager loop bit-identical whether it
    reads the predicate every iteration or every CG_CHECK_EVERY."""
    arrays = synthetic_ba_problem(K, 96, seed=K, noise=0.02)
    pj = jba.BAProblem(*(jnp.asarray(a) for a in arrays[:5]))
    w_mask = pj.obs_mask.astype(jnp.float32)
    r, _, w0 = jba._residuals(pj.poses, pj.points, pj.obs_uv, w_mask)
    w = jba._robust_weights(r, w0, 0.05)
    system = [np.asarray(a) for a in jba._build_system(pj.poses, pj.points,
                                                       r, w)]
    fixed = np.asarray(pj.fixed).copy()
    fixed[:n_fixed] = True
    lam = np.float32(1e-3)

    args_j = [jnp.asarray(a) for a in system + [fixed]]
    counts = []

    def counting_while_loop(cond, body, init):
        val, n = init, 0
        while bool(cond(val)):
            val, n = body(val), n + 1
        counts.append(n)
        return val

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", counting_while_loop)
        dc_j, dp_j = (np.asarray(a) for a in jba._schur_solve_cg(
            *args_j, jnp.float32(lam)))

    args_t = [T(a) for a in system + [fixed]]
    runs = {}
    for every in (1, tba.CG_CHECK_EVERY):
        monkeypatch.setattr(tba, "CG_CHECK_EVERY", every)
        runs[every] = tba._schur_solve_cg(*args_t, torch.tensor(lam))
    dc_t, dp_t, n_iter = runs[1]
    for a, b in zip(runs[1], runs[tba.CG_CHECK_EVERY]):
        assert torch.equal(a, b)
    assert counts == [int(n_iter)] and int(n_iter) >= 1
    np.testing.assert_allclose(N(dc_t), dc_j, rtol=0,
                               atol=1e-4 * np.abs(dc_j).max())
    np.testing.assert_allclose(N(dp_t), dp_j, rtol=0,
                               atol=1e-4 * np.abs(dp_j).max())


def _leaves(tree):
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


@pytest.mark.parametrize("chunks", [(5, 7, 9, 15), (16, 20)])
def test_feed_chunk_equals_per_frame_feed_from_frame_0(chunks):
    cfg, frames = graph_step_scene()
    frames = frames[:sum(chunks)]
    one = SdvlStream(cfg, device="cpu")
    for f in frames:
        one.feed(f)
    many = SdvlStream(cfg, device="cpu")
    at = 0
    for t in chunks:
        infos = many.feed_chunk(np.stack(frames[at:at + t]))
        assert infos.pose.shape[0] == t
        at += t
    rows = torch.stack(one._rows)
    assert torch.equal(rows, torch.stack(many._rows))
    # through the bootstrap and into tracking
    boot = int(torch.argmax((rows[:, 18] > 0.5).long()))
    assert 0 < boot < len(frames) - 4
    for a, b in zip(_leaves(one.m) + _leaves(one.carry),
                    _leaves(many.m) + _leaves(many.carry)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(one.last_corners, many.last_corners):
        assert torch.equal(a, b)
