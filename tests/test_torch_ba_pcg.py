"""The whole-map BA's CG kernels (``ops/cuda/ba_pcg.py``,
``csrc/ba_pcg.cu``) on the CPU: their decomposition, modelled in float64
numpy, against the plain versions' ``S p`` (the einsums) and one CG
``body`` step of ``solvers/ba.py::_schur_solve_cg``; the solve's CPU path,
which is the wrapper's plain code; ``ba.solve(method="cg")`` against the
reference.

The model walks the kernels' index arithmetic: ``wt_x``'s points by block
and warp, its lanes' 16-byte groups (or single elements where K is odd)
folded by element mod 3; ``wvinv_t``'s slot tiles by point chunks, a
thread's four elements of each row, the tile's partial sums and their sum
in chunk order; the tail's update. It runs at the kernels' own tile and
chunk sizes and at small ones, so that the small ragged shapes (P = 37,
K = 13 and 14) cross several tiles and chunks. In float64 the model and the
einsums differ by rounding alone: 1e-10. The wrapper's CPU path runs the
same torch operations as the plain code, in the same order: bit for bit.
The card's tests are ``test_ba_pcg_*`` in ``tests/test_torch_cuda_kernel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.solvers import ba as jba
from sdvl_tpu_torch.ops.cuda import ba_pcg
from sdvl_tpu_torch.pipeline import device_fsm
from sdvl_tpu_torch.solvers import ba as tba
from sdvl_tpu_torch.utils import trace
from torch_port_helpers import N, T, synthetic_ba_problem

torch.set_num_threads(1)

TOL = 1e-10


# ------------------------------------------------------------------ model
def model_wt_x(Wm, x, free=None, warps=ba_pcg.WT_WARPS, blocks=3):
    """``csrc/ba_pcg.cu``'s ``wt_x`` in float64: block ``b``'s warp ``w``
    takes points b * warps + w, stepping by blocks * warps; lane l of a
    warp sums the row's 16-byte groups q = l, l + 32, ... (K even) or its
    elements e = l, l + 32, ... (K odd) by element mod 3."""
    P, K = Wm.shape[:2]
    n = K * 18
    rows = Wm.reshape(P, n)
    xs = (x if free is None else x * free[:, None]).reshape(-1)
    t = np.full((P, 3), np.nan)
    visits = np.zeros(P, int)
    for blk in range(blocks):
        for w in range(warps):
            for p in range(blk * warps + w, P, blocks * warps):
                visits[p] += 1
                a = np.zeros((32, 3))
                for lane in range(32):
                    if K % 2 == 0:
                        for q in range(lane, n // 4, 32):
                            b, r = 4 * q // 3, q % 3
                            g = rows[p, 4 * q:4 * q + 4]
                            v = (g[0] * xs[b],
                                 g[1] * (xs[b + 1] if r == 2 else xs[b]),
                                 g[2] * (xs[b] if r == 0 else xs[b + 1]),
                                 g[3] * xs[b + 1])
                            a[lane, r] += v[0] + v[3]
                            a[lane, (r + 1) % 3] += v[1]
                            a[lane, (r + 2) % 3] += v[2]
                    else:
                        for e in range(lane, n, 32):
                            a[lane, e % 3] += rows[p, e] * xs[e // 3]
                t[p] = a.sum(0)
    assert (visits == 1).all(), visits
    return t


def model_wvinv_t(WV, t, tile_slots=ba_pcg.TILE_SLOTS,
                  chunk_points=ba_pcg.CHUNK_POINTS):
    """``wvinv_t`` in float64: tile ``i`` of ``tile_slots`` slots by chunk
    ``c`` of ``chunk_points`` points; thread ``j`` of a tile sums elements
    e0 + 0..3, e0 = i * tile_slots * 18 + 4 j, of each point's row, times
    t[(j + c) mod 3]; the tile's (slots, 6) partials are the threads' sums
    three by three, and s the partials' sum in chunk order."""
    P, K = WV.shape[:2]
    n, tile_floats = K * 18, tile_slots * 18
    rows = WV.reshape(P, n)
    n_tiles, n_chunks = -(-K // tile_slots), -(-P // chunk_points)
    partial = np.full((n_chunks, K * 6), np.nan)
    for tile in range(n_tiles):
        for chunk in range(n_chunks):
            p0 = chunk * chunk_points
            pts = range(p0, min(P, p0 + chunk_points))
            acc = np.zeros(tile_floats)
            for j in range(tile_floats // 4):
                e0 = tile * tile_floats + 4 * j
                for c in range(4):
                    if e0 + c < n:
                        acc[4 * j + c] = sum(rows[p, e0 + c]
                                             * t[p, (j % 3 + c) % 3]
                                             for p in pts)
            k0 = tile * tile_slots
            for o in range(min(tile_slots, K - k0) * 6):
                partial[chunk, k0 * 6 + o] = (acc[3 * o] + acc[3 * o + 1]
                                              + acc[3 * o + 2])
    assert np.isfinite(partial).all()
    s = np.zeros(K * 6)
    for chunk in range(n_chunks):
        s = s + partial[chunk]
    return s.reshape(K, 6)


def model_ap(s, U_d, free, p):
    """The tail's ``A p`` from ``s``, in float64."""
    pm = p * free[:, None]
    y = np.einsum("kij,kj->ki", U_d, pm) - s
    return y * free[:, None] + pm * (1.0 - free)[:, None]


def model_cg_tail(s, U_d, Dinv, free, carry, max_it, tol):
    """``cg_tail`` in float64: ``(x, r, p, rz, i)`` after one iteration."""
    x, r, p, rz, i = carry
    active = i < max_it and rz > tol
    Ap = model_ap(s, U_d, free, p)
    pap = float(np.sum(p * Ap))
    alpha = rz / (pap if pap >= 1e-30 else 1e-30) if active else 0.0
    x = x + alpha * p
    r = r - alpha * Ap
    z = np.einsum("kij,kj->ki", Dinv, r)
    rz_new = float(np.sum(r * z))
    beta = rz_new / (rz if rz >= 1e-30 else 1e-30)
    if active:
        p, rz = z + beta * p, rz_new
    return x, r, p, rz, i + int(active)


# ------------------------------------------------------- the plain code
def _system(P, K, n_fixed, dtype, seed=0):
    """A seeded reduced system (U, V, Wm, b_c, b_p, fixed, lam): U and V
    symmetric positive definite, the blocks random."""
    rs = np.random.default_rng(seed)
    A = rs.normal(size=(K, 6, 6))
    B = rs.normal(size=(P, 3, 3))
    U = A @ A.transpose(0, 2, 1) + 40.0 * np.eye(6)
    V = B @ B.transpose(0, 2, 1) + 3.0 * np.eye(3)
    Wm = rs.normal(size=(P, K, 6, 3)) * (rs.uniform(size=(P, K, 1, 1))
                                         < 0.4)
    fixed = np.zeros(K, bool)
    fixed[:n_fixed] = True
    arrays = (U, V, Wm, rs.normal(size=(K, 6)), rs.normal(size=(P, 3)))
    return ([torch.tensor(a, dtype=dtype) for a in arrays]
            + [torch.tensor(fixed), torch.tensor(1e-3, dtype=dtype)])


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _loop_of(system, monkeypatch):
    """``_schur_solve_cg`` on ``system``: its result, and the ``cond``,
    ``body`` and first carry it handed to ``device_while``, with the names
    the loop closes over (``body``'s ``Wm``, ``WVinv``, ``U_d``, ``Dinv``,
    ``free``; ``cond``'s ``max_it`` and ``tol``)."""
    seen = {}
    real = device_fsm.device_while

    def spy(cond, body, carry, **kw):
        seen.update(cond=cond, body=body,
                    carry=tuple(c.clone() for c in carry))
        return real(cond, body, carry, **kw)

    monkeypatch.setattr(device_fsm, "device_while", spy)
    out = tba._schur_solve_cg(*system)
    names = _closure(seen["body"])
    names.update(_closure(seen["cond"]))
    seen.update(names)
    return out, seen


def _plain_sp(loop, p):
    """``S p`` of the loop's system by the plain versions (einsums)."""
    t = ba_pcg.wt_x_plain(loop["Wm"], p, loop["free"])
    return ba_pcg.ap_plain(ba_pcg.wvinv_t_plain(loop["WVinv"], t),
                           loop["U_d"], loop["free"], p)


SHAPES = [(37, 13, 2), (37, 14, 2), (37, 14, 0)]
# (tile slots, chunk points, wt_x warps, wt_x blocks): the kernels' own,
# and small ones that cut the small shapes into several tiles and chunks
SPLITS = [(ba_pcg.TILE_SLOTS, ba_pcg.CHUNK_POINTS, ba_pcg.WT_WARPS, 3),
          (4, 8, 2, 3), (2, 5, 4, 1)]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_model_matches_einsum_matvec(shape, split, monkeypatch):
    """The kernels' decomposition of ``S p`` equals the plain versions'
    einsums, fixed cameras and a ragged last tile and chunk included."""
    P, K, n_fixed = shape
    tile, chunk, warps, blocks = split
    _, loop = _loop_of(_system(P, K, n_fixed, torch.float64), monkeypatch)
    free = N(loop["free"])
    p = np.random.default_rng(1).normal(size=(K, 6))
    t = model_wt_x(N(loop["Wm"]), p, free, warps, blocks)
    np.testing.assert_allclose(
        t, N(torch.einsum("pkij,ki->pj", loop["Wm"], T(p * free[:, None]))),
        rtol=0, atol=TOL)
    s = model_wvinv_t(N(loop["WVinv"]), t, tile, chunk)
    np.testing.assert_allclose(
        s, N(torch.einsum("pkil,pl->ki", loop["WVinv"], T(t))), rtol=0,
        atol=TOL)
    want = N(_plain_sp(loop, T(p)))
    np.testing.assert_allclose(model_ap(s, N(loop["U_d"]), free, p), want,
                               rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_model_step_matches_cg_body(shape, frozen, monkeypatch):
    """One iteration of the model (wt_x, wvinv_t at the small split, the
    tail) against one ``body`` step of the plain code, from the loop's
    first carry; a frozen lane (the count at its bound) leaves the carry
    as it was in both."""
    P, K, n_fixed = shape
    _, loop = _loop_of(_system(P, K, n_fixed, torch.float64), monkeypatch)
    carry = loop["carry"]
    if frozen:
        carry = carry[:4] + (loop["max_it"].clone(),)
    free = N(loop["free"])
    x, r, p, rz, i = (N(c) for c in carry)
    t = model_wt_x(N(loop["Wm"]), p, free, 2, 3)
    s = model_wvinv_t(N(loop["WVinv"]), t, 4, 8)
    got = model_cg_tail(s, N(loop["U_d"]), N(loop["Dinv"]), free,
                        (x, r, p, float(rz), int(i)), int(loop["max_it"]),
                        float(loop["tol"]))
    want = loop["body"](tuple(c.clone() for c in carry))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, N(w), rtol=0,
                                   atol=TOL * max(1.0, np.abs(N(w)).max()))
    assert got[3] == pytest.approx(float(want[3]), rel=TOL, abs=TOL)
    assert got[4] == int(want[4]) == int(i) + (not frozen)
    if frozen:
        for g, c in zip(got[:3], carry[:3]):
            np.testing.assert_array_equal(g, N(c))


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_cpu_path_is_the_plain_code(shape, monkeypatch):
    """On CPU tensors (float32, as the solve runs) the solve's loop body is
    the wrapper's plain code: one ``body`` step gives what ``wt_x_plain``,
    ``wvinv_t_plain`` and ``cg_tail_plain`` give, bit for bit, and so do
    the wrapper's three functions; the back-substitution's product is
    ``wt_x_plain``'s; the solve counts its route as plain."""
    P, K, n_fixed = shape
    before = dict(trace.tracer().counters)
    out, loop = _loop_of(_system(P, K, n_fixed, torch.float32), monkeypatch)
    counters = trace.tracer().counters
    assert counters.get("ba.pcg.plain", 0) == before.get("ba.pcg.plain",
                                                         0) + 1
    assert counters.get("ba.pcg.kernel", 0) == before.get("ba.pcg.kernel",
                                                          0)
    Wm, WVinv, free = loop["Wm"], loop["WVinv"], loop["free"]
    carry = loop["carry"]
    p = carry[2]
    t = ba_pcg.wt_x_plain(Wm, p, free)
    assert torch.equal(ba_pcg.wt_x(Wm, p, free), t)
    s = ba_pcg.wvinv_t_plain(WVinv, t)
    assert torch.equal(ba_pcg.wvinv_t(WVinv, t), s)
    args = (s, loop["U_d"], loop["Dinv"], free)
    want = ba_pcg.cg_tail_plain(*args, carry, loop["max_it"], loop["tol"])
    for got in (loop["body"](tuple(c.clone() for c in carry)),
                ba_pcg.cg_tail(*args, tuple(c.clone() for c in carry),
                               loop["max_it"], loop["tol"])):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    # the update's product: no mask
    dc = out[0]
    assert torch.equal(ba_pcg.wt_x(Wm, dc), ba_pcg.wt_x_plain(Wm, dc))


def test_solve_cg_on_the_cpu_matches_reference():
    """``ba.solve(method="cg")`` on the CPU (the plain route, counted once
    an LM step) against the reference's ``solve(method="cg")`` on the
    seeded problem of ``tests/test_scale.py``: the tolerances of
    ``tests/test_torch_global_ba.py`` (5e-4 on poses, 5e-3 on points) and
    the gating's mask exactly."""
    arrays = synthetic_ba_problem(8, 96, seed=3)
    pj = jba.BAProblem(*(jnp.asarray(a) for a in arrays[:5]))
    pt = tba.BAProblem(*(T(a) for a in arrays[:5]))
    n = trace.tracer().counters.get("ba.pcg.plain", 0)
    rt = tba.solve(pt, huber=0.05, stage_iters=(3, 4), method="cg")
    rj = jax.jit(lambda p: jba.solve(p, huber=0.05, stage_iters=(3, 4),
                                     method="cg"))(pj)
    assert trace.tracer().counters["ba.pcg.plain"] == n + 7
    np.testing.assert_allclose(N(rt.poses), np.asarray(rj.poses), atol=5e-4)
    np.testing.assert_allclose(N(rt.points), np.asarray(rj.points),
                               atol=5e-3)
    np.testing.assert_array_equal(N(rt.inlier_mask),
                                  np.asarray(rj.inlier_mask))
    assert rt.cg_iterations.tolist() and all(
        n >= 1 for n in rt.cg_iterations.tolist())

