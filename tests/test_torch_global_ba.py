"""The port's matrix-free PCG solve and whole-map BA against the JAX package.

``solvers/ba.py::_schur_solve_cg`` is held against the reference's on one
seeded reduced system, iteration count included; ``ba.solve`` above
``CG_KF_THRESHOLD`` keyframe slots (the PCG route it picks by itself)
against the reference's; the port's PCG against its own Cholesky solve;
``mapper.extract_global_ba`` and ``mapper.global_ba`` against the
reference's, on the dense route (6 slots) and on the PCG route (208 slots).

Tolerances: the CG updates within 1e-4 relative to their largest entry (the
iterations run in float32 in both, in different summation orders); LM
results within 5e-4 on poses and 5e-3 on points (the tolerances of
``tests/test_scale.py``, where CG and Cholesky are compared); masks and
the gauge exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.core import camera as jcam
from sdvl_tpu.core import se3 as jse3
from sdvl_tpu.pipeline import mapper as jmapper
from sdvl_tpu.solvers import ba as jba
from sdvl_tpu.state.map_state import empty_map as j_empty_map
from sdvl_tpu_torch.core import camera as tcam
from sdvl_tpu_torch.io.snapshot import map_from_numpy
from sdvl_tpu_torch.pipeline import mapper as tmapper
from sdvl_tpu_torch.solvers import ba as tba
from torch_port_helpers import N, T, synthetic_ba_problem, tree_to_numpy

torch.set_num_threads(1)


def _problems(K, P, noise=0.02, seed=0, span=None):
    arrays = synthetic_ba_problem(K, P, seed=seed, noise=noise, span=span)
    pj = jba.BAProblem(*(jnp.asarray(a) for a in arrays[:5]))
    pt = tba.BAProblem(*(T(a) for a in arrays[:5]))
    return pj, pt, arrays[5]


def _reduced_system(pj, lam=1e-4):
    """One linearization of the JAX problem: (U, V, Wm, b_c, b_p, fixed,
    lam) as numpy."""
    w_mask = pj.obs_mask.astype(jnp.float32)
    r, _, w0 = jba._residuals(pj.poses, pj.points, pj.obs_uv, w_mask)
    w = jba._robust_weights(r, w0, 0.05)
    system = jba._build_system(pj.poses, pj.points, r, w)
    return [np.asarray(a) for a in system] + [np.asarray(pj.fixed),
                                             np.float32(lam)]


@pytest.mark.parametrize("K,n_fixed,n_expected", [(8, 2, 14), (12, 10, 7)])
def test_schur_solve_cg_matches_reference(K, n_fixed, n_expected):
    """One PCG solve of a seeded reduced system: same updates, same
    iteration count as the reference's ``while_loop``. The residual
    tolerance ends both cases: 6 free cameras after 14 iterations (past
    the port's first host check at 8), 2 after 7 (before it). (With one
    free camera the block-Jacobi preconditioner is exact, the first
    iteration leaves a residual at float32 noise, and rounding decides
    whether a second one runs: not a case the count can be held to.)"""
    pj, _, _ = _problems(K=K, P=96)
    U, V, Wm, b_c, b_p, fixed, lam = _reduced_system(pj)
    fixed = fixed.copy()
    fixed[:n_fixed] = True

    args_j = [jnp.asarray(a) for a in (U, V, Wm, b_c, b_p, fixed)]
    dc_j, dp_j = (np.asarray(a) for a in jax.jit(jba._schur_solve_cg)(
        *args_j, jnp.float32(lam)))
    dc_t, dp_t, n_iter = tba._schur_solve_cg(
        *(T(a) for a in (U, V, Wm, b_c, b_p, fixed)), torch.tensor(lam))
    np.testing.assert_allclose(N(dc_t), dc_j, rtol=0,
                               atol=1e-4 * np.abs(dc_j).max())
    np.testing.assert_allclose(N(dp_t), dp_j, rtol=0,
                               atol=1e-4 * np.abs(dp_j).max())

    # the iterations the reference's while_loop runs, counted by running
    # its cond and body eagerly
    counts = []

    def counting_while_loop(cond, body, init):
        val, n = init, 0
        while bool(cond(val)):
            val, n = body(val), n + 1
        counts.append(n)
        return val

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", counting_while_loop)
        jba._schur_solve_cg(*args_j, jnp.float32(lam))
    assert n_iter.dtype == torch.int32 and n_iter.shape == ()
    assert counts == [int(n_iter)]
    assert int(n_iter) == n_expected


def test_solve_picks_pcg_above_threshold_and_matches_reference():
    """K = CG_KF_THRESHOLD + 56, P = 256: both packages take the PCG route
    by themselves; same result, and it solves the problem. The camera line
    spans 32 of the reference problem's steps (2.6 units), not 256: on
    the reference's 20-unit line the float32 solve is chaotic (see
    ``synthetic_ba_problem``)."""
    K = tba.CG_KF_THRESHOLD + 56
    pj, pt, gt = _problems(K=K, P=256, noise=0.01, span=32)
    rj = jax.jit(lambda p: jba.solve(p, huber=0.05, stage_iters=(4, 6)))(pj)
    rt = tba.solve(pt, huber=0.05, stage_iters=(4, 6))
    # one PCG solve per LM step, its count in one int32 device tensor
    cg = rt.cg_iterations.tolist()
    assert rt.cg_iterations.dtype == torch.int32 and len(cg) == 10
    # the residual tolerance ends every solve, long before the bound
    assert all(1 <= n < 64 for n in cg)
    np.testing.assert_allclose(N(rt.poses), np.asarray(rj.poses), atol=5e-4)
    np.testing.assert_allclose(N(rt.points), np.asarray(rj.points),
                               atol=5e-3)
    np.testing.assert_array_equal(N(rt.inlier_mask),
                                  np.asarray(rj.inlier_mask))
    err0 = np.abs(N(pt.poses)[2:, 4:] - gt[2:, 4:]).max()
    err1 = np.abs(N(rt.poses)[2:, 4:] - gt[2:, 4:]).max()
    assert np.isfinite(float(rt.chi2)) and err1 < 0.5 * err0, (err0, err1)


def test_pcg_matches_cholesky(monkeypatch):
    """K = 8: the port's LM with the PCG solve against the same LM with the
    dense Cholesky solve (the threshold lowered to route K = 8 to PCG)."""
    _, pt, gt = _problems(K=8, P=96)
    r_chol = tba.solve(pt, huber=0.05)
    monkeypatch.setattr(tba, "CG_KF_THRESHOLD", 4)
    r_cg = tba.solve(pt, huber=0.05)
    assert (r_cg.cg_iterations.numel() == 15
            and r_chol.cg_iterations.numel() == 0)
    np.testing.assert_allclose(N(r_cg.poses), N(r_chol.poses), atol=5e-4)
    np.testing.assert_allclose(N(r_cg.points), N(r_chol.points), atol=5e-3)
    np.testing.assert_allclose(N(r_cg.poses)[2:, 4:], gt[2:, 4:], atol=2e-3)


# ---------------------------------------------------------- whole-map BA

K_MAP, P_MAP = 6, 256
H, W = 64, 96


def _gt_map(n_slots, seed=0):
    """The map of ``tests/test_global_ba.py``: exact projections of a GT
    scene from 6 keyframes, in ``n_slots`` keyframe slots (JAX), and its
    intrinsics for both packages."""
    rs = np.random.default_rng(seed)
    intr = jcam.Intrinsics.create(90.0, 90.0, W / 2 - 0.5, H / 2 - 0.5,
                                  width=W, height=H)
    pts = jnp.asarray(rs.uniform([-2.5, -2.0, 4.0], [2.5, 2.0, 9.0],
                                 (P_MAP, 3)), jnp.float32)
    poses = jnp.stack([
        jse3.exp(jnp.asarray([0.3 * k, 0.05 * k, 0.0, 0.0, 0.02 * k, 0.0],
                             jnp.float32))
        for k in range(K_MAP)
    ])
    p_cam = jse3.transform(poses[:, None, :], pts[None, :, :])
    px = jax.vmap(lambda pc: jcam.project(intr, pc))(p_cam)
    inb = ((px[..., 0] >= 1) & (px[..., 0] <= W - 2)
           & (px[..., 1] >= 1) & (px[..., 1] <= H - 2)
           & (p_cam[..., 2] > 0.1))
    m = j_empty_map(n_kf=n_slots, n_pts=P_MAP, n_cand=8, img_shape=(H, W),
                    levels=2)
    # perturb (the two oldest keyframes stay: they pin the gauge)
    xi = jnp.asarray(rs.normal(0, 0.03, (K_MAP, 6)), jnp.float32)
    xi = xi.at[:2].set(0.0)
    dpt = jnp.asarray(rs.normal(0, 0.15, (P_MAP, 3)), jnp.float32)
    # the keyframes sit in the last slots, newest first, so that the gauge
    # is found by age and not by slot order
    slots = jnp.arange(n_slots - 1, n_slots - 1 - K_MAP, -1)
    m = m._replace(
        kf_valid=m.kf_valid.at[slots].set(True),
        kf_pose=m.kf_pose.at[slots].set(jax.vmap(jse3.boxplus)(poses, xi)),
        kf_frame_id=m.kf_frame_id.at[slots].set(
            jnp.arange(K_MAP, dtype=jnp.int32) * 10),
        pt_pos=pts + dpt,
        pt_valid=jnp.ones(P_MAP, bool),
        obs_mask=m.obs_mask.at[slots].set(inb),
        obs_px=m.obs_px.at[slots].set(px),
    )
    intr_t = tcam.Intrinsics.create(90.0, 90.0, W / 2 - 0.5, H / 2 - 0.5,
                                    width=W, height=H)
    return intr, intr_t, m, slots, poses, pts


@pytest.mark.parametrize("n_slots", [K_MAP, tba.CG_KF_THRESHOLD + 8])
def test_extract_global_ba_matches_reference(n_slots):
    intr, intr_t, mj, _, _, _ = _gt_map(n_slots)
    pj = jmapper.extract_global_ba(mj, intr)
    pt = tmapper.extract_global_ba(map_from_numpy(tree_to_numpy(mj), "cpu"),
                                   intr_t)
    for name in ("fixed", "obs_mask"):
        np.testing.assert_array_equal(N(getattr(pt, name)),
                                      np.asarray(getattr(pj, name)), name)
    for name in ("poses", "points", "obs_uv"):
        np.testing.assert_allclose(N(getattr(pt, name)),
                                   np.asarray(getattr(pj, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # the gauge: the two oldest keyframes (frame ids 0 and 10), every empty
    # slot
    assert int((~N(pt.fixed)).sum()) == K_MAP - 2


@pytest.mark.parametrize("n_slots", [K_MAP, tba.CG_KF_THRESHOLD + 8])
def test_global_ba_matches_reference(n_slots, monkeypatch):
    """Dense route (6 slots) and PCG route (208 slots): the port's write-back
    against the reference's, and the perturbed map snaps back to the
    ground truth (the criteria of ``tests/test_global_ba.py``)."""
    intr, intr_t, mj, slots, poses_gt, pts_gt = _gt_map(n_slots)
    m1j = jmapper.global_ba(mj, intr, stage_iters=(10, 10))
    solves = []
    solve = tba.solve
    monkeypatch.setattr(tba, "solve", lambda *a, **k: solves.append(
        solve(*a, **k)) or solves[-1])
    m1t = tmapper.global_ba(map_from_numpy(tree_to_numpy(mj), "cpu"),
                            intr_t, stage_iters=(10, 10))
    assert len(solves) == 1
    assert ((solves[0].cg_iterations.numel() > 0)
            == (n_slots > tba.CG_KF_THRESHOLD))
    np.testing.assert_allclose(N(m1t.kf_pose), np.asarray(m1j.kf_pose),
                               atol=5e-4)
    np.testing.assert_allclose(N(m1t.pt_pos), np.asarray(m1j.pt_pos),
                               atol=5e-3)
    np.testing.assert_array_equal(N(m1t.obs_mask), np.asarray(m1j.obs_mask))
    kf = N(m1t.kf_pose)[np.asarray(slots)]
    assert np.abs(kf[2:, 4:] - np.asarray(poses_gt)[2:, 4:]).max() < 1e-3
    med = np.median(np.linalg.norm(N(m1t.pt_pos) - np.asarray(pts_gt),
                                   axis=-1))
    assert med < 5e-3
