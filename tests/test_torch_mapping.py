"""Mapping slice, module by module: the port against ``sdvl_tpu``.

Slot allocation and covisibility ranking (with ties), the Schur-complement
BA (the cases of ``tests/test_solvers.py`` plus a system that is not
positive definite), the depth-filter functions, re-observation and the
epipolar search (corner gate off and on), point statistics, keyframe
insertion up to eviction, local BA, pruning, the redundant-keyframe check
and the per-frame map update.

The map functions start from a real map: the JAX SLAM stream over 28 frames
of a fast 320x240 sweep (several keyframes, points and live candidates),
handed to the port as numpy. Tolerances, per test: index, mask and counter
fields equal; float fields within the stated ``atol`` (float32 rounding of
batched solves and reductions differs between XLA and torch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.io.synthetic import PlaneScene
from sdvl_tpu.ops import pyramid as jpyr
from sdvl_tpu.pipeline import depth_filter as jdf
from sdvl_tpu.pipeline import mapper as jmapper
from sdvl_tpu.pipeline import matcher as jmatcher
from sdvl_tpu.pipeline import tracker as jtracker
from sdvl_tpu.pipeline.config import intrinsics as j_intrinsics
from sdvl_tpu.pipeline.stream import SdvlStream as JStream
from sdvl_tpu.solvers import ba as jba
from sdvl_tpu.state import map_state as jms
from sdvl_tpu_torch.io.snapshot import map_from_numpy
from sdvl_tpu_torch.pipeline import depth_filter as tdf
from sdvl_tpu_torch.pipeline import mapper as tmapper
from sdvl_tpu_torch.pipeline import matcher as tmatcher
from sdvl_tpu_torch.pipeline import tracker as ttracker
from sdvl_tpu_torch.pipeline.config import intrinsics as t_intrinsics
from sdvl_tpu_torch.solvers import ba as tba
from sdvl_tpu_torch.state import map_state as tms
from torch_port_helpers import (N, T, small_scene, synthetic_ba_problem,
                               tree_to_numpy, with_knobs)

torch.set_num_threads(1)


# ----------------------------------------------------------- map state

def test_alloc_slots_with_ties():
    """Free slots in index order (a stable sort of many equal keys), ranks
    past the free count rejected with the drop index."""
    rng = np.random.default_rng(0)
    for n_free in (0, 5, 37, 64):
        free = np.zeros(64, bool)
        free[rng.choice(64, n_free, replace=False)] = True
        inc = rng.random(50) < 0.6
        sj, okj = jms.alloc_slots(jnp.asarray(free), jnp.asarray(inc))
        st, okt = tms.alloc_slots(T(free), T(inc))
        np.testing.assert_array_equal(N(st), np.asarray(sj))
        np.testing.assert_array_equal(N(okt), np.asarray(okj))


def _random_map(rng, K=10, P=96):
    from sdvl_tpu.pipeline.device_fsm import init_state
    from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig

    cfg = Config(camera=CameraConfig(width=64, height=48),
                 sdvl=SdvlConfig(max_keyframes=K, max_points=P,
                                 max_candidates=32, pyramid_levels=3))
    m, _ = init_state(cfg)
    obs = rng.random((K, P)) < 0.3
    obs[3] = obs[5]                      # equal covisibility counts
    kf_valid = np.ones(K, bool)
    kf_valid[[7, 8]] = False
    centers = rng.normal(0, 1, (K, 3)).astype(np.float32)
    centers[2] = centers[6]              # equal distances
    pose = np.zeros((K, 7), np.float32)
    pose[:, 0] = 1.0
    pose[:, 4:] = -centers
    return m._replace(obs_mask=jnp.asarray(obs),
                      kf_valid=jnp.asarray(kf_valid),
                      kf_pose=jnp.asarray(pose))


def test_covisibility_and_best_connections_with_ties():
    rng = np.random.default_rng(1)
    mj = _random_map(rng)
    mt = map_from_numpy(tree_to_numpy(mj), "cpu")
    np.testing.assert_array_equal(N(tms.covisibility(mt)),
                                  np.asarray(jms.covisibility(mj)))
    for kf in range(10):
        for n in (1, 4, 9, 10):
            ij, cj = jms.best_connections(mj, jnp.asarray(kf), n)
            it, ct = tms.best_connections(mt, torch.tensor(kf), n)
            np.testing.assert_array_equal(N(it), np.asarray(ij))
            np.testing.assert_array_equal(N(ct), np.asarray(cj))
    cur = np.asarray([0.1, -0.2, 0.3], np.float32)
    assert int(tms.kf_slot_to_evict(mt, T(cur))) == int(
        jms.kf_slot_to_evict(mj, jnp.asarray(cur)))


def test_scatter_drops_and_accumulates():
    """``.at[].set(mode="drop")`` and ``.at[].add`` with repeated indices."""
    rng = np.random.default_rng(2)
    t = rng.normal(0, 1, (6, 5, 2)).astype(np.float32)
    rows = np.asarray([1, 6, 3, 6])
    cols = np.asarray([0, 2, 5, 4])
    vals = rng.normal(0, 1, (4, 2)).astype(np.float32)
    want = jnp.asarray(t).at[rows, cols].set(jnp.asarray(vals), mode="drop")
    got = tms.scatter(T(t), (T(rows), T(cols)), T(vals))
    np.testing.assert_array_equal(N(got), np.asarray(want))
    c = np.zeros(8, np.int32)
    idx = np.asarray([1, 1, 3, 8, 1, 0])
    want = jnp.asarray(c).at[idx].add(1, mode="drop")
    np.testing.assert_array_equal(
        N(tms.scatter(T(c), T(idx), 1, accumulate=True)), np.asarray(want))


# ------------------------------------------------------------------- BA

def _ba_problem(rs, P=128, K=6, noise=0.2 / 420.0, drop=0.3):
    """``tests/test_solvers.py``'s synthetic BA problem."""
    from sdvl_tpu.core import se3

    pts = rs.uniform([-2, -2, 4], [2, 2, 8], (P, 3)).astype(np.float32)
    poses = []
    for k in range(K):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.3 * k
        xi[1] = 0.05 * np.sin(k)
        xi[4] = 0.02 * k
        poses.append(np.asarray(se3.exp(jnp.asarray(xi))))
    poses = np.stack(poses)
    p_cam = np.asarray(se3.transform(jnp.asarray(poses)[None, :, :],
                                     jnp.asarray(pts)[:, None, :]))
    uv = p_cam[..., :2] / p_cam[..., 2:3]
    mask = rs.random((P, K)) > drop
    mask[:, 0] = True
    uv_noisy = uv + rs.normal(0, noise, size=uv.shape)
    return pts, poses, uv_noisy.astype(np.float32), mask


def _solve_both(problem_np, **kw):
    pj = jba.BAProblem(*(jnp.asarray(x) for x in problem_np))
    pt = tba.BAProblem(*(T(x) for x in problem_np))
    return jba.solve(pj, **kw), tba.solve(pt, **kw)


def test_ba_reduces_error_and_respects_fixed():
    """The case of ``tests/test_solvers.py:202``: port within 1e-4 of the
    reference (poses and points), and the reference test's own checks."""
    from sdvl_tpu.core import se3

    rs = np.random.default_rng(7)
    pts, poses_true, uv, mask = _ba_problem(rs, noise=0.05 / 420.0)
    K = 6
    poses0 = np.array(se3.compose(
        jax.vmap(se3.exp)(jnp.asarray(rs.normal(0, 0.01, (K, 6)),
                                      jnp.float32)),
        jnp.asarray(poses_true)))
    poses0[0] = poses_true[0]
    poses0[1] = poses_true[1]
    pts0 = pts + rs.normal(0, 0.05, pts.shape).astype(np.float32)
    fixed = np.asarray([True, True] + [False] * (K - 2))
    h = float(np.sqrt(np.float32(5.991)) / np.float32(420.0))
    rj, rt = _solve_both((poses0, fixed, pts0, uv, mask), huber=h,
                         gate_thresh=h * 2)
    np.testing.assert_allclose(N(rt.poses), np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(N(rt.points), np.asarray(rj.points),
                               atol=1e-4)
    np.testing.assert_array_equal(N(rt.inlier_mask),
                                  np.asarray(rj.inlier_mask))
    np.testing.assert_allclose(N(rt.poses)[0], poses_true[0], atol=1e-6)

    def pose_errs(ps):
        d = se3.log(se3.compose(jnp.asarray(ps),
                                se3.inverse(jnp.asarray(poses_true))))
        return np.abs(np.asarray(d)).max(axis=1)

    assert pose_errs(N(rt.poses))[2:].mean() < pose_errs(poses0)[2:].mean() \
        * 0.5
    assert np.abs(N(rt.points) - pts).mean() < 0.05


def test_ba_gates_outlier_observations():
    """The case of ``tests/test_solvers.py:247``: the same observations
    gated out as the reference, poses within 1e-4."""
    rs = np.random.default_rng(8)
    pts, poses_true, uv, mask = _ba_problem(rs, noise=0.2 / 420.0)
    P, K = mask.shape
    bad = (rs.random((P, K)) < 0.05) & mask
    uv[bad] += 0.1
    fixed = np.asarray([True] + [False] * (K - 1))
    pts0 = (pts + rs.normal(0, 0.02, pts.shape)).astype(np.float32)
    h = float(np.sqrt(np.float32(5.991)) / np.float32(420.0))
    rj, rt = _solve_both((poses_true, fixed, pts0, uv, mask), huber=h)
    inl = N(rt.inlier_mask)
    np.testing.assert_array_equal(inl, np.asarray(rj.inlier_mask))
    np.testing.assert_allclose(N(rt.poses), np.asarray(rj.poses), atol=1e-4)
    assert inl[bad].mean() < 0.2
    assert inl[mask & ~bad].mean() > 0.9


def test_ba_rejects_a_system_that_is_not_positive_definite(monkeypatch):
    """A negative Huber threshold makes every robust weight negative, so
    the reduced camera system is indefinite on some LM iterations. There
    the reference's Cholesky gives NaN and the step is rejected; the port
    must reject the same steps (``cholesky_ex`` alone would return a finite
    partial factor whose step could be accepted): results within 1e-4."""
    rs = np.random.default_rng(9)
    pts, poses, uv, mask = _ba_problem(rs, P=32, K=4)
    fixed = np.asarray([True, False, False, False])
    pts0 = (pts + 0.01).astype(np.float32)
    infos = []
    real = torch.linalg.cholesky_ex

    def spy(A, **kw):
        out = real(A, **kw)
        infos.append(int(out.info))
        return out

    monkeypatch.setattr(torch.linalg, "cholesky_ex", spy)
    rj, rt = _solve_both((poses, fixed, pts0, uv, mask), huber=-1e-3)
    assert any(i != 0 for i in infos), infos       # not PD at least once
    np.testing.assert_allclose(N(rt.poses), np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(N(rt.points), np.asarray(rj.points),
                               atol=1e-4)
    assert np.isfinite(N(rt.poses)).all() and np.isfinite(N(rt.points)).all()

    # the Schur solve itself: NaN on both sides
    U = -10.0 * np.tile(np.eye(6, dtype=np.float32), (2, 1, 1))
    V = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    Wm = np.zeros((5, 2, 6, 3), np.float32)
    b_c = np.ones((2, 6), np.float32)
    b_p = np.ones((5, 3), np.float32)
    fx = np.asarray([False, False])
    dcj, _ = jba._schur_solve(*(jnp.asarray(x) for x in (U, V, Wm, b_c,
                                                         b_p, fx)), 1e-4)
    dct, dpt = tba._schur_solve(*(T(x) for x in (U, V, Wm, b_c, b_p, fx)),
                                torch.tensor(1e-4))
    assert np.isnan(np.asarray(dcj)).all()
    assert torch.isnan(dct).all() and torch.isnan(dpt).all()


def test_ba_refuses_the_unported_cg_path():
    """Above CG_KF_THRESHOLD keyframe slots (here 201) both packages switch
    to the matrix-free PCG solve; the port, which refused this case before
    the PCG was ported, now matches the reference (poses within 5e-4,
    points within 5e-3, the gated observations equal)."""
    K, P = tba.CG_KF_THRESHOLD + 1, 64
    arrays = synthetic_ba_problem(K, P, seed=3, noise=0.01, span=32)
    pj = jba.BAProblem(*(jnp.asarray(a) for a in arrays[:5]))
    pt = tba.BAProblem(*(T(a) for a in arrays[:5]))
    rj = jax.jit(lambda p: jba.solve(p, huber=0.05, stage_iters=(3, 3)))(pj)
    rt = tba.solve(pt, huber=0.05, stage_iters=(3, 3))
    assert len(rt.cg_iterations) == 6
    np.testing.assert_allclose(N(rt.poses), np.asarray(rj.poses), atol=5e-4)
    np.testing.assert_allclose(N(rt.points), np.asarray(rj.points),
                               atol=5e-3)
    np.testing.assert_array_equal(N(rt.inlier_mask),
                                  np.asarray(rj.inlier_mask))


# ------------------------------------------------------- a real map

N_MAP = 28


@pytest.fixture(scope="module")
def live():
    """The JAX stream's map after a fast sweep, the next frame's pyramid
    and the stream's pose, for both packages."""
    cfg_j, cfg_t, _, _ = small_scene(1)
    cfg_j = with_knobs(cfg_j, min_keyframe_its=3)
    cfg_t = with_knobs(cfg_t, min_keyframe_its=3)
    scene = PlaneScene(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320,
                       height=240, plane_z=4.0)
    poses = scene.trajectory(N_MAP + 1, translation_amp=3.5, rot_amp=0.08,
                             rate=1.0 / 60.0)
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses]
    js = JStream(cfg_j, seed=0, donate=False)
    for f in frames[:N_MAP]:
        js.feed(f)
    mj = js.m
    assert int(mj.n_keyframes) >= 5
    assert int(np.asarray(mj.cand_valid).sum()) > 20
    pyr_j = tuple(jpyr.build_pyramid(jnp.asarray(frames[N_MAP],
                                                 jnp.float32),
                                     cfg_j.sdvl.pyramid_levels))
    return dict(
        cfg_j=cfg_j, cfg_t=cfg_t, intr_j=j_intrinsics(cfg_j),
        intr_t=t_intrinsics(cfg_t), mj=mj,
        mt=lambda: map_from_numpy(tree_to_numpy(mj), "cpu"),
        pyr_j=pyr_j, pyr_t=tuple(T(p) for p in pyr_j),
        pose_j=js.carry.pose, pose_t=T(js.carry.pose),
    )


_FLOAT_FIELDS = ("kf_pose", "obs_px", "pt_pos", "cand_px", "cand_bearing",
                 "cand_rho", "cand_sigma2", "cand_a", "cand_b")


def assert_maps_match(mt, mj, atol=1e-4, skip=()):
    """Every field of the port's map against the reference's: floats
    within ``atol`` (relative 1e-4 too), everything else equal."""
    for name in mj._fields:
        if name in skip:
            continue
        vj, vt = getattr(mj, name), getattr(mt, name)
        for a, b in zip(vj if isinstance(vj, tuple) else (vj,),
                        vt if isinstance(vt, tuple) else (vt,)):
            if name in _FLOAT_FIELDS:
                np.testing.assert_allclose(N(b), np.asarray(a), atol=atol,
                                           rtol=1e-4, err_msg=name)
            else:
                np.testing.assert_array_equal(N(b), np.asarray(a),
                                              err_msg=name)


def test_depth_filter_updates_elementwise():
    rng = np.random.default_rng(11)
    n = 500
    t = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    b = rng.normal(0, 1, (n, 3)).astype(np.float32)
    b[:, 2] = np.abs(b[:, 2]) + 1
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    z = rng.uniform(1, 8, n).astype(np.float32)
    ang = 0.0038
    # tau goes through arccos near +-1 (ill-conditioned): 1e-3 relative
    np.testing.assert_allclose(
        N(tdf.compute_tau(T(t), T(b), T(z), ang)),
        np.asarray(jdf.compute_tau(jnp.asarray(t), jnp.asarray(b),
                                   jnp.asarray(z), jnp.float32(ang))),
        rtol=1e-3, atol=1e-5)
    rho = rng.uniform(0.1, 0.5, n).astype(np.float32)
    sig2 = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    a = rng.uniform(1, 30, n).astype(np.float32)
    bb = rng.uniform(1, 30, n).astype(np.float32)
    x = (rho + rng.normal(0, 0.05, n)).astype(np.float32)
    tau2 = rng.uniform(1e-5, 1e-3, n).astype(np.float32)
    rr = (rho + 4 * np.sqrt(sig2)).astype(np.float32)
    args = (rho, sig2, a, bb, x, tau2, rr)
    # rho and sigma2 to 1e-4 relative; the Beta parameters a, b come from
    # the cancellation f - e / f: 1e-3 relative
    for got, want, rtol in zip(
            tdf.vogiatzis_update(*(T(v) for v in args)),
            jdf.vogiatzis_update(*(jnp.asarray(v) for v in args)),
            (1e-4, 1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=rtol,
                                   atol=1e-6)


@pytest.mark.parametrize("gate", [False, True], ids=["gate_off", "gate_on"])
def test_epipolar_search_equal(live, gate):
    mj, intr_j, intr_t = live["mj"], live["intr_j"], live["intr_t"]
    kw = dict(n_samples=32, use_orb=True, corner_gate=gate)
    rj = jax.jit(functools.partial(jmatcher.epipolar_search, intr=intr_j,
                                   **kw))(mj, cur_pyr=live["pyr_j"],
                                          pose_cur=live["pose_j"])
    rt = tmatcher.epipolar_search(live["mt"](), intr_t, live["pyr_t"],
                                  live["pose_t"], **kw)
    att = np.asarray(rj.attempted)
    assert att.sum() > 10
    np.testing.assert_array_equal(N(rt.attempted), att)
    np.testing.assert_array_equal(N(rt.ok), np.asarray(rj.ok))
    ok = np.asarray(rj.ok)
    np.testing.assert_allclose(N(rt.px)[ok], np.asarray(rj.px)[ok],
                               atol=1e-3)
    np.testing.assert_allclose(N(rt.depth_anchor)[ok],
                               np.asarray(rj.depth_anchor)[ok], rtol=1e-3)


def test_update_candidates_and_promotion_equal(live):
    mj, intr_j, intr_t = live["mj"], live["intr_j"], live["intr_t"]
    kw = dict(n_samples=32, use_orb=True, stale_kf_window=10, map_scale=4.0)

    def j_fn(m, cur_pyr, pose_cur):
        m = jdf.update_candidates(m, intr_j, cur_pyr, pose_cur, **kw)
        return jdf.promote_converged(m, 0.1)

    mj2 = jax.jit(j_fn)(mj, live["pyr_j"], live["pose_j"])
    mt2 = tdf.update_candidates(live["mt"](), intr_t, live["pyr_t"],
                                live["pose_t"], **kw)
    mt2 = tdf.promote_converged(mt2, 0.1)
    assert_maps_match(mt2, mj2, atol=1e-4)


def test_reobserve_points_equal(live):
    mj, intr_j, intr_t = live["mj"], live["intr_j"], live["intr_t"]
    slot = int(np.argmax(np.asarray(mj.kf_frame_id)))
    # the newest keyframe forgets every other observation (its covisibility
    # stays); re-linking restores some
    forget = jnp.arange(mj.pt_valid.shape[0]) % 2 == 1
    mj0 = mj._replace(obs_mask=mj.obs_mask.at[slot].set(
        mj.obs_mask[slot] & ~forget))
    mj2 = jax.jit(functools.partial(
        jmatcher.reobserve_points, intr=intr_j, n_best=5, max_reobs=128))(
        mj0, pyr=live["pyr_j"], pose=mj.kf_pose[slot],
        kf_slot=jnp.asarray(slot))
    mt0 = map_from_numpy(tree_to_numpy(mj0), "cpu")
    mt2 = tmatcher.reobserve_points(mt0, intr_t, live["pyr_t"],
                                    T(mj.kf_pose[slot]), torch.tensor(slot),
                                    n_best=5, max_reobs=128)
    assert int(np.asarray(mj2.obs_mask[slot]).sum()) > \
        int(np.asarray(mj0.obs_mask[slot]).sum())
    assert_maps_match(mt2, mj2, atol=1e-3)


def test_update_point_stats_equal(live):
    mj = live["mj"]
    rng = np.random.default_rng(12)
    S = 70
    P = mj.pt_valid.shape[0]
    idx = rng.choice(P, S, replace=False).astype(np.int32)
    attempted = rng.random(S) < 0.8
    ok = attempted & (rng.random(S) < 0.7)
    fail0 = rng.integers(0, 17, P).astype(np.int32)
    mj = mj._replace(pt_fail=jnp.asarray(fail0))
    tr_j = jtracker.TrackResult(
        pose=live["pose_j"], match_pt_idx=jnp.asarray(idx),
        match_px=jnp.zeros((S, 2)), match_ok=jnp.asarray(ok),
        match_attempted=jnp.asarray(attempted),
        match_level=jnp.zeros(S, jnp.int32), n_matches=jnp.asarray(0),
        n_attempts=jnp.asarray(0), align_error=jnp.asarray(0.0))
    tr_t = ttracker.TrackResult(*(T(np.asarray(v)) for v in tr_j))
    mt = map_from_numpy(tree_to_numpy(mj), "cpu")
    for enabled in (True, False):
        got = ttracker.update_point_stats(mt, tr_t, max_failed=15,
                                          enabled=enabled)
        want = jtracker.update_point_stats(mj, tr_j, max_failed=15,
                                           enabled=jnp.asarray(enabled))
        assert_maps_match(got, want)


def _add_kf(m, live, mt, frame_id, pose):
    """One keyframe insertion on both sides, with the live frame's corners
    and a match set of the newest keyframe's observations."""
    from sdvl_tpu.ops import fast as jfast

    intr_j, intr_t = live["intr_j"], live["intr_t"]
    s = live["cfg_j"].sdvl
    c = jfast.detect_pyramid(live["pyr_j"], levels=s.max_fast_levels,
                             cell=s.cell_size, fast_threshold=10.0,
                             st_threshold=50.0, max_features=s.num_features)
    newest = int(np.argmax(np.asarray(m.kf_frame_id)))
    obs = np.asarray(m.obs_mask[newest] & m.pt_valid)
    idx = np.nonzero(obs)[0][:70].astype(np.int32)
    S = 70
    match_idx = np.zeros(S, np.int32)
    match_idx[:len(idx)] = idx
    match_ok = np.zeros(S, bool)
    match_ok[:len(idx)] = True
    match_px = np.asarray(m.obs_px[newest])[match_idx] + 0.5
    match_level = np.zeros(S, np.int32)
    kw = dict(cell=s.cell_size, n_search_kf=5, max_reobs=128,
              scale_min_dist=0.25, map_scale=4.0, use_orb=True,
              epipolar_samples=32)
    args = (match_idx, match_px, match_ok, match_level,
            np.asarray(c.xy), np.asarray(c.level), np.asarray(c.valid))
    mj2, slot_j = jax.jit(functools.partial(jmapper.add_keyframe, intr=intr_j,
                                            **kw))(
        m, pyr=live["pyr_j"], pose=jnp.asarray(pose),
        frame_id=jnp.asarray(frame_id, jnp.int32),
        match_pt_idx=args[0], match_px=args[1], match_ok=args[2],
        match_level=args[3], corners_xy=args[4], corners_level=args[5],
        corners_valid=args[6])
    mt2, slot_t = tmapper.add_keyframe(
        mt, intr_t, live["pyr_t"], T(pose),
        torch.tensor(frame_id, dtype=torch.int32), *(T(a) for a in args),
        **kw)
    return mj2, int(slot_j), mt2, int(slot_t)


def test_add_keyframe_equal_and_evicts_when_full(live):
    mj = live["mj"]
    pose = np.asarray(live["pose_j"])
    # a free slot exists: the first one is taken
    mj2, sj, mt2, st = _add_kf(mj, live, live["mt"](), N_MAP, pose)
    assert sj == st == int(np.argmax(~np.asarray(mj.kf_valid)))
    assert_maps_match(mt2, mj2, atol=1e-3)
    # a full store: the keyframe furthest from the camera is evicted, with
    # its observation row, anchored candidates and anchored points
    K = mj.kf_valid.shape[0]
    kf_pose = np.asarray(mj.kf_pose).copy()
    kf_fid = np.asarray(mj.kf_frame_id).copy()
    empty = ~np.asarray(mj.kf_valid)
    far = np.zeros((int(empty.sum()), 7), np.float32)
    far[:, 0] = 1.0
    far[:, 4] = -np.linspace(6.0, 9.0, int(empty.sum()))   # centres x 6..9
    kf_pose[empty] = far
    kf_fid[empty] = np.arange(int(empty.sum())) + 100
    full = mj._replace(kf_valid=jnp.ones(K, bool),
                       kf_pose=jnp.asarray(kf_pose),
                       kf_frame_id=jnp.asarray(kf_fid))
    mj3, sj, mt3, st = _add_kf(full, live,
                               map_from_numpy(tree_to_numpy(full), "cpu"),
                               200, pose)
    assert sj == st
    assert int(mj3.n_evicted) == int(mt3.n_evicted) == int(mj.n_evicted) + 1
    assert_maps_match(mt3, mj3, atol=1e-3)


def test_local_ba_prune_and_redundancy_equal(live):
    """Local BA around the newest keyframe (window 9, as the step runs it
    with 10 slots), then weak-point pruning and the redundant-keyframe
    check: the port's map within 1e-4 of the reference's, masks equal."""
    mj, intr_j, intr_t = live["mj"], live["intr_j"], live["intr_t"]
    newest = int(np.argmax(np.asarray(mj.kf_frame_id)))
    K = mj.kf_valid.shape[0]
    kw = dict(window=min(10, K - 1), max_points=512)
    mj2 = jax.jit(functools.partial(jmapper.local_ba, intr=intr_j, **kw))(
        mj, center_kf=jnp.asarray(newest))
    mt2 = tmapper.local_ba(live["mt"](), intr_t, torch.tensor(newest), **kw)
    assert_maps_match(mt2, mj2, atol=1e-4)
    # the window holds the centre twice (zero-covisibility fill-in): the
    # later, fixed copy's pose is what the reference writes back
    np.testing.assert_array_equal(N(mt2.kf_pose)[newest],
                                  np.asarray(mj.kf_pose)[newest])
    assert np.abs(np.asarray(mj2.pt_pos) - np.asarray(mj.pt_pos)).max() > 0

    mj3 = jmapper.check_redundant_keyframes(jmapper.prune_weak_points(mj2))
    mt3 = tmapper.check_redundant_keyframes(tmapper.prune_weak_points(mt2))
    assert_maps_match(mt3, mj3, atol=1e-4)


def test_redundancy_rehomes_anchors():
    """Mirrors ``tests/test_mapping_growth.py``'s scale rule and
    ``tests/test_scale.py``'s re-homing on a constructed map: keyframe 1
    is redundant (its points are seen by 3 others at the same level);
    its anchored points move to their newest other observer."""
    from sdvl_tpu.pipeline.device_fsm import init_state
    from sdvl_tpu.pipeline.config import CameraConfig, Config, SdvlConfig

    cfg = Config(camera=CameraConfig(width=64, height=48),
                 sdvl=SdvlConfig(max_keyframes=6, max_points=40,
                                 max_candidates=8, pyramid_levels=3))
    m, _ = init_state(cfg)
    obs = np.zeros((6, 40), bool)
    obs[0:5, :20] = True                    # 5 keyframes see points 0..19
    obs[1, 20:22] = True                    # only kf 1 sees 20, 21
    level = np.zeros((6, 40), np.int32)
    level[4, :20] = 2                       # kf 4 only from far away
    anchor = np.full(40, 1, np.int32)
    anchor[10:] = 0
    m = m._replace(
        obs_mask=jnp.asarray(obs), obs_level=jnp.asarray(level),
        kf_valid=jnp.asarray([True] * 5 + [False]),
        kf_frame_id=jnp.asarray([0, 1, 2, 3, 4, -1], jnp.int32),
        pt_valid=jnp.asarray(np.arange(40) < 22),
        pt_anchor_kf=jnp.asarray(anchor),
        cand_valid=jnp.ones(8, bool),
        cand_kf=jnp.asarray([1, 0, 1, 2, 3, 1, 0, 0], jnp.int32))
    mj = jmapper.check_redundant_keyframes(m)
    mt = tmapper.check_redundant_keyframes(
        map_from_numpy(tree_to_numpy(m), "cpu"))
    assert_maps_match(mt, mj)
    assert not bool(mt.kf_valid[0]) or not bool(mt.kf_valid[1])
    assert int(mt.n_pruned) == 1
    assert N(mt.kf_valid)[N(mt.pt_anchor_kf)[N(mt.pt_valid)]].all()


@pytest.mark.parametrize("n,kf,since", [(100, 120, 40), (100, 105, 40),
                                         (60, 100, 3), (95, 100, 40),
                                         (0, 0, 0)])
def test_need_keyframe_equal(n, kf, since):
    """The step's tensor policy against the reference's host policy."""
    got = tmapper.need_keyframe(torch.tensor(n, dtype=torch.int32),
                                torch.tensor(kf, dtype=torch.int32),
                                torch.tensor(since, dtype=torch.int32))
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == jmapper.need_keyframe(n, kf, since)


def test_update_map_equal(live):
    """The per-frame map update (candidate filters, promotion, one
    redundant keyframe) as the step calls it."""
    mj, intr_j, intr_t = live["mj"], live["intr_j"], live["intr_t"]
    kw = dict(n_samples=32, threshold_converged=0.1, max_failed=15,
              use_orb=True, stale_kf_window=10, map_scale=4.0,
              scale_min_dist=0.25)
    mj2 = jax.jit(functools.partial(jmapper.update_map, intr=intr_j,
                                    **kw))(mj, cur_pyr=live["pyr_j"],
                                           pose_cur=live["pose_j"])
    mt2 = tmapper.update_map(live["mt"](), intr_t, live["pyr_t"],
                             live["pose_t"], **kw)
    assert_maps_match(mt2, mj2, atol=1e-4)


# ------------------------------------------------ stores filled to the end

@pytest.mark.parametrize("n_free", [0, 3], ids=["full", "three_free"])
def test_promotion_into_a_full_point_store_equal(live, n_free):
    """Converged candidates while the point store has no free slot, or
    fewer than the candidates: ``alloc_slots`` rejects the rest with the
    drop index, whose scatters (into the dump row) write nothing, and the
    rejected candidates stay candidates, as in the reference."""
    mj = live["mj"]
    P = mj.pt_valid.shape[0]
    free = np.flatnonzero(~np.asarray(mj.pt_valid))[:n_free]
    pt_valid = np.ones(P, bool)
    pt_valid[free] = False
    # every live candidate converges: a tight filter and a high inlier ratio
    cand = np.asarray(mj.cand_valid)
    assert cand.sum() > n_free + 5
    sigma2 = np.where(cand, 1e-8, np.asarray(mj.cand_sigma2))
    mj0 = mj._replace(pt_valid=jnp.asarray(pt_valid),
                      cand_sigma2=jnp.asarray(sigma2, jnp.float32),
                      cand_a=jnp.where(mj.cand_valid, 40.0, mj.cand_a))
    mj2 = jdf.promote_converged(mj0, 0.1)
    mt2 = tdf.promote_converged(map_from_numpy(tree_to_numpy(mj0), "cpu"),
                                0.1)
    assert_maps_match(mt2, mj2, atol=1e-5)
    assert int(N(mt2.pt_valid).sum()) == P
    assert int(N(mt2.cand_valid).sum()) == cand.sum() - n_free


def test_seeding_into_a_full_candidate_store_equal(live):
    """A keyframe inserted while every candidate slot is taken: no seed
    finds a slot, nothing is written through the drop index, and the map
    equals the reference's."""
    mj = live["mj"]
    C = mj.cand_valid.shape[0]
    full = mj._replace(cand_valid=jnp.ones(C, bool))
    mj2, sj, mt2, st = _add_kf(full, live,
                               map_from_numpy(tree_to_numpy(full), "cpu"),
                               N_MAP, np.asarray(live["pose_j"]))
    assert sj == st
    assert_maps_match(mt2, mj2, atol=1e-3)
    np.testing.assert_array_equal(N(mt2.cand_px), np.asarray(full.cand_px))
