"""The port's own copies of the NumPy-only io modules, against the reference.

``sdvl_tpu_torch.io.synthetic`` renders without OpenCV: its bilinear remap
must reproduce ``cv2.remap`` (as the reference calls it) bit for bit, since
the GPU run checks the SHA-256 of the rendered frames against the fixture.
``sdvl_tpu_torch.io.evaluate`` must score as the reference does.

Tolerances: renders, textures, trajectories and the NumPy-only metrics
exactly equal; metrics that compose poses (the port's ``se3`` in torch
against the reference's in JAX) within 1e-6.
"""

import hashlib
from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

from sdvl_tpu.io import evaluate as j_eval
from sdvl_tpu.io import synthetic as j_syn
from sdvl_tpu_torch.io import evaluate as t_eval
from sdvl_tpu_torch.io import synthetic as t_syn

torch.set_num_threads(1)

PLANE_SETUPS = [
    # (fx, fy, cx, cy, width, height), trajectory kwargs, frames rendered
    pytest.param((517.3, 516.5, 318.6, 255.3, 640, 480),
                 dict(translation_amp=1.0), (0, 17, 39), id="preset640x480"),
    pytest.param((210.0, 210.0, 159.5, 119.5, 320, 240), {}, (0, 5, 29),
                 id="320x240"),
    pytest.param((210.0, 210.0, 119.5, 159.5, 240, 320), {}, (0, 9),
                 id="240x320"),
]


@pytest.mark.parametrize("intr,traj_kw,picks", PLANE_SETUPS)
def test_plane_scene_renders_bit_identical(intr, traj_kw, picks):
    fx, fy, cx, cy, w, h = intr
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h, plane_z=4.0)
    sj, st = j_syn.PlaneScene(**kw), t_syn.PlaneScene(**kw)
    np.testing.assert_array_equal(st.tex, sj.tex)
    n = max(picks) + 1
    pj, pt = sj.trajectory(n, **traj_kw), st.trajectory(n, **traj_kw)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b, a)
    for i in picks:
        a, b = sj.render(pj[i]), st.render(pt[i])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
        # the uint8 frames a stream is fed, and their digest
        ua = np.clip(a, 0, 255).astype(np.uint8)
        ub = np.clip(b, 0, 255).astype(np.uint8)
        assert hashlib.sha256(ua.tobytes()).hexdigest() == \
            hashlib.sha256(ub.tobytes()).hexdigest()


def test_distorted_and_multiplane_scenes_render_bit_identical():
    dist = (-0.28, 0.07, 0.0002, -0.0001, 0.0)
    kw = dict(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320,
              height=240, plane_z=4.0, dist=dist)
    sj, st = j_syn.PlaneScene(**kw), t_syn.PlaneScene(**kw)
    p = sj.trajectory(7)[6]
    np.testing.assert_array_equal(st.render(p), sj.render(p))
    mj, mt = j_syn.MultiPlaneScene(), t_syn.MultiPlaneScene()
    for p in mj.trajectory(12)[::5]:
        np.testing.assert_array_equal(mt.render(p), mj.render(p))
        np.testing.assert_array_equal(mt.depth(p), mj.depth(p))


def test_textures_equal():
    np.testing.assert_array_equal(t_syn.make_texture(256, seed=3),
                                  j_syn.make_texture(256, seed=3))
    np.testing.assert_array_equal(
        t_syn.make_periodic_texture(256, period=32, seed=1),
        j_syn.make_periodic_texture(256, period=32, seed=1))


def test_remap_matches_cv2_with_reflected_border():
    """Random subpixel maps, a third of them outside the image (the
    reflected border), against ``cv2.remap`` itself."""
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    mapx = rng.uniform(-60, 110, (64, 80)).astype(np.float32)
    mapy = rng.uniform(-40, 75, (64, 80)).astype(np.float32)
    want = cv2.remap(src, mapx, mapy, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REFLECT)
    np.testing.assert_array_equal(
        t_syn.remap_linear_reflect(src, mapx, mapy), want)


def test_fused_multiply_add_rounds_once():
    """``_fma32`` against exact rational arithmetic, ties included."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, 4000).astype(np.float32)
    b = rng.uniform(-300, 300, 4000).astype(np.float32)
    c = rng.uniform(0, 255, 4000).astype(np.float32)
    # exact ties of float64 rounding: c + a*b with a*b = half an ulp of c
    # plus a tiny tail
    c[:8] = np.float32(100.0)
    a[:8] = np.float32(2.0 ** -18)
    b[:8] = np.float32(1.0 + 2.0 ** -20) * np.float32(2.0 ** -5)
    r = t_syn._fma32(a, b, c)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        cands = [r[i], np.nextafter(r[i], np.float32(np.inf)),
                 np.nextafter(r[i], np.float32(-np.inf))]
        d = [abs(Fraction(float(x)) - exact) for x in cands]
        assert d[0] <= min(d[1:]), (i, a[i], b[i], c[i])


@pytest.fixture(scope="module")
def trajectories():
    rng = np.random.default_rng(2)
    scene = j_syn.PlaneScene(width=64, height=48)
    gt = np.stack(scene.trajectory(40, translation_amp=1.0))
    noise = rng.normal(0, 0.01, (40, 6)).astype(np.float32)
    est = np.stack([
        j_syn._np_se3_inverse(j_syn._np_se3_exp(n)) for n in noise])
    from sdvl_tpu.core import se3 as jse3

    est = np.asarray(jse3.compose(est, gt))
    return est, gt


def test_alignment_metrics_equal(trajectories):
    est, gt = trajectories
    pe_j = j_eval.positions_from_poses(est)
    pe_t = t_eval.positions_from_poses(est)
    np.testing.assert_allclose(pe_t, pe_j, atol=1e-6)
    pg = j_eval.positions_from_poses(gt)
    for ws in (True, False):
        sj, Rj, tj = j_eval.umeyama(pe_j * 2.5, pg, with_scale=ws)
        st, Rt, tt = t_eval.umeyama(pe_j * 2.5, pg, with_scale=ws)
        assert st == sj
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
        assert t_eval.ate_rmse(pe_j * 2.5, pg, ws) == \
            j_eval.ate_rmse(pe_j * 2.5, pg, ws)
    for d in (1, 5):
        assert t_eval.rpe(pe_j, pg, d) == j_eval.rpe(pe_j, pg, d)


def test_rpe_tum_and_rebase_equal(trajectories):
    est, gt = trajectories
    idx = np.delete(np.arange(40), [7, 8, 20])
    for kw in (dict(delta=1), dict(delta=3, scale=1.7),
               dict(delta=1, idx=idx)):
        e, g = (est[idx], gt[idx]) if "idx" in kw else (est, gt)
        rj, rt = j_eval.rpe_tum(e, g, **kw), t_eval.rpe_tum(e, g, **kw)
        assert rj.keys() == rt.keys() and rj["n_pairs"] == rt["n_pairs"]
        for k in ("rpe_trans", "rpe_rot_deg"):
            assert abs(rt[k] - rj[k]) <= 1e-6 * max(1.0, abs(rj[k])), k
    assert t_eval.rpe_tum(est[:2], gt[:2], delta=3) == {}

    frame_ids = np.arange(40)
    kf_ids = np.array([3, 10, 22, -1])
    kf_old = gt[[3, 10, 22, 0]]
    kf_new = est[[3, 10, 22, 0]]
    valid = np.array([True, True, True, False])
    np.testing.assert_allclose(
        t_eval.rebase_trajectory(est, frame_ids, kf_ids, kf_old, kf_new,
                                 valid),
        j_eval.rebase_trajectory(est, frame_ids, kf_ids, kf_old, kf_new,
                                 valid), atol=1e-6)


def test_associate_equal():
    rng = np.random.default_rng(3)
    gt = np.sort(rng.uniform(0, 10, 300))
    est = np.sort(rng.uniform(-0.5, 10.5, 200))
    for a, b in zip(t_eval.associate(est, gt, 0.02),
                    j_eval.associate(est, gt, 0.02)):
        np.testing.assert_array_equal(a, b)
