"""Bootstrap slice, module by module: the port against ``sdvl_tpu``.

The new ``se3``, ``camera`` and ``geometry`` functions, ``patch.grid_search``,
the homography solver and ``bootstrap.init_two_view``, the plane fit and the
ground-plane alignment, on the same seeded numpy inputs (and the same Gumbel
noise: the port is handed the numbers the JAX code draws from its key).

Tolerances, stated per test: closed-form float32 functions agree to 1e-5
relative; eigen- and singular-vector results are compared only where they do
not depend on sign (H up to scale, the *chosen* decomposition, the plane up to
orientation); integer outputs (inlier masks, argmins) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.core import camera as jcam
from sdvl_tpu.core import geometry as jgeo
from sdvl_tpu.core import se3 as jse3
from sdvl_tpu.ops import fast as jfast
from sdvl_tpu.ops import interp as jinterp
from sdvl_tpu.ops import patch as jpatch
from sdvl_tpu.ops import pyramid as jpyr
from sdvl_tpu.pipeline import bootstrap as jboot
from sdvl_tpu.pipeline import mapper as jmapper
from sdvl_tpu.pipeline.config import intrinsics as j_intrinsics
from sdvl_tpu.solvers import homography as jhom
from sdvl_tpu_torch.core import camera as tcam
from sdvl_tpu_torch.core import geometry as tgeo
from sdvl_tpu_torch.core import se3 as tse3
from sdvl_tpu_torch.io.snapshot import map_from_numpy
from sdvl_tpu_torch.ops import patch as tpatch
from sdvl_tpu_torch.pipeline import bootstrap as tboot
from sdvl_tpu_torch.pipeline import mapper as tmapper
from sdvl_tpu_torch.pipeline.config import intrinsics as t_intrinsics
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from sdvl_tpu_torch.solvers import homography as thom
from torch_port_helpers import (N, T, homography_gumbel, plane_gumbel,
                                small_scene, smooth_image, tree_to_numpy)

torch.set_num_threads(1)

RTOL = 1e-5


def _poses(rng, n, t_scale=1.0):
    xi = rng.normal(0, 0.4, (n, 6)).astype(np.float32)
    xi[:, :3] *= t_scale
    return np.asarray(jax.vmap(jse3.exp)(jnp.asarray(xi)))


def _close(got, want, atol=1e-6, rtol=RTOL):
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------------ core

def test_se3_from_rt_quat_from_matrix_relative():
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    R = np.asarray(jse3.rotation(jnp.asarray(a)))
    # rotations near each Shepperd branch: trace > 0 and the three others
    flips = np.stack([np.diag(d) for d in
                      ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    R = np.concatenate([R, np.einsum("kij,njl->knil", flips, R[:8])
                        .reshape(-1, 3, 3)]).astype(np.float32)
    t = rng.normal(0, 1, (len(R), 3)).astype(np.float32)
    _close(tse3.quat_from_matrix(T(R)), jse3.quat_from_matrix(jnp.asarray(R)))
    _close(tse3.from_rt(T(R), T(t)), jse3.from_rt(jnp.asarray(R),
                                                  jnp.asarray(t)))
    _close(tse3.relative(T(a), T(b)),
           jse3.relative(jnp.asarray(a), jnp.asarray(b)), atol=1e-5)


def test_pixel_error_angle_equal():
    for fx in (210.0, 517.3, 1000.0):
        ij = jcam.Intrinsics.create(fx, fx, 0.0, 0.0)
        it = tcam.Intrinsics.create(fx, fx, 0.0, 0.0)
        assert np.float32(tcam.pixel_error_angle(it)) == \
            np.asarray(jcam.pixel_error_angle(ij))


def test_triangulation_and_parallax():
    rng = np.random.default_rng(1)
    n = 200
    rel = _poses(rng, n, t_scale=0.5)
    b_ref = rng.normal(0, 1, (n, 3)).astype(np.float32)
    b_ref[:, 2] = np.abs(b_ref[:, 2]) + 1.0
    b_ref /= np.linalg.norm(b_ref, axis=1, keepdims=True)
    b_cur = rng.normal(0, 1, (n, 3)).astype(np.float32)
    b_cur[:, 2] = np.abs(b_cur[:, 2]) + 1.0
    b_cur /= np.linalg.norm(b_cur, axis=1, keepdims=True)
    args_j = [jnp.asarray(x) for x in (rel, b_ref, b_cur)]
    args_t = [T(x) for x in (rel, b_ref, b_cur)]
    _close(tgeo.triangulate_midpoint(*args_t),
           jgeo.triangulate_midpoint(*args_j), atol=1e-4, rtol=1e-4)
    _close(tgeo.depth_from_triangulation(*args_t),
           jgeo.depth_from_triangulation(*args_j), atol=1e-4, rtol=1e-4)

    pa, pb = _poses(rng, n, 0.3), _poses(rng, n, 0.3)
    uva = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    uvb = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    _close(tgeo.triangulate_dlt(T(pa), T(pb), T(uva), T(uvb)),
           jgeo.triangulate_dlt(*(jnp.asarray(x) for x in
                                  (pa, pb, uva, uvb))),
           atol=1e-4, rtol=1e-4)

    pw = rng.normal(0, 2, (n, 3)).astype(np.float32)
    ca, cb = rng.normal(0, 1, (2, n, 3)).astype(np.float32)
    _close(tgeo.parallax_cosine(T(pw), T(ca), T(cb)),
           jgeo.parallax_cosine(jnp.asarray(pw), jnp.asarray(ca),
                                jnp.asarray(cb)))

    q = rel[:, :4]
    p_cam = rng.normal(0, 1, (n, 3)).astype(np.float32)
    p_cam[:, 2] += 4.0
    _close(tgeo.jacobian_point(T(q), T(p_cam)),
           jgeo.jacobian_point(jnp.asarray(q), jnp.asarray(p_cam)))


def test_sampson_error():
    rng = np.random.default_rng(2)
    E = rng.normal(0, 1, (8, 1, 3, 3)).astype(np.float32)
    uva = rng.uniform(-0.5, 0.5, (1, 50, 2)).astype(np.float32)
    uvb = rng.uniform(-0.5, 0.5, (1, 50, 2)).astype(np.float32)
    _close(tgeo.sampson_error_unit_plane(T(E), T(uva), T(uvb)),
           jgeo.sampson_error_unit_plane(jnp.asarray(E), jnp.asarray(uva),
                                         jnp.asarray(uvb)), atol=1e-6)


@pytest.mark.parametrize("v", [[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0],
                               [0.6, -0.8, 0.0], [0.03, -0.01, -0.9995]])
def test_rotation_between_edge_cases(v):
    """Mirrors ``tests/test_ground_plane.py``: parallel, antiparallel and
    generic directions onto +z; port equal to the reference to 1e-5."""
    a = np.asarray(v, np.float32)
    a = a / np.linalg.norm(a)
    e3 = np.asarray([0.0, 0.0, 1.0], np.float32)
    R = N(tgeo.rotation_between(T(a), T(e3)))
    np.testing.assert_allclose(R @ a, [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(
        R, np.asarray(jgeo.rotation_between(jnp.asarray(a),
                                            jnp.asarray(e3))), atol=1e-5)


def test_fit_plane_ransac_recovers_plane():
    """Mirrors ``tests/test_ground_plane.py`` (plane n.p = 0.5 plus 60
    outliers), with the JAX draws: inliers equal, plane equal up to
    orientation to 1e-5."""
    rng = np.random.default_rng(0)
    n = np.asarray([0.0, 1.0, 1.0]) / np.sqrt(2)
    pts_on = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    pts_on = pts_on - (pts_on @ n)[:, None] * n
    pts_on = pts_on + n * 0.5
    outliers = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
    pts = np.concatenate([pts_on, outliers]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[-5:] = False
    key = jax.random.PRNGKey(3)
    (nj, dj), ij = jgeo.fit_plane_ransac(
        jnp.asarray(pts), jnp.asarray(valid), jax.random.fold_in(key, 1),
        thresh=0.05)
    (nt, dt), it = tgeo.fit_plane_ransac(
        T(pts), T(valid), T(plane_gumbel(key, len(pts))), thresh=0.05)
    np.testing.assert_array_equal(N(it), np.asarray(ij))
    assert abs(float(np.dot(N(nt), n))) > 0.999
    assert abs(abs(float(dt)) - 0.5) < 0.02
    assert int(it.sum()) >= 280
    sign = np.sign(float(np.dot(N(nt), np.asarray(nj))))
    np.testing.assert_allclose(sign * N(nt), np.asarray(nj), atol=1e-5)
    np.testing.assert_allclose(sign * float(dt), float(dj), atol=1e-5)


# ----------------------------------------------------------------- patch

def test_grid_search_equal():
    img = smooth_image(4, (96, 128))
    rng = np.random.default_rng(4)
    xy = rng.uniform(24, 100, (40, 2)).astype(np.float32)
    xy[:, 1] = np.clip(xy[:, 1], 24, 70)
    shift = rng.uniform(-5, 5, (40, 2)).astype(np.float32)
    ref = np.asarray(jinterp.extract_patches(jnp.asarray(img),
                                             jnp.asarray(xy + shift), 4))
    bj, sj = jpatch.grid_search(jnp.asarray(img), jnp.asarray(ref),
                                jnp.asarray(xy), 8)
    bt, st = tpatch.grid_search(T(img), T(ref), T(xy), 8)
    np.testing.assert_array_equal(N(bt), np.asarray(bj))
    _close(st, sj, atol=1e-2, rtol=1e-5)
    # integer shifts are found exactly
    ok = np.all(np.abs(shift - np.round(shift)) < 0.05, axis=1)
    np.testing.assert_allclose(N(bt)[ok], (xy + np.round(shift))[ok],
                               atol=1e-5)
    _close(tpatch.zmssd(T(ref[:, None]), T(ref[None, :5])),
           jpatch.zmssd(jnp.asarray(ref[:, None]), jnp.asarray(ref[None, :5])),
           atol=1e-2)


# ------------------------------------------------------------ homography

def _plane_correspondences(rng, n=120, noise=0.0):
    """Unit-plane correspondences of points on a plane seen from two
    cameras, 20 % of them corrupted."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    np.full(n, 4.0)], -1).astype(np.float32)
    pose2 = np.asarray(jse3.exp(jnp.asarray(
        [0.3, -0.05, 0.02, 0.01, -0.03, 0.02], jnp.float32)))
    p2 = np.asarray(jse3.transform(jnp.asarray(pose2)[None],
                                   jnp.asarray(pts)))
    uva = (pts[:, :2] / pts[:, 2:]).astype(np.float32)
    uvb = (p2[:, :2] / p2[:, 2:]).astype(np.float32)
    uvb = uvb + rng.normal(0, noise, uvb.shape).astype(np.float32)
    bad = rng.random(n) < 0.2
    uvb[bad] += rng.uniform(-0.1, 0.1, (int(bad.sum()), 2)).astype(np.float32)
    return uva, uvb, bad, pose2


def test_dlt_and_transfer_error():
    rng = np.random.default_rng(5)
    uva, uvb, bad, _ = _plane_correspondences(rng)
    w = (~bad).astype(np.float32)
    Hj = np.asarray(jhom.dlt_homography(jnp.asarray(uva), jnp.asarray(uvb),
                                        jnp.asarray(w)))
    Ht = N(thom.dlt_homography(T(uva), T(uvb), T(w)))
    np.testing.assert_allclose(Ht, Hj, atol=2e-4)     # normalised: H[2,2]=1
    _close(thom.transfer_error(T(Hj), T(uva), T(uvb)),
           jhom.transfer_error(jnp.asarray(Hj), jnp.asarray(uva),
                               jnp.asarray(uvb)), atol=1e-6)


def test_ransac_homography_with_jax_noise():
    rng = np.random.default_rng(6)
    uva, uvb, bad, _ = _plane_correspondences(rng, noise=1e-4)
    valid = np.ones(len(uva), bool)
    valid[:4] = False
    key = jax.random.PRNGKey(7)
    Hj, ij = jhom.ransac_homography(jnp.asarray(uva), jnp.asarray(uvb),
                                    jnp.asarray(valid),
                                    jax.random.fold_in(key, 0),
                                    thresh=2.0 / 210.0)
    Ht, it = thom.ransac_homography(T(uva), T(uvb), T(valid),
                                    T(homography_gumbel(key, len(uva))),
                                    thresh=2.0 / 210.0)
    np.testing.assert_array_equal(N(it), np.asarray(ij))
    assert not N(it)[bad & valid].any() or N(it)[bad].mean() < 0.2
    np.testing.assert_allclose(N(Ht), np.asarray(Hj), atol=2e-4)


def test_decomposition_chooses_the_same_pose():
    """Only the chosen pose is compared: the 8 candidates' order depends on
    the SVD's signs."""
    rng = np.random.default_rng(8)
    uva, uvb, bad, pose2 = _plane_correspondences(rng)
    w = (~bad).astype(np.float32)
    H = np.asarray(jhom.dlt_homography(jnp.asarray(uva), jnp.asarray(uvb),
                                       jnp.asarray(w)))
    pj, vj = jhom.choose_decomposition(jhom.decompose_homography(
        jnp.asarray(H)), jnp.asarray(uva), jnp.asarray(uvb), jnp.asarray(w))
    dec_t = thom.decompose_homography(T(H))
    assert dec_t.R.shape == (8, 3, 3) and dec_t.d.shape == (8,)
    pt, vt = thom.choose_decomposition(dec_t, T(uva), T(uvb), T(w))
    assert float(vt) == float(vj)
    np.testing.assert_allclose(N(pt), np.asarray(pj), atol=1e-4)
    # and it is the true motion (translation direction, unit norm)
    t_true = pose2[4:] / np.linalg.norm(pose2[4:])
    np.testing.assert_allclose(N(pt)[4:], t_true, atol=1e-2)


@pytest.fixture(scope="module")
def two_frames():
    cfg_j, cfg_t, frames, _ = small_scene(7)
    pj1 = tuple(jpyr.build_pyramid(jnp.asarray(frames[0]), 5))
    pj2 = tuple(jpyr.build_pyramid(jnp.asarray(frames[6]), 5))
    s = cfg_j.sdvl
    c = jfast.detect_pyramid(pj1, levels=s.max_fast_levels,
                             cell=s.cell_size, fast_threshold=10.0,
                             st_threshold=50.0, max_features=s.num_features)
    return cfg_j, cfg_t, pj1, pj2, c


def test_pyramidal_flow_equal(two_frames):
    _, _, pj1, pj2, c = two_frames
    xj, okj = jboot.pyramidal_flow(pj1, pj2, c.xy, c.valid)
    xt, okt = tboot.pyramidal_flow(tuple(T(p) for p in pj1),
                                   tuple(T(p) for p in pj2), T(c.xy),
                                   T(c.valid))
    np.testing.assert_array_equal(N(okt), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() >= 30
    np.testing.assert_allclose(N(xt)[ok], np.asarray(xj)[ok], atol=1e-3)


def test_init_two_view_equal(two_frames):
    """The second-frame initialization on two rendered frames with the JAX
    draws: flow survivors, inliers and their count equal; pose within
    1e-4; inlier points within 1e-3 of the map scale (4.0)."""
    cfg_j, cfg_t, pj1, pj2, c = two_frames
    key = jax.random.PRNGKey(0)
    kw = dict(map_scale=4.0, min_corners=30)
    bj = jboot.init_two_view(j_intrinsics(cfg_j), pj1, pj2, c.xy, c.valid,
                             jax.random.fold_in(key, 0), **kw)
    bt = tboot.init_two_view(t_intrinsics(cfg_t), tuple(T(p) for p in pj1),
                             tuple(T(p) for p in pj2), T(c.xy), T(c.valid),
                             T(homography_gumbel(key, c.xy.shape[0])), **kw)
    assert bool(bt.ok_flow) == bool(bj.ok_flow) is True
    assert int(bt.n_inliers) == int(bj.n_inliers) > 30
    np.testing.assert_array_equal(N(bt.inlier), np.asarray(bj.inlier))
    assert abs(float(bt.median_shift) - float(bj.median_shift)) < 1e-3
    np.testing.assert_allclose(N(bt.pose2), np.asarray(bj.pose2), atol=1e-4)
    inl = np.asarray(bj.inlier)
    np.testing.assert_allclose(N(bt.pts_w)[inl], np.asarray(bj.pts_w)[inl],
                               atol=4e-3)


# ---------------------------------------------------------- ground plane

def test_transform_initial_map_equal(two_frames):
    """The ground-plane alignment on a map whose points lie on a tilted
    plane: same plane inliers, points moved to z ~ 0, cameras above it,
    port equal to the reference to 1e-4."""
    from sdvl_tpu.pipeline.device_fsm import init_state

    cfg_j = two_frames[0]
    rng = np.random.default_rng(9)
    m, _ = init_state(cfg_j)
    P = m.pt_valid.shape[0]
    n_pts = 150
    xy = rng.uniform(-2, 2, (n_pts, 2))
    z = 4.0 + 0.2 * xy[:, 0] - 0.1 * xy[:, 1] + rng.normal(0, 0.01, n_pts)
    pts = np.zeros((P, 3), np.float32)
    pts[:n_pts] = np.stack([xy[:, 0], xy[:, 1], z], -1)
    pts[n_pts - 10:n_pts] += rng.uniform(-1, 1, (10, 3))   # off-plane
    valid = np.zeros(P, bool)
    valid[:n_pts] = True
    kf_pose = np.asarray(m.kf_pose).copy()
    kf_pose[1] = _poses(rng, 1, 0.1)[0]
    m = m._replace(pt_pos=jnp.asarray(pts), pt_valid=jnp.asarray(valid),
                   kf_pose=jnp.asarray(kf_pose))
    key = jax.random.PRNGKey(11)
    mj, Tj = jmapper.transform_initial_map(m, jax.random.fold_in(key, 1))
    mt, Tt = tmapper.transform_initial_map(
        map_from_numpy(tree_to_numpy(m), "cpu"), T(plane_gumbel(key, P)))
    np.testing.assert_allclose(N(Tt), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(N(mt.pt_pos), np.asarray(mj.pt_pos),
                               atol=1e-4)
    np.testing.assert_allclose(N(mt.kf_pose), np.asarray(mj.kf_pose),
                               atol=1e-4)
    on = N(mt.pt_pos)[: n_pts - 10]
    assert np.abs(np.median(on[:, 2])) < 0.05
    centers = N(tse3.translation(tse3.inverse(mt.kf_pose[:2])))
    assert (centers[:, 2] > 1.0).all()


def test_bootstrap_aligns_world_to_plane():
    """Mirrors ``tests/test_ground_plane.py``: the port's stream bootstraps
    on the plane scene and puts the plane at z ~ 0 with the cameras above
    it (default generator draws)."""
    _, cfg_t, frames, _ = small_scene(8)
    st = TStream(cfg_t, seed=0, device="cpu")
    for f in frames:
        st.feed(f)
        if int(st.carry.state) == 2:
            break
    assert int(st.carry.state) == 2
    pts = N(st.m.pt_pos)[N(st.m.pt_valid)]
    assert abs(np.median(pts[:, 2])) < 0.15, np.median(pts[:, 2])
    assert np.percentile(np.abs(pts[:, 2]), 80) < 0.5
    centers = N(tse3.translation(tse3.inverse(st.m.kf_pose)))
    assert (centers[N(st.m.kf_valid)][:, 2] > 1.0).all()
