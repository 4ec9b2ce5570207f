"""The port's Zurich-capacity smoke against the JAX tool's, below its scale.

``tools/zurich_scale_smoke.py:59-168`` composed from ``sdvl_tpu`` functions
(``tests/make_torch_fixtures.py``: ``jax_zurich_fill``, ``jax_zurich_draws``,
``jax_zurich_ba``) and the port's ``sdvl_tpu_torch.tools.zurich_scale_smoke``
on the same views: 256 keyframe slots (above ``CG_KF_THRESHOLD`` = 200, so
both global BAs take the PCG route), 220 of them filled, 512 plane points,
128x160 frames (5 pyramid levels need a multiple of 16), the focal lengths
and principal point scaled with the width, the tool's stage iterations
(4, 6).

Tolerances, each against the JAX run:

* ``fill_map``: the keyframe views' float32 bytes equal; every map field
  equal, ``obs_px`` within 1e-4 px; the pyramid store bit for bit against
  the JAX package's pyramid evaluated op by op (``jax.vmap`` without
  ``jit``), and against the JAX tool's jitted ``fill`` everywhere but where
  the reference's two evaluations themselves round apart (XLA's fused
  float32 blur ends a few pyramid values 1 ulp off, and a value on a .5
  boundary, 147.5 against 147.49998, then rounds to the next integer: 1
  pixel in these 220 views);
* ``perturb`` fed the JAX draws: poses and points within 1e-6;
* the reprojection error before BA within 1e-5 relative;
* after global BA (float32 PCG in both, in different summation orders),
  held against the JAX tool's jitted run and beside the reference's own
  spread, its global BA evaluated op by op (``jax.disable_jit``):
  ``reproj_px_after`` within 1e-5 px (all three 0.0020555: measured 1.6e-8
  from the jitted run, the reference's two 4.7e-8 apart), the filled
  slots' camera centres within 1e-4 (measured 9.5e-7; the reference's two
  3.0e-5 apart), the points within 5e-4 (1.0e-5; 1.2e-4), the gated
  ``obs_mask`` equal (as the reference's two). The CG iterations of each LM
  step end where float32's recursive residual crosses 1e-12 of its start,
  a step that rounding moves: the reference's two evaluations part by up
  to 16 iterations in a step (sums 581 and 558), so each of the port's
  counts must lie within that largest spread of the nearer of the two
  (measured: at most 12 from it, sum 507). Both runs meet the tool's ``e1 <
  0.35 * e0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_torch_fixtures import (jax_zurich_ba, jax_zurich_draws,
                                 jax_zurich_fill)
from sdvl_tpu.ops import pyramid
from sdvl_tpu.state.map_state import store_pyramid
from sdvl_tpu_torch.tools import zurich_scale_smoke as tz
from torch_port_helpers import N, tree_to_numpy

torch.set_num_threads(1)

KF_CAP, KF, PTS, H, W = 256, 220, 512, 128, 160


@pytest.fixture(scope="module")
def run():
    intr_j, _, mj, kf_poses_j, imgs_j = jax_zurich_fill(KF_CAP, KF, PTS, H, W,
                                                        5)
    intr, scene, _ = tz.zurich_config(H, W, KF_CAP, PTS)
    kf_poses, imgs = tz.keyframe_views(scene, KF)
    mt = tz.fill_map(intr, torch.from_numpy(kf_poses),
                     torch.from_numpy(tz.plane_points(PTS)),
                     torch.from_numpy(imgs), kf_cap=KF_CAP)
    pose_noise, pt_noise = jax_zurich_draws(KF_CAP, PTS)
    noisy_j, ba_j, e0_j, e1_j, cg_j = jax_zurich_ba(intr_j, mj, (4, 6))
    with jax.disable_jit():
        _, ba_e, _, e1_e, cg_e = jax_zurich_ba(intr_j, mj, (4, 6))
    ba_t = tz.run_global_ba(mt, intr, torch.from_numpy(pose_noise),
                            torch.from_numpy(pt_noise), (4, 6))
    return dict(mj=tree_to_numpy(mj), mt=mt, imgs=imgs, imgs_j=imgs_j,
                kf_poses=kf_poses, kf_poses_j=kf_poses_j,
                noisy_j=tree_to_numpy(noisy_j), ba_j=tree_to_numpy(ba_j),
                e0_j=e0_j, e1_j=e1_j, cg_j=cg_j, ba_t=ba_t,
                ba_e=tree_to_numpy(ba_e), e1_e=e1_e, cg_e=cg_e)


def test_views_and_trajectory_equal_the_jax_tools(run):
    np.testing.assert_array_equal(run["kf_poses"], run["kf_poses_j"])
    np.testing.assert_array_equal(run["imgs"], run["imgs_j"])
    assert run["imgs"].dtype == np.float32
    assert tz.images_sha256(run["imgs"]) == tz.images_sha256(run["imgs_j"])


FIELDS = ("kf_pose", "kf_valid", "kf_frame_id", "n_keyframes", "pt_pos",
          "pt_valid", "pt_anchor_kf", "pt_found", "obs_mask", "obs_level",
          "pt_fail", "pt_desc", "cand_valid", "n_evicted", "n_pruned")


@pytest.mark.parametrize("name", FIELDS + ("obs_px", "kf_pyr"))
def test_fill_map_equals_the_jax_fill(run, name):
    got, want = getattr(run["mt"], name), run["mj"][name]
    if name == "kf_pyr":
        assert len(got) == len(want) == 5
        eager = jax.vmap(lambda im: tuple(store_pyramid(
            pyramid.build_pyramid(im, 5))))(jnp.asarray(run["imgs"]))
        for g, w, e in zip(got, want, eager):
            assert g.dtype == torch.uint8
            g, e = N(g), np.asarray(e)
            np.testing.assert_array_equal(g[:KF], e)
            np.testing.assert_array_equal(g[KF:], w[KF:])
            apart = g[:KF] != w[:KF]
            np.testing.assert_array_equal(apart, e != w[:KF])
            assert apart.sum() <= 4
    elif name == "obs_px":
        np.testing.assert_allclose(N(got), want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(N(got), np.asarray(want))
    assert int(run["mt"].obs_mask.sum()) > 10 * KF


def test_perturb_fed_the_jax_draws_equals_the_jax_tools(run):
    noisy = run["ba_t"]["noisy"]
    for name in ("kf_pose", "pt_pos"):
        np.testing.assert_allclose(N(getattr(noisy, name)),
                                   run["noisy_j"][name], rtol=0, atol=1e-6)


def test_reprojection_error_before_equals_the_jax_tools(run):
    e0, e0_j = run["ba_t"]["e0"], run["e0_j"]
    assert e0 > 1.0
    assert abs(e0 - e0_j) <= 1e-5 * e0_j, (e0, e0_j)


def test_global_ba_over_220_filled_slots_equals_the_jax_tools(run):
    ba = run["ba_t"]
    e0, e1, e1_j = ba["e0"], ba["e1"], run["e1_j"]
    assert e1 < 0.35 * e0 and e1_j < 0.35 * run["e0_j"]
    assert abs(e1 - e1_j) < 1e-5, (e1, e1_j)
    assert abs(run["e1_e"] - e1_j) < 1e-5
    m, want = ba["map"], run["ba_j"]

    def centres(poses):
        return N(tz.camera_centres(torch.as_tensor(np.array(poses[:KF]))))

    np.testing.assert_allclose(centres(m.kf_pose), centres(want["kf_pose"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(m.pt_pos), want["pt_pos"], rtol=0,
                               atol=5e-4)
    np.testing.assert_array_equal(N(m.obs_mask), want["obs_mask"])
    np.testing.assert_array_equal(run["ba_e"]["obs_mask"], want["obs_mask"])
    cg, cg_j, cg_e = (np.asarray(run[k] if k else ba["cg_iterations"])
                      for k in (None, "cg_j", "cg_e"))
    print("CG iterations per LM step: port", cg.tolist(), "JAX jitted",
          cg_j.tolist(), "JAX op by op", cg_e.tolist())
    assert len(cg) == len(cg_j) == len(cg_e) == 10
    spread = np.abs(cg_j - cg_e).max()
    nearer = np.minimum(np.abs(cg - cg_j), np.abs(cg - cg_e))
    assert nearer.max() <= spread, (cg, cg_j, cg_e)
    # the gauge: slots 0 and 1 and every empty slot stay where they were
    before = N(ba["noisy"].kf_pose)
    np.testing.assert_array_equal(N(m.kf_pose[:2]), before[:2])
    np.testing.assert_array_equal(N(m.kf_pose[KF:]), before[KF:])


def test_state_bytes_count_both_layouts(run):
    own, jax_layout = tz.state_bytes(run["mt"])
    leaves = [np.asarray(v) for k, v in run["mj"].items()
              if not isinstance(v, tuple)]
    leaves += list(run["mj"]["kf_pyr"])
    assert jax_layout == sum(a.nbytes for a in leaves)
    # int64 index fields and ORB words: 4 more bytes per element
    n64 = sum(t.numel() for t in run["mt"] if isinstance(t, torch.Tensor)
              and t.dtype == torch.int64)
    assert own - jax_layout == 4 * n64 > 0
