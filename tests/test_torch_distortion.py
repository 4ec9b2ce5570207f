"""Full SLAM mode through a distorted lens: the port's stream against the
JAX stream on frames rendered through TUM-fr1-like radial-tangential
distortion, undistorted per frame by the step's remap (the case of
``tests/test_stream_fsm.py::test_distorted_lens_end_to_end``; every shipped
preset in ``configs/`` has lens distortion).

Same config, same frames, the port fed the JAX stream's random draws.
Tolerances as in ``tests/test_torch_slam.py``: per-frame states, keyframe
flags and ``n_corners`` equal, ``n_matches`` within 2, trajectories within
1e-3; and both within 3 % of the extent of the ground truth (ATE).
"""

import numpy as np
import pytest
import torch

from sdvl_tpu.io.synthetic import PlaneScene
from sdvl_tpu.pipeline import config as jcfg
from sdvl_tpu_torch.core import camera as tcam
from sdvl_tpu_torch.io import evaluate
from sdvl_tpu_torch.pipeline import config as tcfg
from sdvl_tpu_torch.pipeline.device_fsm import undistort_grid
from torch_port_helpers import N, slam_pair

torch.set_num_threads(1)

DIST = (-0.28, 0.07, 0.0002, -0.0001, 0.0)


@pytest.fixture(scope="module")
def pair():
    scene = PlaneScene(fx=210.0, fy=210.0, cx=159.5, cy=119.5, width=320,
                       height=240, plane_z=4.0, dist=DIST)
    cam = dict(width=320, height=240, fx=210.0, fy=210.0, u0=159.5,
               v0=119.5, dist=DIST)
    sdvl = dict(cell_size=32, min_avg_shift=5.0, max_keyframes=10,
                min_keyframe_its=5, min_init_corners=30, max_points=512,
                max_candidates=256, min_matches=15, map_scale=4.0)
    cfg_j = jcfg.Config(camera=jcfg.CameraConfig(**cam),
                        sdvl=jcfg.SdvlConfig(**sdvl))
    cfg_t = tcfg.Config(camera=tcfg.CameraConfig(**cam),
                        sdvl=tcfg.SdvlConfig(**sdvl))
    poses = scene.trajectory(30)
    frames = [scene.render(p) for p in poses]
    js, rj, ts, rt = slam_pair(cfg_j, cfg_t, frames)
    return cfg_j, cfg_t, poses, js, rj, ts, rt


def test_undistort_grid_matches_reference(pair):
    from sdvl_tpu.core import camera as jcam

    cfg_j, cfg_t, _, _, _, ts, _ = pair
    want = np.asarray(jcam.undistort_map(jcfg.intrinsics(cfg_j)))
    got = N(undistort_grid(cfg_t, "cpu"))
    np.testing.assert_allclose(got, want[:240, :320], atol=1e-4)
    assert tcam.has_distortion(tcfg.intrinsics(cfg_t))
    assert ts._grid is not None


def test_distorted_stream_matches_reference(pair):
    _, _, poses, _, rj, _, rt = pair
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.is_keyframe, rj.is_keyframe)
    np.testing.assert_array_equal(rt.n_corners, rj.n_corners)
    assert np.abs(rt.n_matches - rj.n_matches).max() <= 2
    np.testing.assert_allclose(rt.trajectory, rj.trajectory, atol=1e-3)
    assert rt.state_name() == "RUNNING"
    start = int(np.argmax(rt.states == 2))
    p_gt = evaluate.positions_from_poses(np.stack(poses[start:]))
    extent = float(np.linalg.norm(np.ptp(p_gt, axis=0)))
    for r in (rt, rj):
        ate = evaluate.ate_rmse(
            evaluate.positions_from_poses(r.trajectory[start:]), p_gt,
            with_scale=True)
        assert ate < 0.03 * extent, (ate, extent)
