"""The slice as a whole: the port's ``SdvlStream`` in full SLAM mode against
the JAX stream.

Both streams start from an empty map over the same rendered 320x240
``PlaneScene`` frames (FIRST -> SECOND bootstrap -> RUNNING with keyframes,
local BA and depth filters), and the port is fed the random draws the JAX
stream derives from its key (pose RANSAC per frame, the homography and
ground-plane RANSACs of the bootstrap). Run with both detection routes
(``torch_port_helpers.detect_route``), ``use_pallas_detect`` set alike on
both configs: the reference's plain route (the shipped configs' default)
against the port's own plain border rule, and the Pallas kernel in
interpret mode against the port's Pallas border rule -- the port's route on
the CPU tensor being the kernel's plain version in either mode.

Tolerances: per-frame states, keyframe flags and ``n_corners`` equal;
``n_matches`` within +-2 (a match on a threshold may flip under different
float32 rounding); trajectories (after the ground-plane rebasing) within
1e-3. The residue is float32 rounding in the bootstrap's eigen- and
singular-value solves, carried through the ground-plane rotation, which is
ill-conditioned near 180 degrees (the camera looks down at the plane).
"""

import numpy as np
import pytest
import torch

from sdvl_tpu_torch.ops.cuda import detect as t_detect
from sdvl_tpu_torch.pipeline.stream import Draws
from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream
from torch_port_helpers import slam_pair, small_scene

torch.set_num_threads(1)

N_FRAMES = 30


@pytest.fixture(scope="module")
def scene():
    return small_scene(N_FRAMES)


@pytest.fixture(scope="module")
def runs(scene):
    """Per detection route, the JAX and port runs over the frames (made
    once per module)."""
    cfg_j, cfg_t, frames, poses_gt = scene
    out = {}

    def get(fused: bool):
        if fused not in out:
            launches = t_detect.launches()
            out[fused] = slam_pair(
                cfg_j, cfg_t, frames, route="pallas" if fused else "plain"
            ) + (t_detect.launches() - launches,)
        return out[fused]

    return get


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_full_slam_stream_matches_jax(runs, scene, fused):
    js, rj, ts, rt, launches = runs(fused)
    cfg_j = scene[0]
    n = rj.n_frames
    assert rt.n_frames == n == N_FRAMES
    # the JAX stream itself bootstrapped, tracked and made keyframes
    assert rj.state_name() == "RUNNING"
    running = rj.states == 2
    assert running.sum() >= 20
    assert rj.is_keyframe.sum() >= 2
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.is_keyframe, rj.is_keyframe)
    np.testing.assert_array_equal(rt.n_corners, rj.n_corners)
    np.testing.assert_array_equal(rt.quality, rj.quality)
    assert np.abs(rt.n_matches - rj.n_matches).max() <= 2
    assert np.abs(rt.n_attempts - rj.n_attempts).max() <= 2
    # the bootstrap re-based the world once (ground-plane alignment)
    boot = int(np.argmax(rj.is_keyframe))
    assert rj.states[boot] == 2 and rj.states[boot - 1] == 1
    np.testing.assert_allclose(rt.trajectory, rj.trajectory, atol=1e-3)
    np.testing.assert_allclose(rt.poses_raw, rj.poses_raw, atol=1e-3)
    np.testing.assert_allclose(rt.median_shift, rj.median_shift, atol=1e-3)
    # the maps agree
    assert int(ts.m.n_keyframes) == int(js.m.n_keyframes)
    np.testing.assert_array_equal(ts.m.kf_valid.numpy(),
                                  np.asarray(js.m.kf_valid))
    np.testing.assert_array_equal(ts.m.kf_frame_id.numpy(),
                                  np.asarray(js.m.kf_frame_id))
    assert abs(int(ts.m.pt_valid.sum())
               - int(np.asarray(js.m.pt_valid).sum())) <= 4
    # on the CPU the wrapper takes the plain version: no kernel launch
    assert launches == 0
    assert int(ts.carry.frame_id) == N_FRAMES
    assert cfg_j.sdvl.localize_only is False


def test_chunked_feeding_equals_per_frame(runs, scene):
    """Chunks (one host->device copy each) and single frames mixed give
    the per-frame run's results exactly (the same ops on the CPU)."""
    _, cfg_t, frames, _ = scene
    js, _, _, rt, _ = runs(True)        # the Pallas border rule
    from torch_port_helpers import jax_draws, with_route

    st = TStream(with_route(cfg_t, "pallas"), seed=0, device="cpu",
                 gumbel_provider=jax_draws(cfg_t, js.carry.key))
    stack = np.stack(frames)
    st.feed_chunk(stack[:10])
    st.feed_chunk(stack[10:20])
    for f in frames[20:]:
        st.feed(f)
    r2 = st.result()
    np.testing.assert_array_equal(r2.states, rt.states)
    np.testing.assert_array_equal(r2.is_keyframe, rt.is_keyframe)
    np.testing.assert_array_equal(r2.n_matches, rt.n_matches)
    np.testing.assert_array_equal(r2.trajectory, rt.trajectory)


def test_textureless_frames_stay_first(scene):
    _, cfg_t, _, _ = scene
    st = TStream(cfg_t, seed=0, device="cpu")
    flat = np.full((240, 320), 128.0, np.float32)
    for _ in range(4):
        st.feed(flat)
    r = st.result()
    assert (r.states == 0).all()
    assert (r.n_corners < cfg_t.sdvl.min_init_corners).all()
    assert not r.is_keyframe.any()


def test_default_generator_reproducible_and_bootstraps(scene):
    """Without a provider the stream draws every noise tensor from its own
    ``torch.Generator``: same seed, same run; and it still bootstraps and
    tracks."""
    _, cfg_t, frames, _ = scene
    results = []
    for _ in range(2):
        st = TStream(cfg_t, seed=5, device="cpu")
        st.feed_chunk(np.stack(frames[:12]))
        results.append(st.result())
    a, b = results
    np.testing.assert_array_equal(a.states, b.states)
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    assert a.state_name() == "RUNNING"
    running = a.states == 2
    assert running.sum() >= 6
    assert (a.n_matches[running] >= cfg_t.sdvl.min_matches).all()


def test_missing_pose_noise_raises(scene):
    """A provider with no pose noise for a tracking frame is refused, not
    replaced by a draw of the stream's own."""
    _, cfg_t, frames, _ = scene
    boot = TStream(cfg_t, seed=0, device="cpu")._boot
    draws = Draws(pose=lambda i: None, homography=boot.homography.numpy(),
                  plane=boot.plane.numpy())
    st = TStream(cfg_t, seed=0, device="cpu", gumbel_provider=draws)
    with pytest.raises(ValueError, match="no pose-RANSAC noise"):
        for f in frames[:8]:
            st.feed(f)
    assert int(st.carry.state) == 2   # it had bootstrapped


def test_cuda_default_without_a_card_raises(scene):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        TStream(scene[1])
