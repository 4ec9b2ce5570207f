"""The port's ``viz/`` against the JAX package's ``sdvl_tpu.viz``.

Mirrors ``tests/test_viz.py`` and ``tests/test_live_view.py``: the overlay
(NumPy in both, pixels equal), the map and trajectory figures and the
session recorder of the port's host driver and stream (files written), the
PNG writer (decoded by OpenCV to the same array), and the live viewer's
render paths: the orbit camera's projection and the frustum glyph (within
1e-5 of the reference, the same float64 arithmetic on float32 poses), the
follow-mode retarget, and the scene image, which the reference draws with
``cv2.line(..., LINE_AA)`` and the port with its NumPy anti-aliased lines:
the two images are equal where neither draws; every pixel either one draws
lies within 2 px of a pixel the other draws, and all but 0.1 % within 1 px
(cv2's anti-aliased lines cover about 3 pixels across where the port's
cover 2: 8.6 % against 5.7 % of this image); the mean absolute difference
is under 2 grey levels a channel (measured 1.02).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu.core import se3 as jse3
from sdvl_tpu.state.map_state import empty_map as jempty_map
from sdvl_tpu.viz import draw_frame_overlay as jdraw
from sdvl_tpu.viz import live as jlive
from sdvl_tpu_torch.io.snapshot import map_from_numpy
from sdvl_tpu_torch.io.synthetic import PlaneScene
from sdvl_tpu_torch.pipeline.config import CameraConfig, Config, SdvlConfig
from sdvl_tpu_torch.viz import (VizRecorder, draw_frame_overlay, plot_map,
                                plot_trajectory, render_stream_session,
                                save_png)
from sdvl_tpu_torch.viz import live as tlive
from torch_port_helpers import T, tree_to_numpy

torch.set_num_threads(1)


# ---------------------------------------------------------------- overlay
@pytest.mark.parametrize("quality", ["GOOD", "BAD", "INSUFFICIENT"])
def test_overlay_pixels_equal_reference(quality):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    px = np.concatenate([rng.uniform(-5, 165, (40, 1)),
                         rng.uniform(-5, 125, (40, 1))], 1)
    px[3] = [np.nan, 10.0]
    ok = rng.uniform(size=40) < 0.6
    att = rng.uniform(size=40) < 0.8
    px = px.astype(np.float32)
    want = jdraw(img, px, ok, attempted=att, quality=quality)
    got = draw_frame_overlay(img, T(px), T(ok), attempted=T(att),
                             quality=quality)
    assert got.dtype == np.uint8 and got.shape == (120, 160, 3)
    np.testing.assert_array_equal(got, want)


def test_overlay_skips_unattempted():
    img = np.zeros((50, 50), np.float32)
    rgb = draw_frame_overlay(img, np.array([[25.0, 25.0]]), np.array([True]),
                             attempted=np.array([False]))
    assert (rgb == 0).all()


def test_png_writer_decodes_to_the_same_array(tmp_path):
    import cv2

    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (21, 18), dtype=np.uint8)
    save_png(str(tmp_path / "c.png"), rgb)
    save_png(str(tmp_path / "g.png"), gray)
    got = cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got[..., ::-1], rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), gray)
    with pytest.raises(ValueError):
        save_png(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))


# ---------------------------------------------------------- figures, runs
def _cfg_160():
    """``tests/test_multi_stream.py``'s set-up with 10 keyframe slots: the
    host driver's local BA window (10 covisible keyframes, as the
    reference's host driver) needs that many."""
    return Config(
        camera=CameraConfig(width=160, height=128, fx=120.0, fy=120.0,
                            u0=79.5, v0=63.5, dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(cell_size=16, min_avg_shift=3.0, max_keyframes=10,
                        min_keyframe_its=5, min_init_corners=15,
                        min_matches=8, max_points=256, max_candidates=64,
                        map_scale=4.0),
    )


def _scene_160():
    return PlaneScene(fx=120.0, fy=120.0, cx=79.5, cy=63.5, width=160,
                      height=128, plane_z=4.0)


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    """The port's host driver over 12 frames with a recorder every 4."""
    from sdvl_tpu_torch.pipeline.sdvl import SDVL

    out = tmp_path_factory.mktemp("rec")
    scene = _scene_160()
    slam = SDVL(_cfg_160(), seed=0, device="cpu")
    rec = VizRecorder(str(out), every=4)
    poses = scene.trajectory(12, translation_amp=1.2)
    for p in poses:
        img = scene.render(p)
        rec.record(slam, img, slam.handle_frame(img))
    return slam, poses, out


def test_recorder_in_loop(host_run):
    _, _, out = host_run
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("map_")] == [
        "map_000000.png", "map_000004.png", "map_000008.png"]
    assert any(n.startswith("frame_") for n in names), names


def test_recorder_touches_nothing_on_skipped_frames(host_run, tmp_path):
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"skipped frame read {name}")

    rec = VizRecorder(str(tmp_path), every=4)
    rec.record(Untouchable(), None, {"frame_id": 5,
                                     "match_px": Untouchable()})
    assert os.listdir(tmp_path) == []


def test_scene_plots_write_files(host_run, tmp_path):
    slam, poses, _ = host_run
    mp = tmp_path / "map.png"
    plot_map(slam.m, slam.trajectory, path=str(mp))
    assert mp.exists() and mp.stat().st_size > 2000
    tp = tmp_path / "traj.png"
    plot_trajectory([p for _, p in slam.trajectory], gt_poses_wc=poses,
                    path=str(tp))
    assert tp.exists() and tp.stat().st_size > 2000


def test_render_stream_session(tmp_path):
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    scene = _scene_160()
    frames = [scene.render(p)
              for p in scene.trajectory(14, translation_amp=1.2)]
    st = SdvlStream(_cfg_160(), seed=0, device="cpu")
    for f in frames:
        st.feed(f)
    out = str(tmp_path / "viz")
    render_stream_session(st, st.result(), frames, out_dir=out, every=5)
    names = sorted(os.listdir(out))
    assert "trajectory.png" in names and "map_final.png" in names
    assert any(n.startswith("frame_") for n in names)


def test_viz_without_matplotlib_stops_before_the_first_frame(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        VizRecorder(str(tmp_path))
    VizRecorder(str(tmp_path), maps=False)          # overlays only: fine


# ------------------------------------------------------------ live viewer
def _toy_maps():
    """``tests/test_live_view.py``'s toy map, JAX and port."""
    m = jempty_map(n_kf=3, n_pts=64, n_cand=16, img_shape=(64, 96),
                   levels=3)
    rs = np.random.default_rng(0)
    pts = jnp.asarray(rs.uniform([-2, -2, 1], [2, 2, 5],
                                 (64, 3)).astype(np.float32))
    pose1 = jse3.exp(jnp.asarray([0.4, 0, 0, 0, 0.1, 0], jnp.float32))
    m = m._replace(
        pt_pos=pts, pt_valid=jnp.ones(64, bool),
        kf_valid=m.kf_valid.at[:2].set(True),
        kf_pose=m.kf_pose.at[1].set(pose1),
        cand_valid=m.cand_valid.at[:8].set(True),
        cand_bearing=m.cand_bearing.at[:].set(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32)),
        cand_rho=m.cand_rho.at[:].set(0.3),
        cand_sigma2=m.cand_sigma2.at[:].set(0.01),
    )
    return m, map_from_numpy(tree_to_numpy(m), "cpu")


def _trail():
    return [(i, np.asarray(jse3.exp(jnp.asarray(
        [0.1 * i, 0, 0, 0, 0, 0], jnp.float32)))) for i in range(5)]


def test_render_scene_view_agrees_with_reference():
    mj, mt = _toy_maps()
    traj = _trail()
    want = jlive.render_scene_view(mj, traj, jlive.Viewpoint(),
                                   cur_pose=traj[-1][1])
    got = tlive.render_scene_view(mt, traj, tlive.Viewpoint(),
                                  cur_pose=traj[-1][1])
    assert got.shape == want.shape == (480, 640, 3) and got.dtype == np.uint8
    bg = np.full(3, 18, np.uint8)
    drawn_g = (got != bg).any(-1)
    drawn_w = (want != bg).any(-1)
    assert drawn_g.mean() > 0.005
    # where neither draws, both are background; the point cloud is exact
    np.testing.assert_array_equal(got[~drawn_g & ~drawn_w],
                                  want[~drawn_g & ~drawn_w])
    def near(a, b, r):
        """Share of ``a``'s pixels within ``r`` px (Chebyshev) of ``b``."""
        grown = np.zeros_like(b)
        H, W = b.shape
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                grown[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] |= \
                    b[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
        return (a & grown).sum() / a.sum()

    assert near(drawn_g, drawn_w, 2) == near(drawn_w, drawn_g, 2) == 1.0
    assert near(drawn_g, drawn_w, 1) > 0.999
    assert near(drawn_w, drawn_g, 1) > 0.999
    assert np.abs(got.astype(int) - want.astype(int)).mean() < 2.0


def test_viewpoint_projection_matches_reference():
    pts = np.random.default_rng(5).uniform(-3, 3, (50, 3))
    for kw in (dict(), dict(target=(0, 0, 2), dist=5.0, yaw=0.5, pitch=0.2)):
        vj, vt = jlive.Viewpoint(**kw), tlive.Viewpoint(**kw)
        np.testing.assert_allclose(vt.world_to_view(pts),
                                   vj.world_to_view(pts), atol=1e-5)
        pj, fj = jlive.project_view(vj, pts)
        pt, ft = tlive.project_view(vt, pts)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(ft, fj)
    vp = tlive.Viewpoint(target=(0, 0, 2), dist=5.0, yaw=0.0, pitch=0.0)
    px, front = tlive.project_view(vp, np.array([[0.0, 0.0, 2.0]]))
    assert front[0]
    np.testing.assert_allclose(px[0], [320, 240], atol=1)


def test_frustum_and_follow_match_reference():
    pose = np.asarray(jse3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.05, 0.1, 0],
                                           jnp.float32)))
    np.testing.assert_allclose(tlive._frustum_corners(pose),
                               jlive._frustum_corners(pose), atol=1e-5)
    np.testing.assert_allclose(tlive._frustum_corners(T(pose)),
                               jlive._frustum_corners(pose), atol=1e-5)
    mj, mt = _toy_maps()
    vj = jlive.Viewpoint(target=(99.0, 99.0, 99.0))
    vt = tlive.Viewpoint(target=(99.0, 99.0, 99.0))
    jlive.render_scene_view(mj, None, vj, cur_pose=pose)
    tlive.render_scene_view(mt, None, vt, cur_pose=pose)
    np.testing.assert_allclose(vt.target, vj.target, atol=1e-5)


def test_draw_line_blends_in_bounds_only():
    img = np.zeros((20, 30, 3), np.uint8)
    tlive.draw_line(img, (-10, 5), (40, 5), (200, 100, 50))
    assert (img[5] == [200, 100, 50]).all() and (img[:5] == 0).all()
    img = np.zeros((20, 30, 3), np.uint8)
    tlive.draw_line(img, (2, 2), (12, 7), (255, 255, 255))
    lit = (img > 0).any(-1)
    assert lit.sum() >= 11 and lit[2, 2] and lit[7, 12]


def test_liveui_unavailable_headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert tlive.LiveUI.available() is False
