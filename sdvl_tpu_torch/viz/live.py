"""Live interactive viewer -- the reference's UI thread.

Counterpart of ``sdvl_tpu/viz/live.py``. The reference runs a UI thread at
10 Hz (reference main.cc:38-87) with two views: ``DrawImage`` (features
colored by status, tint on tracking degradation, ui/drawimage.cc:53-94) and
``DrawScene`` (a 3D view with camera frusta, trail, point cloud and
depth-uncertainty segments and a follow-camera toggle,
ui/drawscene.cc:30-128). Every render path here is a pure array->array
function: world geometry is perspective-projected and drawn with NumPy
anti-aliased lines (:func:`draw_line`, in place of ``cv2.line(...,
LINE_AA)``), so the scene view renders without OpenCV.

Only the windows need OpenCV and a display: :class:`LiveUI` imports cv2
when it opens them, and ``LiveUI.available()`` says whether it can (the
CLI then runs headless with a warning, as the reference's does). The
tracker thread only snapshots state (``update``, rate-limited: device
tensors are copied at most at the UI rate); a separate thread owns all
windowing. Keys: f follow camera, space pause, q quit.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .overlay import draw_frame_overlay, host
from .scene import _cam_centers, candidate_segments

_GRAY = (90, 90, 90)
_BLUE = (255, 160, 40)     # BGR: keyframe frusta
_GREEN = (60, 200, 60)     # trail
_ORANGE = (40, 160, 255)   # uncertainty segments
_WHITE = (235, 235, 235)
# the map fields render_scene_view reads
_SCENE_FIELDS = ("pt_pos", "pt_valid", "kf_pose", "kf_valid", "cand_valid",
                 "cand_rho", "cand_sigma2", "cand_bearing", "cand_kf")


def _quat_to_R(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / max(np.linalg.norm(q), 1e-12)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


class Viewpoint:
    """Orbit camera for the scene view: yaw/pitch around a target point.

    The stand-in for the reference's interactive view matrix
    (drawscene.cc:30-60 s_cam); mouse drag adjusts yaw/pitch, wheel zooms,
    follow mode re-targets to the live camera like the reference's
    follow-camera toggle.
    """

    def __init__(self, target=(0.0, 0.0, 2.0), dist=8.0,
                 yaw=0.3, pitch=-0.9):
        self.target = np.asarray(target, np.float64)
        self.dist = float(dist)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.follow = True

    def world_to_view(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) world -> view-camera coordinates (z forward)."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        R = Rx @ Ry
        eye = self.target - R.T @ np.array([0.0, 0.0, self.dist])
        return (np.asarray(pts, np.float64) - eye) @ R.T


def project_view(vp: Viewpoint, pts: np.ndarray, size=(640, 480),
                 f: float = 500.0):
    """Perspective-project world points for the scene window.

    Returns ``(px (N, 2) int32, in_front (N,) bool)``.
    """
    W, H = size
    v = vp.world_to_view(pts.reshape(-1, 3))
    z = np.maximum(v[:, 2], 1e-6)
    px = np.stack([f * v[:, 0] / z + W / 2, f * v[:, 1] / z + H / 2], -1)
    return px.astype(np.int32), v[:, 2] > 1e-3


def _frustum_corners(pose_wc: np.ndarray, scale: float = 0.25) -> np.ndarray:
    """(5, 3) world positions: camera centre + 4 image-plane corners
    (the frustum glyph drawscene.cc draws per keyframe)."""
    from ..core import se3

    inv = se3.inverse(torch.from_numpy(
        np.array(host(pose_wc), np.float32))).numpy()
    c = inv[4:]
    R = _quat_to_R(inv[:4])
    w, h, d = 0.8 * scale, 0.5 * scale, 1.0 * scale
    local = np.array([[0, 0, 0], [-w, -h, d], [w, -h, d],
                      [w, h, d], [-w, h, d]])
    return c[None, :] + local @ R.T


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """Anti-aliased line from pixel ``p0`` to ``p1`` blended into ``img``
    (H, W, 3) uint8, in place (Wu's algorithm: along the major axis, each
    step covers the two pixels around the exact minor coordinate, weighted
    by distance; ``thickness`` > 1 draws parallel lines one pixel apart).
    Pixels outside the image are dropped."""
    H, W = img.shape[:2]
    (x0, y0), (x1, y1) = np.asarray(p0, np.float64), np.asarray(p1,
                                                                np.float64)
    dx, dy = x1 - x0, y1 - y0
    steep = abs(dy) > abs(dx)
    n = int(max(abs(dx), abs(dy))) + 1
    if n > 4 * (H + W):        # clip absurd lengths (points near the eye)
        n = 4 * (H + W)
    t = np.linspace(0.0, 1.0, n)
    major = (y0 + t * dy) if steep else (x0 + t * dx)
    minor = (x0 + t * dx) if steep else (y0 + t * dy)
    major = np.round(major).astype(np.int64)
    col = np.asarray(color, np.float64)
    for k in range(thickness):
        m = minor + (k - (thickness - 1) / 2.0)
        base = np.floor(m)
        frac = m - base
        for off, wgt in ((0, 1.0 - frac), (1, frac)):
            mi = base.astype(np.int64) + off
            ys, xs = (major, mi) if steep else (mi, major)
            keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W) & (wgt > 0)
            ys, xs, w = ys[keep], xs[keep], wgt[keep][:, None]
            px = img[ys, xs].astype(np.float64)
            img[ys, xs] = np.round(px * (1.0 - w) + col * w).astype(np.uint8)


def render_scene_view(m, trajectory=None, vp: Viewpoint | None = None,
                      size=(640, 480), cur_pose=None,
                      max_segments: int = 200) -> np.ndarray:
    """Software-rendered 3D scene window; returns (H, W, 3) uint8 BGR.

    Draws what the reference's 3D view draws (drawscene.cc:62-128): the
    point cloud, keyframe frusta, the trajectory trail, the CURRENT camera
    frustum, and rho +- 2 sigma depth-uncertainty segments for unconverged
    candidates (fed in the reference from sdvl.cc:291-321). ``m`` may live on
    any device.
    """
    W, H = size
    img = np.full((H, W, 3), 18, np.uint8)
    vp = vp or Viewpoint()

    if vp.follow and cur_pose is not None:
        vp.target = _cam_centers(host(cur_pose)[None])[0].astype(np.float64)

    def line(a, b, color, thickness=1):
        px, front = project_view(vp, np.stack([a, b]), size)
        if front.all():
            draw_line(img, px[0], px[1], color, thickness)

    # point cloud
    pts = host(m.pt_pos)[host(m.pt_valid)]
    if len(pts):
        px, front = project_view(vp, pts, size)
        keep = front & (px[:, 0] >= 0) & (px[:, 0] < W) \
            & (px[:, 1] >= 0) & (px[:, 1] < H)
        img[px[keep, 1], px[keep, 0]] = _WHITE

    # candidate uncertainty segments (world-frame rho +- 2 sigma interval)
    for a, b in zip(*candidate_segments(m, max_segments)):
        line(a, b, _ORANGE)

    # keyframe frusta
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for pose in host(m.kf_pose)[host(m.kf_valid)]:
        fr = _frustum_corners(pose)
        for a, b in edges:
            line(fr[a], fr[b], _BLUE)

    # trail + current camera
    if trajectory is not None and len(trajectory):
        tr = np.stack([p for _, p in trajectory]) \
            if isinstance(trajectory[0], tuple) else np.stack(trajectory)
        c = _cam_centers(tr)
        for a, b in zip(c[:-1], c[1:]):
            line(a, b, _GREEN)
    if cur_pose is not None:
        fr = _frustum_corners(host(cur_pose), scale=0.35)
        for a, b in edges:
            line(fr[a], fr[b], (60, 60, 230), 2)

    # ground grid (z=0 plane, the reference aligns its map to it)
    for i in range(-5, 6):
        line(np.array([i, 0.0, -5.0]), np.array([i, 0.0, 5.0]), _GRAY)
        line(np.array([-5.0, 0.0, i]), np.array([5.0, 0.0, i]), _GRAY)
    return img


class LiveUI:
    """Interactive two-window viewer on its own thread (reference UI::Display
    loop at 10 Hz, main.cc:49-55). ``update`` is called by the tracker with
    the latest state; this thread renders and handles input. Needs OpenCV's
    GUI and a display (:meth:`available`)."""

    IMAGE_WIN = "SDVL tracking"
    SCENE_WIN = "SDVL map"

    @staticmethod
    def available() -> bool:
        if not (os.environ.get("DISPLAY")
                or os.environ.get("WAYLAND_DISPLAY")):
            return False
        try:
            import cv2
        except ImportError:
            return False
        return hasattr(cv2, "imshow")

    def __init__(self, rate_hz: float = 10.0):
        self.rate = rate_hz
        self.vp = Viewpoint()
        self.quit_requested = False
        self.paused = False
        self._latest = None  # raw snapshot tuple, rendered on the UI thread
        self._last_snap_t = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._drag = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="sdvl-ui")
        self.thread.start()

    # ------------------------------------------------------- tracker side
    def update(self, slam, img, info) -> None:
        """Snapshot the latest state (reference UI::Update, ui/ui.cc:49-85).

        Rate-limited to the UI rate: between UI ticks this returns without
        touching anything, so the tracker loop pays the device->host copies
        at most ``rate_hz`` times a second -- never per frame. All DRAWING
        happens on the UI thread from the raw snapshot.
        """
        now = time.perf_counter()
        if now - self._last_snap_t < 1.0 / self.rate:
            return
        self._last_snap_t = now
        match = None
        if info.get("match_px") is not None:
            match = (host(info["match_px"]), host(info["match_ok"]),
                     host(info["match_attempted"]))
        # the map is written in place: copy what the scene view draws (on
        # the CPU host() is a view of it)
        m = slam.m
        m = m._replace(**{f: host(getattr(m, f)).copy()
                          for f in _SCENE_FIELDS})
        snap = (np.asarray(img), match, info.get("quality", "GOOD"),
                m, list(slam.trajectory), info.get("pose"))
        with self._lock:
            self._latest = snap

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=5.0)

    # ------------------------------------------------------------ UI side
    def _on_mouse(self, event, x, y, flags, _param):
        import cv2

        if event == cv2.EVENT_LBUTTONDOWN:
            self._drag = (x, y)
        elif event == cv2.EVENT_LBUTTONUP:
            self._drag = None
        elif event == cv2.EVENT_MOUSEMOVE and self._drag is not None:
            dx, dy = x - self._drag[0], y - self._drag[1]
            self._drag = (x, y)
            self.vp.yaw += dx * 0.01
            self.vp.pitch = float(np.clip(self.vp.pitch + dy * 0.01,
                                          -1.5, 1.5))
        elif event == cv2.EVENT_MOUSEWHEEL:
            self.vp.dist = float(np.clip(
                self.vp.dist * (0.9 if flags > 0 else 1.1), 0.5, 100.0))

    def _run(self):
        import cv2

        windows = False
        while not self._stop.is_set():
            t0 = time.perf_counter()
            with self._lock:
                snap = self._latest
            if snap is not None and not self.paused:
                img, match, quality, m, trajectory, pose = snap
                if match is not None:
                    overlay = draw_frame_overlay(
                        img, match[0], match[1], match[2], quality=quality
                    )
                else:
                    g = np.clip(np.asarray(img, np.float32), 0, 255)
                    overlay = np.repeat(g[..., None], 3, -1).astype(np.uint8)
                scene = render_scene_view(m, trajectory, self.vp,
                                          cur_pose=pose)
                if not windows:
                    cv2.namedWindow(self.IMAGE_WIN, cv2.WINDOW_AUTOSIZE)
                    cv2.namedWindow(self.SCENE_WIN, cv2.WINDOW_AUTOSIZE)
                    cv2.setMouseCallback(self.SCENE_WIN, self._on_mouse)
                    windows = True
                cv2.imshow(self.IMAGE_WIN, overlay[..., ::-1])  # RGB->BGR
                cv2.imshow(self.SCENE_WIN, scene)
            key = cv2.waitKey(1) & 0xFF if windows else 0xFF
            if key == ord("q"):
                self.quit_requested = True
            elif key == ord("f"):
                self.vp.follow = not self.vp.follow
            elif key == ord(" "):
                self.paused = not self.paused
            dt = 1.0 / self.rate - (time.perf_counter() - t0)
            if dt > 0:
                self._stop.wait(dt)
        if windows:
            cv2.destroyAllWindows()
