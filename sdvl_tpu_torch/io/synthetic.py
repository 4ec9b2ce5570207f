"""Synthetic rendered sequences with exact ground truth.

The port's own copy of ``sdvl_tpu/io/synthetic.py`` (the port imports
nothing of the JAX package): textured planes rendered through the pinhole
model along a known trajectory. NumPy only. The reference samples its
texture with OpenCV's ``cv2.remap`` (bilinear, reflected border); OpenCV is
not a dependency here, so :func:`remap_linear_reflect` computes the same
numbers: the lerp form ``v0 + ax (v1 - v0)`` of OpenCV 5's bilinear remap,
each step a fused multiply-add rounded once to float32, which makes the
frames bit-identical to the reference's on the same inputs.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (a fused multiply-add).

    ``a * b`` of two float32 is exact in float64; the float64 sum is then
    rounded twice (to float64, then to float32), which is wrong only where
    the float64 sum lands exactly on a float32 tie while its own rounding
    error is not zero: there the error's sign picks the neighbour.
    """
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)          # exact: p + c == s + err
    r = s.astype(np.float32)
    inf = np.float32(np.inf)
    other = np.nextafter(r, np.where(r.astype(np.float64) < s, inf, -inf))
    tie = 2.0 * s == r.astype(np.float64) + other.astype(np.float64)
    hi, lo = np.maximum(r, other), np.minimum(r, other)
    fixed = np.where(err > 0, hi, lo)
    return np.where(tie & (err != 0), fixed, r).astype(np.float32)


def _reflect(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT (fedcba|abcdef|fedcba) for integer indices."""
    p = np.mod(p, 2 * n)
    return np.where(p >= n, 2 * n - 1 - p, p)


def remap_linear_reflect(src: np.ndarray, mapx: np.ndarray,
                         mapy: np.ndarray) -> np.ndarray:
    """Bilinear sampling of float32 ``src`` at float32 maps (x, y) with a
    reflected border: ``cv2.remap(src, mapx, mapy, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT)`` for finite maps."""
    H, W = src.shape
    mapx = np.asarray(mapx, np.float32)
    mapy = np.asarray(mapy, np.float32)
    lim = np.float32(2 ** 30)
    fx = np.floor(np.clip(np.nan_to_num(mapx), -lim, lim))
    fy = np.floor(np.clip(np.nan_to_num(mapy), -lim, lim))
    ax = (mapx - fx).astype(np.float32)
    ay = (mapy - fy).astype(np.float32)
    x0 = fx.astype(np.int64)
    y0 = fy.astype(np.int64)
    xa, xb = _reflect(x0, W), _reflect(x0 + 1, W)
    ya, yb = _reflect(y0, H), _reflect(y0 + 1, H)
    p00, p01 = src[ya, xa], src[ya, xb]
    p10, p11 = src[yb, xa], src[yb, xb]
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    return _fma32(ay, v1 - v0, v0)

def _np_quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from [qw qx qy qz] — host-side twin of
    core.se3.matrix_from_quat (same layout)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _np_se3_exp(xi: np.ndarray) -> np.ndarray:
    """[qw qx qy qz tx ty tz] pose from a twist — host-side twin of
    core.se3.exp (rho first, omega last, same as se3.py)."""
    rho, omega = xi[:3].astype(np.float64), xi[3:].astype(np.float64)
    th = np.linalg.norm(omega)
    if th < 1e-8:
        q = np.array([1.0, *(0.5 * omega)])
        V = np.eye(3)
    else:
        a = omega / th
        q = np.array([np.cos(th / 2), *(np.sin(th / 2) * a)])
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        V = (np.eye(3) + (1 - np.cos(th)) / th * K
             + (th - np.sin(th)) / th * (K @ K))
    t = V @ rho
    return np.concatenate([q / np.linalg.norm(q), t]).astype(np.float32)


def _np_se3_inverse(pose: np.ndarray) -> np.ndarray:
    q = np.asarray(pose[:4], np.float64)
    R = _np_quat_to_matrix(q)
    t = np.asarray(pose[4:], np.float64)
    qinv = q * np.array([1.0, -1, -1, -1])
    return np.concatenate([qinv, -(R.T @ t)]).astype(np.float32)


def make_texture(size: int = 1024, seed: int = 0) -> np.ndarray:
    """Multi-scale random texture with strong corners everywhere."""
    rs = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for scale in (8, 16, 32, 64):
        small = rs.uniform(0, 255, (size // scale, size // scale))
        tex += np.kron(small, np.ones((scale, scale))).astype(np.float32) / 4
    # sprinkle hard blobs for FAST
    for _ in range(400):
        y, x = rs.integers(8, size - 16, 2)
        tex[y : y + rs.integers(4, 12), x : x + rs.integers(4, 12)] += rs.uniform(30, 90)
    return np.clip(tex, 0, 255).astype(np.float32)


def make_periodic_texture(size: int = 1024, period: int = 64,
                          seed: int = 0, n_blobs: int = 6) -> np.ndarray:
    """Exactly repeating texture: one ``period``-pixel tile (smooth base +
    a few hard corner blobs) tiled over the whole plane. The worst case for
    epipolar matching — every corner and every patch has identical twins
    one period away, so a depth-search segment spanning > 1 period in the
    image admits ZMSSD-perfect aliases (the failure mode the reference's
    corner-restricted search, matcher.cc:123-230, is exposed to as well)."""
    rs = np.random.default_rng(seed)
    tile = np.zeros((period, period), np.float32)
    for scale in (8, 16):
        if period % scale:
            continue
        small = rs.uniform(0, 255, (period // scale, period // scale))
        tile += np.kron(small, np.ones((scale, scale))).astype(np.float32) / 2
    for _ in range(n_blobs):
        y, x = rs.integers(4, period - 12, 2)
        tile[y: y + rs.integers(4, 8), x: x + rs.integers(4, 8)] += \
            rs.uniform(40, 90)
    reps = size // period + 1
    return np.clip(np.tile(tile, (reps, reps))[:size, :size],
                   0, 255).astype(np.float32)


class PlaneScene:
    """A textured world plane z = plane_z observed by a moving camera.

    World frame == first camera frame (camera at origin looking +z).
    ``extent`` is the half-size of the textured region in world units.
    """

    def __init__(self, fx=420.0, fy=420.0, cx=319.5, cy=239.5,
                 width=640, height=480, plane_z=4.0, extent=6.0, seed=0,
                 dist=None, texture=None):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.width, self.height = width, height
        self.plane_z = plane_z
        self.extent = extent
        self.dist = None if dist is None else np.asarray(dist, np.float64)
        self.tex = make_texture(seed=seed) if texture is None else texture
        self._rays = None  # pose-independent ray grid, built on first render

    def _undistort_normalized(self, x_d, y_d, iters: int = 8):
        """Invert the radial-tangential model (k1 k2 p1 p2 k3, the
        reference camera.cc layout) by fixed point — so ``render`` can
        produce frames as seen through a DISTORTED lens."""
        k1, k2, p1, p2, k3 = (list(self.dist) + [0.0] * 5)[:5]
        x_u, y_u = x_d.copy(), y_d.copy()
        for _ in range(iters):
            r2 = x_u * x_u + y_u * y_u
            k = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2 * p1 * x_u * y_u + p2 * (r2 + 2 * x_u * x_u)
            dy = p1 * (r2 + 2 * y_u * y_u) + 2 * p2 * x_u * y_u
            x_u = (x_d - dx) / k
            y_u = (y_d - dy) / k
        return x_u, y_u

    def render(self, pose_wc: np.ndarray) -> np.ndarray:
        """Render the view from world->cam pose (7,). Pure NumPy."""
        R = _np_quat_to_matrix(np.asarray(pose_wc[:4], np.float64))
        t = np.asarray(pose_wc[4:], np.float64)
        # cam->world
        Rcw = R.T
        tcw = -R.T @ t

        if self._rays is None:
            # the normalized ray grid depends only on intrinsics: built once
            u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
            xn = (u - self.cx) / self.fx
            yn = (v - self.cy) / self.fy
            if self.dist is not None and np.any(self.dist != 0):
                xn, yn = self._undistort_normalized(xn, yn)
            self._rays = np.stack(
                [xn, yn, np.ones_like(u, np.float64)], axis=-1)
        rays_w = self._rays @ Rcw.T
        # intersect z = plane_z: tcw_z + s * ray_z = plane_z
        denom = rays_w[..., 2]
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        sdist = (self.plane_z - tcw[2]) / denom
        pw = tcw[None, None, :] + sdist[..., None] * rays_w
        size = self.tex.shape[0]
        mapx = ((pw[..., 0] + self.extent) / (2 * self.extent) * (size - 1))
        mapy = ((pw[..., 1] + self.extent) / (2 * self.extent) * (size - 1))
        img = remap_linear_reflect(self.tex, mapx.astype(np.float32),
                                   mapy.astype(np.float32))
        behind = sdist <= 0
        img[behind] = 0.0
        return img

    def trajectory(self, n_frames: int, translation_amp=0.6,
                   rot_amp=0.03, rate=1.0 / 72.0) -> List[np.ndarray]:
        """Smooth sideways-dominant trajectory (good bootstrap parallax).

        Returns world->cam poses (7,) per frame; frame 0 is identity.
        ``rate`` is the phase advanced per frame — per-frame image motion is
        therefore independent of ``n_frames`` (a short clip is a prefix of a
        long one, like a real camera), roughly ``fx*amp*4.7*rate/plane_z``
        px/frame sideways at the default amplitudes.
        """
        poses = []
        for i in range(n_frames):
            ph = i * rate
            xi = np.array([
                translation_amp * np.sin(2 * np.pi * ph * 0.75),
                0.3 * translation_amp * np.sin(2 * np.pi * ph * 1.5),
                0.15 * translation_amp * np.sin(2 * np.pi * ph),
                rot_amp * np.sin(2 * np.pi * ph),
                rot_amp * np.cos(2 * np.pi * ph * 0.5) - rot_amp * 0.5,
                rot_amp * 0.5 * np.sin(2 * np.pi * ph * 0.25),
            ], np.float32)
            # pose maps world->cam: camera moved by exp(xi) => pose = exp(xi)^-1
            poses.append(_np_se3_inverse(_np_se3_exp(xi)))
        return poses

    def sequence(self, n_frames: int, **kw):
        poses = self.trajectory(n_frames, **kw)
        return [(self.render(p), p) for p in poses]


class MultiPlaneScene:
    """A depth-varied world: textured z=const rectangles over a backdrop.

    The non-planar counterpart of :class:`PlaneScene` (VERDICT r1: every
    accuracy gate used the textured plane — the best case for both the
    homography bootstrap and direct alignment). Several front-facing
    rectangles float at different depths in front of a background plane, so
    triangulation, depth-filter convergence at varied depth, and BA on real
    3D structure all get exercised. The dominant background still lets the
    homography bootstrap find a consistent inlier set (foreground points are
    its outliers), like a real indoor scene would.

    ``boxes`` is a list of (z, x0, x1, y0, y1) world-frame rectangles; each
    gets its own texture. Depth per pixel is the nearest hit.
    """

    def __init__(self, fx=210.0, fy=210.0, cx=159.5, cy=119.5,
                 width=320, height=240, backdrop_z=6.0, extent=9.0,
                 boxes=None, seed=0, tex_size=512, backdrop_size=1024):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.width, self.height = width, height
        self.backdrop_z = backdrop_z
        self.extent = extent
        if boxes is None:
            boxes = [
                (2.8, -2.2, -0.4, -1.6, 0.4),
                (4.0, 0.3, 2.4, -0.8, 1.2),
                (3.3, -0.9, 0.9, 0.8, 2.2),
                (4.8, -2.6, -0.8, 1.0, 2.6),
            ]
        self.boxes = [tuple(float(v) for v in b) for b in boxes]
        # tex_size/backdrop_size scale texture detail to the render
        # resolution (512/1024 match 320x240; full-res 640x480 head-to-
        # heads pass 1024/2048 so texture detail matches pixel density)
        self.textures = [make_texture(tex_size, seed=seed + 1 + i)
                         for i in range(len(self.boxes))]
        self.backdrop = make_texture(backdrop_size, seed=seed)

    def render(self, pose_wc: np.ndarray) -> np.ndarray:
        R = _np_quat_to_matrix(np.asarray(pose_wc[:4], np.float64))
        t = np.asarray(pose_wc[4:], np.float64)
        Rcw, tcw = R.T, -R.T @ t

        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        rays = np.stack([(u - self.cx) / self.fx, (v - self.cy) / self.fy,
                         np.ones_like(u, np.float64)], axis=-1)
        rays_w = rays @ Rcw.T

        denom = rays_w[..., 2]
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)

        best_s = (self.backdrop_z - tcw[2]) / denom
        best_s = np.where(best_s > 0, best_s, np.inf)
        img = self._sample_plane(self.backdrop, tcw, rays_w, best_s,
                                 self.extent)

        for (z, x0, x1, y0, y1), tex in zip(self.boxes, self.textures):
            s = (z - tcw[2]) / denom
            pw = tcw[None, None, :] + s[..., None] * rays_w
            hit = ((s > 0) & (s < best_s)
                   & (pw[..., 0] >= x0) & (pw[..., 0] <= x1)
                   & (pw[..., 1] >= y0) & (pw[..., 1] <= y1))
            size = tex.shape[0]
            mapx = (pw[..., 0] - x0) / max(x1 - x0, 1e-9) * (size - 1)
            mapy = (pw[..., 1] - y0) / max(y1 - y0, 1e-9) * (size - 1)
            box_img = remap_linear_reflect(tex, mapx.astype(np.float32),
                                           mapy.astype(np.float32))
            img = np.where(hit, box_img, img)
            best_s = np.where(hit, s, best_s)
        return img.astype(np.float32)

    def _sample_plane(self, tex, tcw, rays_w, s, extent):
        pw = tcw[None, None, :] + s[..., None] * rays_w
        size = tex.shape[0]
        mapx = (pw[..., 0] + extent) / (2 * extent) * (size - 1)
        mapy = (pw[..., 1] + extent) / (2 * extent) * (size - 1)
        out = remap_linear_reflect(tex, mapx.astype(np.float32),
                                   mapy.astype(np.float32))
        return np.where(np.isfinite(s), out, 0.0)

    def depth(self, pose_wc: np.ndarray) -> np.ndarray:
        """Ground-truth z-depth map (camera frame) — for depth-filter tests."""
        R = _np_quat_to_matrix(np.asarray(pose_wc[:4], np.float64))
        t = np.asarray(pose_wc[4:], np.float64)
        Rcw, tcw = R.T, -R.T @ t
        u, v = np.meshgrid(np.arange(self.width), np.arange(self.height))
        rays = np.stack([(u - self.cx) / self.fx, (v - self.cy) / self.fy,
                         np.ones_like(u, np.float64)], axis=-1)
        rays_w = rays @ Rcw.T
        denom = np.where(np.abs(rays_w[..., 2]) < 1e-9, 1e-9, rays_w[..., 2])
        best_s = (self.backdrop_z - tcw[2]) / denom
        best_s = np.where(best_s > 0, best_s, np.inf)
        for (z, x0, x1, y0, y1) in self.boxes:
            s = (z - tcw[2]) / denom
            pw = tcw[None, None, :] + s[..., None] * rays_w
            hit = ((s > 0) & (s < best_s)
                   & (pw[..., 0] >= x0) & (pw[..., 0] <= x1)
                   & (pw[..., 1] >= y0) & (pw[..., 1] <= y1))
            best_s = np.where(hit, s, best_s)
        # s is distance along the ray whose z-component is rays_cam z=1
        # rotated; camera-frame depth = s * (ray_cam z) = s (unit-z rays)
        return best_s.astype(np.float32)

    def trajectory(self, n_frames: int, **kw):
        return PlaneScene.trajectory(self, n_frames, **kw)
