"""What the benchmark generates from ``--seed``: textures, trajectories,
frames and the filled map's geometry, in plain torch and numpy.

A textured plane ``z = plane_z`` seen through a camera (pinhole, or the
radial-tangential lens ``d1..d5`` of a ``configs/*.cfg``), as the port's
``io/synthetic.PlaneScene`` renders it; frames are rendered on the device in
batches (``torch.nn.functional.grid_sample``), not bit for bit as the numpy
renderer does. Poses are world->camera ``[qw qx qy qz tx ty tz]``.

Every random number comes from a generator seeded from ``(seed, tag)``
(:func:`seeded`), so the same seed gives the same inputs, and a seed changes
only phases and textures, never the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch


def seed_int(seed: int, *tag: int) -> int:
    """A 63-bit integer derived from ``(seed, *tag)``; any whole numbers,
    negative or beyond 64 bits included."""
    words = []
    for v in (int(seed), *map(int, tag)):
        a, chunks = abs(v), []
        while True:
            chunks.append(a & 0xFFFFFFFF)
            a >>= 32
            if not a:
                break
        words += [int(v < 0), len(chunks), *chunks]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def seeded(seed: int, *tag: int, device="cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(seed, *tag))
    return gen


def rng(seed: int, *tag: int) -> np.random.Generator:
    return np.random.default_rng(seed_int(seed, *tag))


# ----------------------------------------------------------- SE(3), numpy
def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(..., 4) [qw qx qy qz] -> (..., 3, 3), float64."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation -> (..., 4) [qw qx qy qz] with qw >= 0."""
    R = np.asarray(R, np.float64)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cands = np.stack([
        np.stack([1 + tr, R[..., 2, 1] - R[..., 1, 2],
                  R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
                 -1),
        np.stack([R[..., 2, 1] - R[..., 1, 2],
                  1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2],
                  R[..., 0, 1] + R[..., 1, 0], R[..., 0, 2] + R[..., 2, 0]],
                 -1),
        np.stack([R[..., 0, 2] - R[..., 2, 0], R[..., 0, 1] + R[..., 1, 0],
                  1 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2],
                  R[..., 1, 2] + R[..., 2, 1]], -1),
        np.stack([R[..., 1, 0] - R[..., 0, 1], R[..., 0, 2] + R[..., 2, 0],
                  R[..., 1, 2] + R[..., 2, 1],
                  1 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2]], -1),
    ], -2)                                                   # (..., 4, 4)
    norms = np.linalg.norm(cands, axis=-1)
    best = np.take_along_axis(cands, norms.argmax(-1)[..., None, None],
                              -2)[..., 0, :]
    q = best / np.linalg.norm(best, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(..., 6) twists (rho first, omega last) -> (..., 7) poses, float64."""
    xi = np.asarray(xi, np.float64)
    rho, om = xi[..., :3], xi[..., 3:]
    th = np.linalg.norm(om, axis=-1)[..., None]
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = om / ths
    K = np.zeros(xi.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -a[..., 2], a[..., 1]
    K[..., 1, 0], K[..., 1, 2] = a[..., 2], -a[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -a[..., 1], a[..., 0]
    eye = np.eye(3)
    c1 = ((1 - np.cos(ths)) / ths)[..., None]
    c2 = ((ths - np.sin(ths)) / ths)[..., None]
    V = eye + c1 * K + c2 * (K @ K)
    V = np.where(small[..., None], eye, V)
    q = np.concatenate([np.cos(ths / 2), np.sin(ths / 2) * a], -1)
    q = np.where(small, np.concatenate([np.ones_like(th), 0.5 * om], -1), q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([q, (V @ rho[..., None])[..., 0]], -1)


def se3_inverse(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float64)
    R = quat_to_matrix(p[..., :4])
    qi = p[..., :4] * np.array([1.0, -1, -1, -1])
    t = -(np.swapaxes(R, -1, -2) @ p[..., 4:, None])[..., 0]
    return np.concatenate([qi, t], -1)


def se3_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a o b: p -> a(b(p))."""
    Ra, Rb = quat_to_matrix(a[..., :4]), quat_to_matrix(b[..., :4])
    t = (Ra @ np.asarray(b, np.float64)[..., 4:, None])[..., 0] + a[..., 4:]
    return np.concatenate([matrix_to_quat(Ra @ Rb), t], -1)


def centres(poses: np.ndarray) -> np.ndarray:
    """Camera centres in the world of (..., 7) world->camera poses."""
    return se3_inverse(poses)[..., 4:]


# ------------------------------------------------------------ trajectories
def sweep(n: int, span: float, legs: int, y_amp: float, yaw_amp: float,
          period: float, z_amp: float, phases, ramp: int = 0) -> np.ndarray:
    """A multi-leg travelling sweep, the port's ``tools/long_run.
    long_trajectory`` with each oscillation started at a phase of
    ``phases`` (three, in turns): x runs over [-span/2, span/2] ``legs``
    times with a cosine profile (at rest at the ends), y, yaw, pitch and
    roll oscillate with ``period`` frames, their amplitudes growing from 0
    over the first ``ramp`` frames. (n, 7) world->camera poses."""
    i = np.arange(n, dtype=np.float64)
    t = i / max(n - 1, 1)
    ph = i / period
    p0, p1, p2 = (2 * np.pi * p for p in phases)
    x = span * (0.5 * (1.0 - np.cos(np.pi * legs * t)) - 0.5)
    grow = np.clip(i / ramp, 0.0, 1.0) if ramp else np.ones_like(i)
    xi = np.stack([
        x,
        grow * y_amp * np.sin(2 * np.pi * ph + p0),
        grow * z_amp * np.sin(2 * np.pi * t + p1),
        grow * yaw_amp * np.sin(2 * np.pi * ph + p0),
        grow * yaw_amp * (np.cos(2 * np.pi * ph * 0.25 + p1) - np.cos(p1)),
        grow * 0.5 * yaw_amp * np.sin(2 * np.pi * ph * 0.33 + p2),
    ], -1)
    return se3_inverse(se3_exp(xi))


def orbit(phase: np.ndarray, translation_amp: float, rot_amp: float = 0.03
          ) -> np.ndarray:
    """``PlaneScene.trajectory``'s poses at (fractional) phases ``phase``
    (its frame i is phase i / 72); periodic in the phase with period 4."""
    ph = np.asarray(phase, np.float64)
    a, r = translation_amp, rot_amp
    xi = np.stack([
        a * np.sin(2 * np.pi * ph * 0.75),
        0.3 * a * np.sin(2 * np.pi * ph * 1.5),
        0.15 * a * np.sin(2 * np.pi * ph),
        r * np.sin(2 * np.pi * ph),
        r * np.cos(2 * np.pi * ph * 0.5) - r * 0.5,
        r * 0.5 * np.sin(2 * np.pi * ph * 0.25),
    ], -1)
    return se3_inverse(se3_exp(xi))


# ---------------------------------------------------------------- textures
def texture(size: int, gen: torch.Generator, device) -> torch.Tensor:
    """``io/synthetic.make_texture``'s recipe on the device: four octaves of
    blocky noise and hard blobs (as many per area as its 400 on 1024^2),
    clipped to [0, 255]; (size, size) float32."""
    tex = torch.zeros((size, size), dtype=torch.float32, device=device)
    for scale in (8, 16, 32, 64):
        n = size // scale
        small = torch.rand((n, n), generator=gen, device=device) * 255
        tex += small.repeat_interleave(scale, 0).repeat_interleave(
            scale, 1) / 4
    n_blobs = 400 * (size // 1024) ** 2 if size >= 1024 else 400
    yx = torch.randint(8, size - 16, (n_blobs, 2), generator=gen,
                       device=device)
    hw = torch.randint(4, 12, (n_blobs, 2), generator=gen, device=device)
    amp = torch.rand(n_blobs, generator=gen, device=device) * 60 + 30
    # each blob a rectangle added through a summed-area stencil
    stamp = torch.zeros((size + 1, size + 1), dtype=torch.float32,
                        device=device)
    y0, x0 = yx[:, 0], yx[:, 1]
    y1, x1 = y0 + hw[:, 0], x0 + hw[:, 1]
    for ys, xs, sgn in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                        (y1, x1, 1)):
        stamp.index_put_((ys, xs), sgn * amp, accumulate=True)
    tex += stamp.cumsum(0).cumsum(1)[:size, :size]
    return tex.clamp(0, 255)


# ------------------------------------------------------------------ camera
class Camera:
    """Intrinsics, size and lens ``(k1, k2, p1, p2, k3)`` of a frame."""

    def __init__(self, fx, fy, cx, cy, width, height, dist=(0,) * 5):
        self.fx, self.fy, self.cx, self.cy = map(float, (fx, fy, cx, cy))
        self.width, self.height = int(width), int(height)
        self.dist = tuple(float(d) for d in dist)

    @classmethod
    def from_cfg(cls, cfg: dict) -> "Camera":
        return cls(cfg["Camera.fx"], cfg["Camera.fy"], cfg["Camera.u0"],
                   cfg["Camera.v0"], cfg["Camera.width"],
                   cfg["Camera.height"],
                   [cfg.get(f"Camera.d{i}", 0.0) for i in range(1, 6)])

    def pinhole(self) -> "Camera":
        """The same intrinsics and size without the lens."""
        return Camera(self.fx, self.fy, self.cx, self.cy, self.width,
                      self.height)

    def rays(self, device) -> torch.Tensor:
        """Each pixel's ray (x, y, 1) in the camera, the lens undone by
        ``PlaneScene``'s fixed point; (H, W, 3) float64."""
        v, u = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float64, device=device),
            torch.arange(self.width, dtype=torch.float64, device=device),
            indexing="ij")
        xd, yd = (u - self.cx) / self.fx, (v - self.cy) / self.fy
        xu, yu = xd.clone(), yd.clone()
        k1, k2, p1, p2, k3 = self.dist
        if any(self.dist):
            for _ in range(8):
                r2 = xu * xu + yu * yu
                k = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
                dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
                xu, yu = (xd - dx) / k, (yd - dy) / k
        return torch.stack([xu, yu, torch.ones_like(xu)], -1)


class Plane:
    """A textured plane ``z = z`` over [-extent, extent]^2 in x and y."""

    def __init__(self, tex: torch.Tensor, extent: float, z: float):
        self.tex, self.extent, self.z = tex, float(extent), float(z)

    def render(self, poses: np.ndarray, rays: torch.Tensor,
               batch: int = 32) -> torch.Tensor:
        """(n, H, W) uint8 views from (n, 7) world->camera poses, on the
        device of ``rays``: clipped to [0, 255] and truncated, as the
        numpy renderer's frames are cast."""
        dev = rays.device
        H, W = rays.shape[:2]
        out = torch.empty((len(poses), H, W), dtype=torch.uint8, device=dev)
        tex = self.tex[None, None]
        flat = rays.reshape(-1, 3)
        for s in range(0, len(poses), batch):
            p = torch.as_tensor(np.asarray(poses[s:s + batch]),
                                dtype=torch.float64, device=dev)
            R = torch.as_tensor(quat_to_matrix(p[:, :4].cpu().numpy()),
                                device=dev)
            tcw = -(R.transpose(1, 2) @ p[:, 4:, None])[..., 0]   # centres
            rw = flat[None] @ R                       # rays in the world
            sd = (self.z - tcw[:, None, 2]) / torch.where(
                rw[..., 2].abs() < 1e-9, torch.full_like(rw[..., 2], 1e-9),
                rw[..., 2])
            pw = tcw[:, None, :2] + sd[..., None] * rw[..., :2]
            grid = (pw / self.extent).float().reshape(-1, H, W, 2)
            img = torch.nn.functional.grid_sample(
                tex.expand(len(p), 1, -1, -1), grid, mode="bilinear",
                padding_mode="reflection", align_corners=True)[:, 0]
            img = torch.where((sd > 0).reshape(-1, H, W), img, 0.0)
            out[s:s + len(p)] = img.clamp(0, 255).to(torch.uint8)
        return out

    def grid_points(self, n: int = 12) -> np.ndarray:
        """An n x n grid of points on the plane (world), float64: what the
        reference projects to turn a pose error into pixels."""
        g = np.linspace(-self.extent, self.extent, n)
        x, y = np.meshgrid(g, g)
        return np.stack([x.ravel(), y.ravel(), np.full(n * n, self.z)], -1)


def project(poses: np.ndarray, pts: np.ndarray) -> tuple:
    """(n, 7) poses, (m, 3) world points -> normalized image points (n, m, 2)
    and depths (n, m), float64."""
    R = quat_to_matrix(poses[:, :4])
    pc = np.einsum("nij,mj->nmi", R, pts) + poses[:, None, 4:]
    z = pc[..., 2]
    return pc[..., :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[..., None], z
