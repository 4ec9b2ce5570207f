"""Pinhole camera model with radial-tangential distortion, batched.

Counterpart of ``sdvl_tpu/core/camera.py``. Intrinsics are plain Python
numbers (rounded to float32 once, so that every product with a float32 tensor
uses the value the reference uses); they carry no device and can be shared by
streams on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    """Static camera parameters."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, ...]  # k1, k2, p1, p2, k3 (OpenCV order)
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, dist=None, width=640, height=480) -> "Intrinsics":
        if dist is None:
            dist = (0.0,) * 5
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return Intrinsics(
            fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
            dist=tuple(f32(d) for d in dist),
            width=int(width), height=int(height),
        )


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def project(intr: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points ``(..., 3)`` -> pixel coords ``(..., 2)``
    (x, y) of the undistorted image. Points behind the camera give garbage
    coordinates; callers mask on ``z > 0``."""
    safe_z = _safe_z(pts_cam[..., 2])
    u = intr.fx * pts_cam[..., 0] / safe_z + intr.cx
    v = intr.fy * pts_cam[..., 1] / safe_z + intr.cy
    return torch.stack([u, v], dim=-1)


def unproject(intr: Intrinsics, px: torch.Tensor) -> torch.Tensor:
    """Pixels ``(..., 2)`` -> unit bearing vectors ``(..., 3)``."""
    x = (px[..., 0] - intr.cx) / intr.fx
    y = (px[..., 1] - intr.cy) / intr.fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return ray / torch.sqrt(torch.sum(ray * ray, dim=-1, keepdim=True))


def project_unit_plane(pts_cam: torch.Tensor) -> torch.Tensor:
    """3D point -> unit-plane (normalized) coords ``(..., 2)``."""
    safe_z = _safe_z(pts_cam[..., 2])
    return pts_cam[..., :2] / safe_z[..., None]


def unit_plane_to_pixel(intr: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Unit-plane coords ``(..., 2)`` -> pixels (no distortion)."""
    u = intr.fx * uv[..., 0] + intr.cx
    v = intr.fy * uv[..., 1] + intr.cy
    return torch.stack([u, v], dim=-1)


def pixel_error_angle(intr: Intrinsics) -> float:
    """Angle subtended by one pixel, ``2 atan(1 / (2 fx))``; feeds the
    depth-filter tau. Computed in float32, as the reference does."""
    fx = np.float32(intr.fx)
    return float(np.float32(2.0) * np.arctan(np.float32(1.0)
                                             / (np.float32(2.0) * fx)))


def in_bounds(intr: Intrinsics, px: torch.Tensor, margin: float = 0.0,
              level: int = 0) -> torch.Tensor:
    """Bounds test at a pyramid level."""
    scale = 1.0 / (1 << level)
    w = intr.width * scale
    h = intr.height * scale
    x, y = px[..., 0] * scale, px[..., 1] * scale
    return (x >= margin) & (y >= margin) & (x < w - margin) & (y < h - margin)


def distort_unit_plane(intr: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion on the unit plane (OpenCV model)."""
    k1, k2, p1, p2, k3 = intr.dist
    x, y = uv[..., 0], uv[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_map(intr: Intrinsics, device="cuda") -> torch.Tensor:
    """Dense remap grid ``(H, W, 2)``: for each undistorted output pixel the
    (x, y) source position in the distorted input image."""
    ys = torch.arange(intr.height, dtype=torch.float32, device=device)
    xs = torch.arange(intr.width, dtype=torch.float32, device=device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    u = (grid_x - intr.cx) / intr.fx
    v = (grid_y - intr.cy) / intr.fy
    uvd = distort_unit_plane(intr, torch.stack([u, v], dim=-1))
    src_x = uvd[..., 0] * intr.fx + intr.cx
    src_y = uvd[..., 1] * intr.fy + intr.cy
    return torch.stack([src_x, src_y], dim=-1)


def has_distortion(intr: Intrinsics) -> bool:
    return any(abs(d) > 1e-12 for d in intr.dist)
