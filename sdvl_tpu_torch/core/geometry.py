"""Batched multi-view geometry primitives.

Counterpart of ``sdvl_tpu/core/geometry.py``: projection Jacobians,
midpoint and two-view triangulation, parallax, the Sampson error, the
dominant-plane RANSAC fit and the rotation between two directions. Random
draws come in as Gumbel noise arguments (the reference draws them from a
PRNG key at the same place), so a test can feed both the same numbers.
"""

from __future__ import annotations

import torch

from ..ops.cuda import small_eig
from . import se3


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _safe_den(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < 1e-12, torch.full_like(x, 1e-12), x)


def jacobian_unit_plane(p_cam: torch.Tensor) -> torch.Tensor:
    """d(unit-plane projection) / d(twist) for a left-multiplicative SE3
    update. Returns ``(..., 2, 6)``; twist order is [trans, rot] matching
    :func:`sdvl_tpu_torch.core.se3.exp`."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack(
        [zi, zero, -x * zi2, -x * y * zi2, 1.0 + x * x * zi2, -y * zi], dim=-1
    )
    row1 = torch.stack(
        [zero, zi, -y * zi2, -1.0 - y * y * zi2, x * y * zi2, x * zi], dim=-1
    )
    return torch.stack([row0, row1], dim=-2)


def jacobian_point(pose_q: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
    """d(unit-plane projection) / d(world point), ``(..., 2, 3)``: the
    projection derivative times the world->cam rotation of quaternion
    ``pose_q`` (..., 4)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zi = 1.0 / _safe_den(z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    dproj = torch.stack(
        [
            torch.stack([zi, zero, -x * zi2], dim=-1),
            torch.stack([zero, zi, -y * zi2], dim=-1),
        ],
        dim=-2,
    )
    return dproj @ se3.matrix_from_quat(pose_q)


def triangulate_midpoint(pose_rel: torch.Tensor, bearing_ref: torch.Tensor,
                         bearing_cur: torch.Tensor) -> torch.Tensor:
    """Midpoint triangulation in the *current* frame; ``pose_rel`` maps
    ref-frame coords to cur-frame coords. Solves the 2x2 normal equations
    of ``[b_cur, -R b_ref] [d_cur; d_ref] = t``."""
    R = se3.rotation(pose_rel)
    t = se3.translation(pose_rel)
    f2 = torch.einsum("...ij,...j->...i", R, bearing_ref)
    f1 = bearing_cur
    a11 = torch.sum(f1 * f1, dim=-1)
    a12 = -torch.sum(f1 * f2, dim=-1)
    a22 = torch.sum(f2 * f2, dim=-1)
    b1 = torch.sum(f1 * t, dim=-1)
    b2 = -torch.sum(f2 * t, dim=-1)
    det = _safe_den(a11 * a22 - a12 * a12)
    d1 = (a22 * b1 - a12 * b2) / det
    d2 = (a11 * b2 - a12 * b1) / det
    p1 = f1 * d1[..., None]
    p2 = f2 * d2[..., None] + t
    return 0.5 * (p1 + p2)


def depth_from_triangulation(pose_rel: torch.Tensor, bearing_ref: torch.Tensor,
                             bearing_cur: torch.Tensor) -> torch.Tensor:
    """Depth of the point along ``bearing_ref`` in the *reference* frame
    (``pose_rel`` maps ref coords to cur coords): least squares of
    ``[R b_ref, -b_cur] [d_ref; d_cur] = -t``. Invalid geometry yields
    negative depths, which callers mask."""
    R = se3.rotation(pose_rel)
    t = se3.translation(pose_rel)
    f_ref = torch.einsum("...ij,...j->...i", R, bearing_ref)
    a11 = torch.sum(f_ref * f_ref, dim=-1)
    a12 = -torch.sum(f_ref * bearing_cur, dim=-1)
    a22 = torch.sum(bearing_cur * bearing_cur, dim=-1)
    b1 = -torch.sum(f_ref * t, dim=-1)
    b2 = torch.sum(bearing_cur * t, dim=-1)
    det = _safe_den(a11 * a22 - a12 * a12)
    return (a22 * b1 - a12 * b2) / det


def triangulate_dlt(pose_a: torch.Tensor, pose_b: torch.Tensor,
                    uv_a: torch.Tensor, uv_b: torch.Tensor) -> torch.Tensor:
    """Two-view triangulation from world->cam poses and unit-plane coords:
    depth along the ``a``-frame bearing in the relative frame, mapped back
    to world. Returns world points ``(..., 3)``."""
    rel = se3.compose(pose_b, se3.inverse(pose_a))  # a-cam -> b-cam
    one = torch.ones_like(uv_a[..., :1])
    ray_a = torch.cat([uv_a, one], dim=-1)
    ray_b = torch.cat([uv_b, one], dim=-1)
    b_a = ray_a / _norm(ray_a)[..., None]
    b_b = ray_b / _norm(ray_b)[..., None]
    d_a = depth_from_triangulation(rel, b_a, b_b)
    p_a_cam = b_a * d_a[..., None]
    return se3.transform(se3.inverse(pose_a), p_a_cam)


def parallax_cosine(p_world: torch.Tensor, c_a: torch.Tensor,
                    c_b: torch.Tensor) -> torch.Tensor:
    """Cosine of the angle at the point between two camera centers."""
    ra = c_a - p_world
    rb = c_b - p_world
    na = _norm(ra).clamp_min(1e-12)
    nb = _norm(rb).clamp_min(1e-12)
    return torch.sum(ra * rb, dim=-1) / (na * nb)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over valid entries of a fixed-size masked array: sort once with
    invalid slots at +inf, index the middle valid rank. Zero when no entry is
    valid."""
    v = torch.where(mask, values, torch.full_like(values, float("inf")))
    v, _ = torch.sort(v, dim=-1)
    n = torch.sum(mask, dim=-1)
    idx = (n - 1).clamp_min(0) // 2
    med = torch.gather(v, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def sample_without_replacement(gumbel: torch.Tensor, valid: torch.Tensor,
                               k: int) -> torch.Tensor:
    """``k`` DISTINCT indices drawn uniformly from the True entries of
    ``valid`` (Gumbel top-k).

    ``gumbel`` is standard Gumbel noise of shape ``(..., N)`` -- the caller
    draws it (the reference draws it from a PRNG key at this point), which
    lets a test feed both implementations the same numbers. Leading
    dimensions are independent draws. When fewer than ``k`` entries are
    valid, invalid indices fill the tail in index order, as a stable top-k
    does over equal ``-inf`` scores.
    """
    score = torch.where(valid, gumbel, torch.full_like(gumbel, float("-inf")))
    _, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return idx[..., :k]


def sampson_error_unit_plane(E: torch.Tensor, uv_a: torch.Tensor,
                             uv_b: torch.Tensor) -> torch.Tensor:
    """First-order Sampson distance of an essential/fundamental matrix on
    unit-plane coordinates, ``uv_b^T E uv_a`` with homogeneous [x, y, 1]."""
    ha = torch.cat([uv_a, torch.ones_like(uv_a[..., :1])], dim=-1)
    hb = torch.cat([uv_b, torch.ones_like(uv_b[..., :1])], dim=-1)
    Ea = torch.einsum("...ij,...j->...i", E, ha)
    Etb = torch.einsum("...ji,...j->...i", E, hb)
    num = torch.einsum("...i,...i->...", hb, Ea) ** 2
    den = (Ea[..., 0] ** 2 + Ea[..., 1] ** 2 + Etb[..., 0] ** 2
           + Etb[..., 1] ** 2)
    return num / den.clamp_min(1e-12)


def fit_plane_ransac(pts: torch.Tensor, valid: torch.Tensor,
                     gumbel: torch.Tensor, thresh: float = 0.05):
    """Dominant-plane fit: batched 3-point RANSAC + PCA refinement.

    ``gumbel`` (iters, N) is standard Gumbel noise, one row per hypothesis:
    each row picks 3 distinct valid points (Gumbel top-k). Every hypothesis
    is scored at once, the first best one wins, and its consensus set is
    refined by the smallest-eigenvalue direction of its covariance
    (``small_eig.eigh``: on the card a kernel that reads nothing back).
    Returns ``(normal (3,) unit, d ()), inliers (N,)`` with the plane
    ``n . p + d = 0``; the refined normal keeps the RANSAC winner's
    orientation, whatever sign the eigensolver returns.
    """
    idx = sample_without_replacement(gumbel, valid, 3)           # (I, 3)
    a, b, c = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    n = n / _norm(n).clamp_min(1e-12)[:, None]
    d = -torch.sum(n * a, dim=-1)
    dist = (pts @ n.T + d[None]).abs()                           # (N, I)
    scores = torch.sum((dist < thresh) & valid[:, None], dim=0)
    best = torch.argmax(scores)
    n = n.index_select(0, best.reshape(1))[0]
    d = d.index_select(0, best.reshape(1))[0]

    w = (((pts @ n + d).abs() < thresh) & valid).float()
    wsum = torch.sum(w).clamp_min(1.0)
    centroid = torch.sum(pts * w[:, None], dim=0) / wsum
    centered = (pts - centroid) * w[:, None]
    cov = centered.T @ centered / wsum
    _, vecs = small_eig.eigh(cov)
    n_ref = vecs[:, 0]  # smallest-eigenvalue direction
    n_ref = n_ref / _norm(n_ref).clamp_min(1e-12)
    n_ref = torch.where(torch.dot(n_ref, n) < 0, -n_ref, n_ref)
    d_ref = -torch.dot(n_ref, centroid)
    inliers = ((pts @ n_ref + d_ref).abs() < thresh) & valid
    return (n_ref, d_ref), inliers


def rotation_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimal rotation matrix taking unit vector ``a`` onto unit ``b``
    (Rodrigues); antiparallel vectors get a 180-degree flip about an axis
    orthogonal to ``a``."""
    v = torch.linalg.cross(a, b, dim=-1)
    c = torch.dot(a, b)
    s2 = torch.dot(v, v)
    vx = se3.hat(v)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    safe = s2 > 1e-12
    R = eye + vx + vx @ vx * ((1.0 - c) / torch.where(safe, s2,
                                                      torch.ones_like(s2)))
    e_x = eye[0]
    e_y = eye[1]
    ortho = torch.where(a[0].abs() < 0.9, e_x, e_y)
    axis = torch.linalg.cross(a, ortho, dim=-1)
    axis = axis / _norm(axis).clamp_min(1e-12)
    flip = 2.0 * torch.outer(axis, axis) - eye
    return torch.where(safe | (c > 0), R, flip)
