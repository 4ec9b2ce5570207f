"""SE(3) Lie-group operations on stacked pose tensors.

Counterpart of ``sdvl_tpu/core/se3.py``. A pose is a float32 tensor of shape
``(..., 7)`` laid out as ``[qw, qx, qy, qz, tx, ty, tz]``; it maps world
coordinates to camera coordinates, ``x_cam = R @ x_world + t``. Every function
broadcasts over leading dimensions and keeps the reference's operation order,
so results agree with it to float32 rounding.
"""

from __future__ import annotations

import torch

# Small-angle threshold on theta^2 for the Taylor branches (float32).
_EPS = 1e-6


def identity(batch_shape=(), device=None) -> torch.Tensor:
    """Identity pose(s) of shape ``batch_shape + (7,)``."""
    pose = torch.zeros(tuple(batch_shape) + (7,), dtype=torch.float32,
                       device=device)
    pose[..., 0].fill_(1.0)   # a fill kernel; `= 1.0` would copy from the host
    return pose


def translation(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., 4:7]


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pose from a rotation matrix ``(..., 3, 3)`` and a translation."""
    return torch.cat([quat_from_matrix(R), t], dim=-1)


def rotation(pose: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` of the pose."""
    return matrix_from_quat(pose[..., :4])


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def normalize(pose: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion part; canonical sign ``qw >= 0``."""
    q = pose[..., :4]
    q = q / _norm(q).clamp_min(1e-12)
    q = torch.where(q[..., :1] < 0, -q, q)
    return torch.cat([q, pose[..., 4:7]], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` ``(..., 3)`` by quaternion(s) ``q`` ``(..., 4)``
    (two-cross-product form)."""
    qv = q[..., 1:4]
    qw = q[..., 0:1]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Shepperd conversion, branch-free: all four candidate solutions are
    computed and the numerically strongest is selected per element."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(x.clamp_min(1e-12))

    s0 = _safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = _safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = _safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)

    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None], q0,
        torch.where(cond1[..., None], q1,
                    torch.where(cond2[..., None], q2, q3)),
    )
    q = q / _norm(q).clamp_min(1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b``: apply ``b`` first, then ``a``."""
    q = quat_multiply(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return normalize(torch.cat([q, t], dim=-1))


def inverse(pose: torch.Tensor) -> torch.Tensor:
    qinv = quat_conjugate(pose[..., :4])
    t = -quat_rotate(qinv, pose[..., 4:7])
    return torch.cat([qinv, t], dim=-1)


def transform(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose(s) to points ``(..., 3)``: ``R @ p + t``."""
    return quat_rotate(pose[..., :4], pts) + pose[..., 4:7]


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``(..., 3)``."""
    zeros = torch.zeros_like(w[..., 0])
    rows = torch.stack(
        [
            zeros, -w[..., 2], w[..., 1],
            w[..., 2], zeros, -w[..., 0],
            -w[..., 1], w[..., 0], zeros,
        ],
        dim=-1,
    )
    return rows.reshape(w.shape[:-1] + (3, 3))


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map. ``xi`` is ``(..., 6)`` = [rho (trans), omega
    (rot)], with the small-angle Taylor branches taken by ``where``."""
    rho, omega = xi[..., :3], xi[..., 3:6]
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq.clamp_min(0.0))
    half = 0.5 * theta

    small = theta_sq < _EPS
    sinc_half = torch.where(
        small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta.clamp_min(1e-20)
    )
    qw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    q = torch.cat([qw, sinc_half * omega], dim=-1)

    W = hat(omega)
    W2 = W @ W
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq.clamp_min(1e-20))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta))
                    / (theta_sq * theta).clamp_min(1e-20))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + a[..., None] * W + b[..., None] * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return normalize(torch.cat([q, t], dim=-1))


def log(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm, inverse of :func:`exp`."""
    pose = normalize(pose)
    q, t = pose[..., :4], pose[..., 4:7]
    qw = q[..., 0:1].clamp(-1.0, 1.0)
    qv = q[..., 1:4]
    sin_half = _norm(qv)
    theta = 2.0 * torch.atan2(sin_half, qw)
    small = theta * theta < _EPS
    k = torch.where(small, 2.0 + theta * theta / 12.0,
                    theta / sin_half.clamp_min(1e-20))
    omega = k * qv

    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    W = hat(omega)
    W2 = W @ W
    th = torch.sqrt(theta_sq.clamp_min(0.0))
    half = 0.5 * th
    coeff = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half).clamp_min(1e-20))
        / theta_sq.clamp_min(1e-20),
    )
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coeff[..., None] * W2
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, omega], dim=-1)


def boxplus(pose: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update ``exp(xi) * pose`` used by all GN solvers."""
    return compose(exp(xi), pose)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b^{-1}``: the motion taking frame b's camera to frame a's."""
    return compose(a, inverse(b))
