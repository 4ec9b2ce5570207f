"""Robust 6-DoF pose refinement from 2D-3D matches (batched IRLS-GN).

Counterpart of ``sdvl_tpu/solvers/pose.py``: Gauss-Newton with Tukey weights
scaled by MAD, inlier classification at the threshold, and a fixed-shape
RANSAC whose hypotheses are a written-out batch of tiny GN solves (the
reference ``vmap``s them). The reference's early-exit ``while_loop`` becomes a
loop of fixed count whose pose freezes once ``stop`` is set. RANSAC takes its
Gumbel noise as an argument, so that a test can hand both implementations the
same draws.

:func:`optimize` runs in float64 and returns float32 (the reference computes
in float32). Its normal equations sum ~400 terms per step, and a float32 sum
rounds by the order the device adds them in: over the 85-frame JAX record
at 640x480 (``chip_smoke.py`` phase ``slam``), the card's order flipped one
match's inlier decision on 3 of the first 66 frames where the CPU's did
not, and 16 of 83 frames ended with other match counts than the reference
(against 11 on the CPU). In float64 the steps round to the same float32
pose on either device, and the card agrees with the reference on every one
of the first 66 frames (6 of 83 differ by 1-2 matches; measured on the
H100).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam
from ..core import geometry, se3
from ..ops import interp


class PoseOptResult(NamedTuple):
    pose: torch.Tensor     # (7,)
    inliers: torch.Tensor  # (N,) bool
    error: torch.Tensor    # () mean robust reprojection error (unit plane)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _tukey_weights(r_norm: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Tukey biweight with MAD scale."""
    med = geometry.masked_median(r_norm, mask)
    n = torch.sum(mask).float()
    sigma = 1.4826 * (1.0 + 5.0 / (n * 2.0 - 6.0).clamp_min(1.0)) * med
    sigma = sigma.clamp_min(1e-6)
    c = 4.6851 * sigma
    x = r_norm / c
    w = torch.where(x <= 1.0, (1.0 - x * x) ** 2, torch.zeros_like(x))
    return w * mask


def _solve6(Hmat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the (..., 6, 6) normal equations; a singular system yields
    non-finite numbers instead of raising and synchronising."""
    return torch.linalg.solve_ex(Hmat, rhs[..., None]).result[..., 0]


def optimize(pose_init: torch.Tensor, pts_w: torch.Tensor,
             uv_obs: torch.Tensor, valid: torch.Tensor, iters: int = 10,
             inlier_thresh: float = 2.0 / 525.0) -> PoseOptResult:
    """IRLS Gauss-Newton on unit-plane reprojection error.

    ``uv_obs`` are unit-plane measurements of world points ``pts_w`` from the
    current camera; ``inlier_thresh`` in unit-plane units. Computed in
    float64 (see the module note); the pose and error come back float32.
    """
    pose_init = pose_init.double()
    pts_w, uv_obs = pts_w.double(), uv_obs.double()
    vmask = valid.double()
    eye = torch.eye(6, dtype=torch.float64, device=pts_w.device)

    def residuals(pose):
        p_cam = se3.transform(pose, pts_w)
        uv = cam.project_unit_plane(p_cam)
        r = uv_obs - uv
        front = (p_cam[..., 2] > 1e-3).double() * vmask
        return r, p_cam, front

    pose = pose_init
    stop = torch.zeros((), dtype=torch.bool, device=pts_w.device)
    for _ in range(iters):
        r, p_cam, front = residuals(pose)
        r_norm = _norm(r)
        w = _tukey_weights(r_norm, front > 0)
        J = -geometry.jacobian_unit_plane(p_cam)  # residual = obs - proj
        Hmat = torch.einsum("nki,nkj,n->ij", J, J, w)
        g = torch.einsum("nki,nk,n->i", J, r, w)
        Hmat = Hmat + 1e-8 * eye
        dx = _solve6(Hmat, -g)
        # the update of the iteration that converges is still applied, then
        # the pose freezes (the reference leaves its loop at this point)
        pose = torch.where(stop, pose, se3.boxplus(pose, dx))
        stop = stop | (dx.abs().max() < 1e-8)

    r, _, front = residuals(pose)
    r_norm = _norm(r)
    inliers = (front > 0) & (r_norm < inlier_thresh)
    err = torch.sum(r_norm * front) / torch.sum(front).clamp_min(1.0)
    return PoseOptResult(pose=pose.float(), inliers=inliers, error=err.float())


def ransac(pose_init: torch.Tensor, pts_w: torch.Tensor,
           uv_obs: torch.Tensor, valid: torch.Tensor, gumbel: torch.Tensor,
           sample_size: int = 5, gn_iters: int = 3,
           inlier_thresh: float = 2.0 / 525.0) -> torch.Tensor:
    """Fixed-shape RANSAC: batched minimal GN solves, best-consensus pose.

    ``gumbel`` (n_hyp, N) is standard Gumbel noise, one row per hypothesis:
    each row picks ``sample_size`` distinct valid matches (Gumbel top-k).
    All hypotheses start from ``pose_init``, take ``gn_iters`` GN steps on
    their minimal set, and the pose with the largest inlier count wins (the
    first one on a tie).
    """
    n_hyp = gumbel.shape[0]
    dev = pts_w.device
    p_valid = valid.float()
    idx = geometry.sample_without_replacement(gumbel, valid, sample_size)
    pw = pts_w[idx]                                   # (n_hyp, k, 3)
    uv = uv_obs[idx]                                  # (n_hyp, k, 2)
    eye = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)

    pose = pose_init[None].expand(n_hyp, 7)
    for _ in range(gn_iters):
        p_cam = se3.transform(pose[:, None, :], pw)
        rr = uv - cam.project_unit_plane(p_cam)
        J = -geometry.jacobian_unit_plane(p_cam)      # (n_hyp, k, 2, 6)
        H = torch.einsum("hnki,hnkj->hij", J, J) + eye
        g = torch.einsum("hnki,hnk->hi", J, rr)
        pose = se3.boxplus(pose, _solve6(H, -g))
    p_cam = se3.transform(pose[:, None, :], pts_w[None])
    r = _norm(uv_obs[None] - cam.project_unit_plane(p_cam))
    score = torch.sum(((r < inlier_thresh) & (p_cam[..., 2] > 0)) * p_valid,
                      dim=-1)
    return interp.take_row(pose, torch.argmax(score))
