"""Two-view map initialization: pyramidal flow + homography + triangulation.

Counterpart of ``sdvl_tpu/pipeline/bootstrap.py``: coarse-to-fine sparse
flow from the first frame's corners (an exhaustive ZMSSD grid search at a
coarse level, then LK down the pyramid), the homography RANSAC and its
decomposition (``solvers/homography.py``), inlier triangulation and the
rescale to ``map_scale``. The ground-plane alignment of the seeded map is
``mapper.transform_initial_map``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..core import geometry, se3
from ..ops import interp, patch as patch_ops
from ..solvers import homography, lk


def pyramidal_flow(pyr_a, pyr_b, xy_a: torch.Tensor, valid: torch.Tensor,
                   half: int = 4, iters: int = 12, start_level: int = 2,
                   max_err: float = 25.0, search_radius: int = 16):
    """Sparse optical flow a->b, coarse-to-fine. Returns (xy_b (N, 2)
    level-0 coords, ok (N,)).

    A ZMSSD grid search of +-``search_radius`` px at ``start_level`` finds
    LK's basin of attraction; each finer level adopts its LK refinement only
    where it converged and moved less than 32 px. Success is judged at
    level 0 only: converged, in bounds, final residual below ``max_err``.
    """
    l0 = start_level
    ref_c = interp.extract_patches(pyr_a[l0], xy_a / (1 << l0), half)
    xy_c, _ = patch_ops.grid_search(pyr_b[l0], ref_c, xy_a / (1 << l0),
                                    search_radius)
    xy = xy_c * (1 << l0)
    ok = None
    for l in range(start_level, -1, -1):
        patches = interp.extract_patches(pyr_a[l], xy_a / (1 << l), half)
        res = lk.align_patches(pyr_b[l], patches, xy / (1 << l), valid,
                               iters=iters, max_shift=float("inf"))
        d = res.xy * (1 << l) - xy
        sane = res.converged & (torch.sqrt(torch.sum(d * d, dim=-1)) < 32.0)
        xy = torch.where(sane[:, None], res.xy * (1 << l), xy)
        if l == 0:
            ok = valid & res.converged & (res.error < max_err)
    return xy, ok


class BootstrapResult(NamedTuple):
    ok_flow: torch.Tensor       # () bool: enough flow survivors
    median_shift: torch.Tensor  # () px
    pose2: torch.Tensor         # (7,) second-camera pose (world = cam1)
    pts_w: torch.Tensor         # (N, 3) triangulated world points
    px1: torch.Tensor           # (N, 2) pixel in frame 1
    px2: torch.Tensor           # (N, 2) pixel in frame 2
    inlier: torch.Tensor        # (N,) bool
    n_inliers: torch.Tensor     # () int32


def init_two_view(intr, pyr1, pyr2, corners_xy: torch.Tensor,
                  corners_valid: torch.Tensor, gumbel: torch.Tensor,
                  map_scale: float = 1.0, thresh_px: float = 2.0,
                  min_corners: int = 50) -> BootstrapResult:
    """Second-frame initialization. ``gumbel`` (n_hyp, N) is the homography
    RANSAC's noise. The caller decides restart / retry / success from
    ``ok_flow``, ``median_shift`` and ``n_inliers``."""
    px2, flow_ok = pyramidal_flow(pyr1, pyr2, corners_xy, corners_valid)
    d = px2 - corners_xy
    shift = torch.sqrt(torch.sum(d * d, dim=-1))
    median_shift = geometry.masked_median(shift, flow_ok)

    uv1 = cam.unproject(intr, corners_xy)
    uv1 = uv1[:, :2] / uv1[:, 2:3]
    uv2 = cam.unproject(intr, px2)
    uv2 = uv2[:, :2] / uv2[:, 2:3]

    # float32 quotient, as the reference computes it
    thresh = float(np.float32(thresh_px) / np.float32(min(intr.fx, intr.fy)))
    H, inl = homography.ransac_homography(uv1, uv2, flow_ok, gumbel,
                                          thresh=thresh)
    dec = homography.decompose_homography(H)
    pose2, _votes = homography.choose_decomposition(dec, uv1, uv2,
                                                    inl.float())

    # triangulate inliers in world (= cam1) frame
    n = uv1.shape[0]
    pts_w = geometry.triangulate_dlt(
        se3.identity(device=uv1.device).expand(n, 7),
        pose2.expand(n, 7), uv1, uv2)
    p1 = pts_w  # cam1 == world
    p2 = se3.transform(pose2[None], pts_w)
    good = inl & (p1[:, 2] > 1e-3) & (p2[:, 2] > 1e-3)

    # rescale so the median depth is map_scale
    med_depth = geometry.masked_median(p1[:, 2], good)
    scale = map_scale / med_depth.clamp_min(1e-6)
    pts_w = pts_w * scale
    pose2 = torch.cat([pose2[:4], pose2[4:] * scale])

    return BootstrapResult(
        ok_flow=torch.sum(flow_ok) >= min_corners,
        median_shift=median_shift,
        pose2=pose2,
        pts_w=pts_w,
        px1=corners_xy,
        px2=px2,
        inlier=good,
        n_inliers=torch.sum(good).to(torch.int32),
    )
