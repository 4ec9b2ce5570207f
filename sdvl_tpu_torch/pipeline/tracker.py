"""Per-frame tracking step: direct alignment -> matching -> robust pose.

Counterpart of ``sdvl_tpu/pipeline/tracker.py``, with the success/failure
bookkeeping on tracked points (:func:`update_point_stats`) that the full
SLAM mode runs; a frozen map counts nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import camera as cam
from ..core import se3
from ..solvers import image_align, pose as pose_opt
from ..state.map_state import MapState, scatter
from . import matcher


class TrackResult(NamedTuple):
    pose: torch.Tensor           # (7,) refined world->cam pose
    match_pt_idx: torch.Tensor   # (S,) int64 point slots attempted
    match_px: torch.Tensor       # (S, 2)
    match_ok: torch.Tensor       # (S,) final inlier matches
    match_attempted: torch.Tensor  # (S,) a match was attempted
    match_level: torch.Tensor    # (S,) int32 pyramid level of each match
    n_matches: torch.Tensor      # () int32
    n_attempts: torch.Tensor     # () int32
    align_error: torch.Tensor    # () direct-alignment residual


def track_frame(m: MapState, intr, last_pyr, last_pt_idx: torch.Tensor,
                last_ok: torch.Tensor, pose_last: torch.Tensor,
                cur_pyr, pose_pred: torch.Tensor,
                cell: int = 32, align_max_level: int = 4,
                align_min_level: int = 2, align_iters: int = 10,
                pose_iters: int = 10, inlier_thresh_px: float = 2.0,
                use_orb: bool = False,
                ransac_gumbel: Optional[torch.Tensor] = None,
                ransac_points: int = 5,
                patch_half: int = 4, lk_iters: int = 10,
                search_px: float = 6.0, max_matches: Optional[int] = None,
                align_patch_half: int = 2, orb_radius: int = 15,
                affine_illum: bool = False,
                ) -> TrackResult:
    """One tracking step.

    ``last_pt_idx``/``last_ok`` are the previous frame's match set, used for
    direct alignment against ``last_pyr``. With ``ransac_gumbel``
    ((n_hyp, S) Gumbel noise, one row per hypothesis) matches are
    additionally gated by a batched pose RANSAC of ``ransac_points``-point
    minimal sets before the robust optimization; without it the Tukey IRLS
    alone handles outliers.
    """
    P = m.pt_valid.shape[0]
    last_pt_idx = last_pt_idx.clamp(0, P - 1)
    pts_last = m.pt_pos[last_pt_idx]

    ia = image_align.compute_pose(
        last_pyr, cur_pyr, intr, pts_last, last_ok & m.pt_valid[last_pt_idx],
        pose_last, pose_pred,
        max_level=align_max_level, min_level=align_min_level,
        iters=align_iters, patch_half=align_patch_half,
        affine_illum=affine_illum,
    )

    mr = matcher.match_map_points(m, intr, cur_pyr, ia.pose, cell=cell,
                                  use_orb=use_orb, half=patch_half,
                                  lk_iters=lk_iters, reproj_px=search_px,
                                  max_matches=max_matches,
                                  orb_radius=orb_radius)

    # float32 quotient, as the reference computes it
    thresh = float(np.float32(inlier_thresh_px)
                   / np.float32(min(intr.fx, intr.fy)))
    ok = mr.ok
    pts_m = m.pt_pos[mr.pt_idx]
    if ransac_gumbel is not None:
        pose_r = pose_opt.ransac(
            ia.pose, pts_m, mr.uv, ok, ransac_gumbel,
            sample_size=ransac_points, inlier_thresh=thresh,
        )
        p_cam = se3.transform(pose_r, pts_m)
        d = mr.uv - cam.project_unit_plane(p_cam)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        gated = ok & (r < 2.0 * thresh) & (p_cam[..., 2] > 0)
        # keep the gate only if RANSAC found real consensus -- otherwise it
        # would wipe the match set on a degenerate sample
        ok = torch.where(torch.sum(gated) >= 8, gated, ok)
    po = pose_opt.optimize(
        ia.pose, pts_m, mr.uv, ok,
        iters=pose_iters, inlier_thresh=thresh,
    )
    ok = ok & po.inliers
    return TrackResult(
        pose=po.pose,
        match_pt_idx=mr.pt_idx,
        match_px=mr.px,
        match_ok=ok,
        match_attempted=mr.attempted,
        match_level=mr.level,
        n_matches=torch.sum(ok).to(torch.int32),
        n_attempts=torch.sum(mr.attempted).to(torch.int32),
        align_error=ia.error,
    )


def update_point_stats(m: MapState, tr: TrackResult, max_failed: int = 15,
                       enabled=True) -> MapState:
    """Success/failure counters on tracked points: a match counts one
    success and clears the failure run, an attempted miss counts one
    failure, and a point with more than ``max_failed`` consecutive failures
    dies. ``enabled`` (a host bool, or a () bool tensor that is selected on
    the device) turns the counting off, as while relocalizing nothing is
    counted."""
    if isinstance(enabled, bool) and not enabled:
        return m._replace(pt_valid=m.pt_valid & (m.pt_fail <= max_failed))
    P = m.pt_valid.shape[0]
    dump = torch.full_like(tr.match_pt_idx, P)
    idx_ok = torch.where(tr.match_ok, tr.match_pt_idx, dump)
    idx_bad = torch.where(tr.match_attempted & ~tr.match_ok,
                          tr.match_pt_idx, dump)
    pt_found = scatter(m.pt_found, idx_ok, 1, accumulate=True)
    pt_fail = scatter(m.pt_fail, idx_ok, 0)
    pt_fail = scatter(pt_fail, idx_bad, 1, accumulate=True)
    if isinstance(enabled, torch.Tensor):
        pt_found = torch.where(enabled, pt_found, m.pt_found)
        pt_fail = torch.where(enabled, pt_fail, m.pt_fail)
    pt_valid = m.pt_valid & (pt_fail <= max_failed)
    return m._replace(pt_found=pt_found, pt_fail=pt_fail, pt_valid=pt_valid)


def motion_model_update(xi_prev: torch.Tensor, pose_new: torch.Tensor,
                        pose_old: torch.Tensor, decay: float = 0.9):
    """Constant-velocity model with decay.
    Returns (xi_model, pose_prediction_for_next_frame)."""
    xi = se3.log(se3.compose(pose_new, se3.inverse(pose_old)))
    xi_model = decay * xi
    pred = se3.compose(se3.exp(xi_model), pose_new)
    return xi_model, pred
