"""Point reprojection, re-observation and epipolar matching.

Counterpart of ``sdvl_tpu/pipeline/matcher.py``: visibility tests for ALL
point slots are one batched projection, per-cell winner selection is a
scatter-max (:func:`grid_select`), subpixel refinement is the batched
multi-level LK solver; :func:`reobserve_points` links existing points into a
new keyframe, and :func:`epipolar_search` scores a fixed number of samples
along every depth-filter candidate's epipolar segment at once.

Where the reference relies on XLA dropping an out-of-range scatter index or
saturating a float -> int cast, the port routes the index to a dump slot and
makes the value finite first (torch faults on both).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import camera as cam
from ..core import geometry, se3
from ..ops import fast as fast_ops
from ..ops import interp, orb, patch as patch_ops
from ..ops.fast import _cell_index
from ..solvers import lk
from ..state.map_state import MapState, best_connections, scatter


def grid_select(cell_id: torch.Tensor, score: torch.Tensor,
                valid: torch.Tensor, n_cells: int):
    """Pick the best-scoring valid element per grid cell.

    Returns ``(sel_idx (n_cells,) int64, sel_valid (n_cells,) bool)``. The
    ranking key is ``score * n + idx`` IN FLOAT32, exactly as the reference
    computes it (score major, later index wins ties; two keys that round to
    the same float32 both count as winners and the larger index is taken).
    Invalid elements go to a dump slot ``n_cells`` that is cut off.
    """
    n = cell_id.shape[0]
    dev = cell_id.device
    idx = torch.arange(n, device=dev)
    ninf = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    key = torch.where(valid, score.float() * n + idx, ninf)
    cell = torch.where(valid, cell_id.long(), torch.full_like(idx, n_cells))
    best = torch.full((n_cells + 1,), float("-inf"), dtype=torch.float32,
                      device=dev)
    best = best.scatter_reduce(0, cell, key, "amax", include_self=True)
    winner = valid & (key == best[cell.clamp(0, n_cells - 1)])
    wcell = torch.where(winner, cell, torch.full_like(idx, n_cells))
    sel = torch.zeros(n_cells + 1, dtype=torch.int64, device=dev)
    sel = sel.scatter_reduce(0, wcell, idx, "amax", include_self=True)
    sel_valid = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    sel_valid.index_fill_(0, wcell, True)
    return sel[:n_cells], sel_valid[:n_cells]


class MatchResult(NamedTuple):
    pt_idx: torch.Tensor     # (S,) int64 point-slot index per match attempt
    px: torch.Tensor         # (S, 2) refined pixel position in current frame
    ok: torch.Tensor         # (S,) bool match succeeded
    attempted: torch.Tensor  # (S,) bool a match was attempted
    uv: torch.Tensor         # (S, 2) unit-plane measurement (from px)
    level: torch.Tensor      # (S,) int32 pyramid level the match was made at


def _anchor_data(m: MapState, pt_idx: torch.Tensor):
    K = m.kf_valid.shape[0]
    ak = m.pt_anchor_kf[pt_idx].clamp(0, K - 1)
    apx = m.obs_px[ak, pt_idx]
    alevel = m.obs_level[ak, pt_idx]
    apose = m.kf_pose[ak]
    return ak, apx, alevel, apose


def _warped_ref_patches(m: MapState, intr, pt_idx, pose_cur, half: int):
    """Affine-warped anchor patches + per-point search level.
    Returns (patches (S, s, s), search_level (S,), px_cur (S, 2))."""
    S = pt_idx.shape[0]
    s = 2 * half
    ak, apx, alevel, apose = _anchor_data(m, pt_idx)
    p_w = m.pt_pos[pt_idx]
    p_anchor = se3.transform(apose, p_w)
    depth_ref = torch.sqrt(torch.sum(p_anchor * p_anchor, dim=-1))

    T_cur_ref = se3.compose(pose_cur[None], se3.inverse(apose))
    A_cur_ref = patch_ops.warp_matrix_affine(
        intr, apx, alevel, depth_ref, T_cur_ref
    )  # (S,2,2) d(px_cur)/d(px_ref)
    n_levels = len(m.kf_pyr)
    search_level = patch_ops.search_level_from_warp(A_cur_ref, n_levels - 1)
    det = (A_cur_ref[:, 0, 0] * A_cur_ref[:, 1, 1]
           - A_cur_ref[:, 0, 1] * A_cur_ref[:, 1, 0])
    det = torch.where(det.abs() < 1e-6, torch.full_like(det, 1e-6), det)
    inv = torch.stack([
        torch.stack([A_cur_ref[:, 1, 1], -A_cur_ref[:, 0, 1]], -1),
        torch.stack([-A_cur_ref[:, 1, 0], A_cur_ref[:, 0, 0]], -1),
    ], -2) / det[:, None, None]                     # A_ref_cur (S,2,2)

    # output patch offsets live at the *search level* of the current frame
    offs = interp.patch_offsets(half, pt_idx.device).reshape(s * s, 2)
    scale_cur = torch.exp2(search_level.float())[:, None, None]
    offs_ref_l0 = torch.einsum("sij,pj->spi", inv, offs) * scale_cur
    pos_ref_l0 = apx[:, None, :] + offs_ref_l0

    vals = interp.bilinear_indexed_pyramid(
        m.kf_pyr, ak[:, None],
        alevel.clamp(0, n_levels - 1)[:, None], pos_ref_l0
    )
    patches = vals.reshape(S, s, s)
    px_cur = cam.project(intr, se3.transform(T_cur_ref, p_anchor))
    return patches, search_level, px_cur


def match_map_points(m: MapState, intr, cur_pyr, pose_cur: torch.Tensor,
                     cell: int, half: int = 4, lk_iters: int = 10,
                     reproj_px: float = 6.0, use_orb: bool = False,
                     orb_max_dist: int = 100,
                     err_max: float = 22.0,
                     max_matches: Optional[int] = None,
                     orb_radius: int = 15) -> MatchResult:
    """Reproject valid map points, pick one per grid cell, LK-align each.

    The per-cell capacity is the structural match budget; ``max_matches``
    additionally caps the number of attempts: when fewer than the cell
    count, only the ``max_matches`` best per-cell winners (by found-fail
    quality; a stable sort, since equal integer qualities are the rule) are
    LK-aligned. A match succeeds when LK converges, lands within
    ``reproj_px`` of the prediction and its mean-abs residual stays under
    ``err_max``. With ``use_orb`` matches are additionally gated by the
    Hamming distance between the point's anchor ORB descriptor and a
    descriptor at the matched position (< ``orb_max_dist``).
    """
    H, W = cur_pyr[0].shape
    gw, gh = W // cell, H // cell
    n_cells = gw * gh

    p_cam = se3.transform(pose_cur[None], m.pt_pos)
    px = cam.project(intr, p_cam)
    visible = (
        m.pt_valid & (p_cam[:, 2] > 1e-3)
        & cam.in_bounds(intr, px, margin=half + 2)
    )
    cx = _cell_index(px[:, 0], cell, gw)
    cy = _cell_index(px[:, 1], cell, gh)
    cell_id = cy * gw + cx
    quality = (m.pt_found - m.pt_fail).float()
    sel_idx, attempted = grid_select(cell_id, quality, visible, n_cells)
    if max_matches is not None and max_matches < n_cells:
        q_sel = torch.where(attempted, quality[sel_idx],
                            torch.full_like(quality[sel_idx], float("-inf")))
        keep = torch.sort(q_sel, descending=True, stable=True)[1][:max_matches]
        sel_idx, attempted = sel_idx[keep], attempted[keep]

    patches, search_level, px_pred = _warped_ref_patches(
        m, intr, sel_idx, pose_cur, half
    )
    res = lk.align_patches_pyramid(
        cur_pyr, search_level, patches, px_pred, attempted, iters=lk_iters
    )
    d = res.xy - px_pred
    drift = torch.sqrt(torch.sum(d * d, dim=-1))
    scale = torch.exp2(search_level.float())
    ok = (attempted & res.converged & (drift < reproj_px * scale)
          & (res.error < err_max))
    if use_orb:
        desc_cur = orb.descriptors(cur_pyr[0], res.xy, radius=orb_radius)
        dist = orb.hamming(desc_cur, m.pt_desc[sel_idx])
        ok = ok & (dist < orb_max_dist)
    uv = torch.stack([
        (res.xy[:, 0] - intr.cx) / intr.fx,
        (res.xy[:, 1] - intr.cy) / intr.fy,
    ], -1)
    return MatchResult(pt_idx=sel_idx, px=res.xy, ok=ok,
                       attempted=attempted, uv=uv,
                       level=search_level.to(torch.int32))


def reobserve_points(m: MapState, intr, pyr, pose: torch.Tensor,
                     kf_slot: torch.Tensor, n_best: int = 5,
                     max_reobs: int = 512, half: int = 4,
                     lk_iters: int = 8, reproj_px: float = 3.0,
                     err_max: float = 22.0) -> MapState:
    """Re-link existing map points into a NEW keyframe.

    Every valid point seen by the ``n_best`` most-covisible keyframes but
    not yet observed in the new keyframe is projected into it and
    patch-verified (warped anchor patch + LK); the successes become
    observations. Fixed shape: the ``max_reobs`` best candidates (by
    found-fail quality; a stable sort, since most candidates tie at
    ``-inf``) are attempted in one batched LK solve.
    """
    K, P, _ = m.capacities
    max_reobs = min(max_reobs, P)

    conn_idx, conn_counts = best_connections(m, kf_slot, min(n_best, K))
    seen_by_conn = torch.any(
        m.obs_mask[conn_idx] & (conn_counts > 0)[:, None], dim=0)   # (P,)
    cand = m.pt_valid & seen_by_conn & ~interp.take_row(m.obs_mask, kf_slot)

    p_cam = se3.transform(pose[None], m.pt_pos)
    px = cam.project(intr, p_cam)
    visible = cand & (p_cam[:, 2] > 1e-3) & cam.in_bounds(
        intr, px, margin=half + 2)
    quality = torch.where(
        visible, (m.pt_found - m.pt_fail).float(),
        torch.full((P,), float("-inf"), device=px.device))
    sel = torch.sort(quality, descending=True, stable=True)[1][:max_reobs]
    sel_ok = visible[sel]

    patches, search_level, px_pred = _warped_ref_patches(
        m, intr, sel, pose, half)
    res = lk.align_patches_pyramid(
        pyr, search_level, patches, px_pred, sel_ok, iters=lk_iters)
    d = res.xy - px_pred
    drift = torch.sqrt(torch.sum(d * d, dim=-1))
    scale = torch.exp2(search_level.float())
    ok = (sel_ok & res.converged & (drift < reproj_px * scale)
          & (res.error < err_max))

    idx = torch.where(ok, sel, torch.full_like(sel, P))
    return m._replace(
        obs_mask=scatter(m.obs_mask, (kf_slot, idx), True),
        obs_px=scatter(m.obs_px, (kf_slot, idx), res.xy),
        obs_level=scatter(m.obs_level, (kf_slot, idx), search_level),
        pt_found=scatter(m.pt_found, idx, 1, accumulate=True),
    )


class EpipolarResult(NamedTuple):
    px: torch.Tensor           # (C, 2) matched pixel in current frame
    ok: torch.Tensor           # (C,) bool
    depth_anchor: torch.Tensor # (C,) triangulated depth along anchor bearing
    attempted: torch.Tensor    # (C,)


def _gate_map(img: torch.Tensor) -> torch.Tensor:
    """Shi-Tomasi response dilated by a 3x3 maximum (``-inf`` outside the
    image, as the reference's ``reduce_window`` pads)."""
    st = fast_ops.shi_tomasi(img.float())
    return F.max_pool2d(st[None, None], 3, stride=1, padding=1)[0, 0]


def epipolar_search(m: MapState, intr, cur_pyr, pose_cur: torch.Tensor,
                    n_samples: int = 32, half: int = 4,
                    zmssd_max: float = 40.0 ** 2 * 64,
                    lk_iters: int = 8, use_orb: bool = False,
                    orb_max_dist: int = 100,
                    orb_radius: int = 15,
                    corner_gate: bool = False,
                    corner_thresh: float = 50.0) -> EpipolarResult:
    """Match depth-filter candidates along their epipolar segments.

    The rho +- 2 sigma inverse-depth interval projects to a segment in the
    current image; ``n_samples`` equispaced samples (uniform in inverse
    depth) are scored by ZMSSD against the anchor patch warped at the mean
    depth, the best one is LK-refined and triangulated. ``corner_gate``
    keeps only samples within 1 px of a pixel whose Shi-Tomasi response at
    the candidate's search level clears ``corner_thresh``. ``cur_pyr`` may
    be a uint8 keyframe pyramid (samples convert after the gather).
    """
    C = m.cand_valid.shape[0]
    s = 2 * half
    dev = pose_cur.device
    K = m.kf_valid.shape[0]
    cand_kf = m.cand_kf.clamp(0, K - 1)

    apose = m.kf_pose[cand_kf]
    T_cur_ref = se3.compose(pose_cur[None], se3.inverse(apose))  # (C,7)

    sigma = torch.sqrt(m.cand_sigma2.clamp_min(1e-12))
    rho_min = (m.cand_rho - 2 * sigma).clamp_min(1e-6)
    rho_max = m.cand_rho + 2 * sigma
    # the reference's linspace: i * float32(1 / (n - 1))
    ts = torch.arange(n_samples, dtype=torch.float32, device=dev) * float(
        np.float32(1.0 / (n_samples - 1)))
    rho_s = rho_min[:, None] + (rho_max - rho_min)[:, None] * ts[None]

    p_ref = m.cand_bearing[:, None, :] / rho_s[..., None]       # (C,S,3)
    p_cur = se3.transform(T_cur_ref[:, None, :], p_ref)
    px_s = cam.project(intr, p_cur)                              # (C,S,2)
    inb = cam.in_bounds(intr, px_s, margin=half + 2) & (p_cur[..., 2] > 1e-3)

    # warp the anchor patch once per candidate at the mean depth
    depth_mean = 1.0 / m.cand_rho.clamp_min(1e-6)
    A = patch_ops.warp_matrix_affine(
        intr, m.cand_px, m.cand_level, depth_mean, T_cur_ref)
    search_level = patch_ops.search_level_from_warp(A, len(cur_pyr) - 1)
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    det = torch.where(det.abs() < 1e-6, torch.full_like(det, 1e-6), det)
    inv = torch.stack([
        torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1),
    ], -2) / det[:, None, None]

    offs = interp.patch_offsets(half, dev).reshape(s * s, 2)
    scale_cur = torch.exp2(search_level.float())[:, None, None]
    pos_ref = m.cand_px[:, None, :] + torch.einsum(
        "cij,pj->cpi", inv, offs) * scale_cur
    n_levels = len(m.kf_pyr)
    ref_patch = interp.bilinear_indexed_pyramid(
        m.kf_pyr, cand_kf[:, None],
        m.cand_level.clamp(0, n_levels - 1)[:, None], pos_ref)  # (C, s*s)
    ref_zm = ref_patch - torch.mean(ref_patch, dim=-1, keepdim=True)

    # ZMSSD of every sample: (C, S, s*s) gather from the current pyramid
    fp = interp.flatten_pyramid(cur_pyr)
    scale_c = torch.exp2(search_level.float())                   # (C,)
    pos_cur = (px_s[:, :, None, :]
               + offs[None, None] * scale_c[:, None, None, None])
    cur_vals = interp.bilinear_pyramid(fp, search_level[:, None, None],
                                       pos_cur)                  # (C,S,s*s)
    cur_zm = cur_vals - torch.mean(cur_vals, dim=-1, keepdim=True)
    score = torch.sum((cur_zm - ref_zm[:, None, :]) ** 2, dim=-1)
    inf = torch.full_like(score, float("inf"))
    score = torch.where(inb, score, inf)
    if corner_gate:
        gate = interp.flatten_pyramid(tuple(_gate_map(p) for p in cur_pyr))
        gate_vals = interp.bilinear_pyramid(gate, search_level[:, None],
                                            px_s)                # (C, S)
        score = torch.where(gate_vals > corner_thresh, score, inf)

    best = torch.argmin(score, dim=1)
    best_px = torch.gather(px_s, 1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    best_score = torch.gather(score, 1, best[:, None])[:, 0]
    attempted = m.cand_valid & torch.isfinite(best_score)
    good = attempted & (best_score < zmssd_max)

    res = lk.align_patches_pyramid(
        cur_pyr, search_level, ref_patch.reshape(C, s, s), best_px, good,
        iters=lk_iters, max_shift=8.0)
    bearing_cur = cam.unproject(intr, res.xy)
    depth = geometry.depth_from_triangulation(
        T_cur_ref, m.cand_bearing, bearing_cur)
    ok = good & res.converged & (depth > 1e-4)
    if use_orb:
        desc_cur = orb.descriptors(cur_pyr[0], res.xy, radius=orb_radius)
        dist = orb.hamming(desc_cur, m.cand_desc)
        ok = ok & (dist < orb_max_dist)
    return EpipolarResult(px=res.xy, ok=ok, depth_anchor=depth,
                          attempted=attempted)
