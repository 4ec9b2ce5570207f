"""Bayesian inverse-depth filter: candidate seeding, update, promotion.

Counterpart of ``sdvl_tpu/pipeline/depth_filter.py``: the Vogiatzis
Beta x Gaussian inverse-depth model, the one-pixel epipolar error angle tau,
convergence and failure-based deletion. The whole candidate table updates as
elementwise tensor ops after one batched epipolar search.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import camera as cam
from ..core import geometry, se3
from ..ops import fast as fast_ops
from ..ops import interp, orb
from ..state.map_state import (MapState, alloc_slots, best_connections,
                               scatter)
from .matcher import EpipolarResult, epipolar_search

# sqrt(2 pi) rounded as the reference computes it (float32 sqrt of float32)
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * np.pi)))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def compute_tau(T_ref_cur_t: torch.Tensor, bearing: torch.Tensor,
                z: torch.Tensor, px_error_angle: float) -> torch.Tensor:
    """Depth measurement std dev from one pixel of epipolar error
    (law-of-sines construction); ``T_ref_cur_t`` is the translation from
    anchor to current camera in anchor coordinates."""
    t = T_ref_cur_t
    tn = _norm(t).clamp_min(1e-9)
    a = bearing * z[..., None] - t
    an = _norm(a).clamp_min(1e-9)
    alpha = torch.arccos((torch.sum(bearing * t, -1) / tn).clamp(-1, 1))
    beta = torch.arccos((-torch.sum(a * t, -1) / (an * tn)).clamp(-1, 1))
    beta_plus = beta + px_error_angle
    gamma = math.pi - alpha - beta_plus
    z_plus = tn * torch.sin(beta_plus) / torch.sin(gamma).clamp_min(1e-6)
    return (z_plus - z).abs()


def vogiatzis_update(rho, sigma2, a, b, x, tau2, rho_range):
    """One Beta x Gaussian inverse-depth filter step. ``x`` is the
    inverse-depth measurement, ``tau2`` its variance, ``rho_range`` the
    uniform-outlier support. All arguments broadcast."""
    norm_scale = torch.sqrt(sigma2 + tau2).clamp_min(1e-12)
    s2 = 1.0 / (1.0 / sigma2.clamp_min(1e-12) + 1.0 / tau2.clamp_min(1e-12))
    mm = s2 * (rho / sigma2.clamp_min(1e-12) + x / tau2.clamp_min(1e-12))
    gauss = torch.exp(-0.5 * ((x - rho) / norm_scale) ** 2) / (
        norm_scale * _SQRT_2PI)
    c1 = a / (a + b) * gauss
    c2 = b / (a + b) / rho_range.clamp_min(1e-12)
    norm = (c1 + c2).clamp_min(1e-12)
    c1, c2 = c1 / norm, c2 / norm

    f = c1 * (a + 1.0) / (a + b + 1.0) + c2 * a / (a + b + 1.0)
    e = (
        c1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
        + c2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))
    )
    rho_new = c1 * mm + c2 * rho
    sigma2_new = (
        c1 * (s2 + mm * mm) + c2 * (sigma2 + rho * rho) - rho_new * rho_new
    )
    # numerator and denominator are both typically negative: guard the
    # magnitude only, never the sign
    denom = f - e / f.clamp_min(1e-12)
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-12),
                       torch.full_like(denom, 1e-12))
    denom = torch.where(denom.abs() < 1e-12, tiny, denom)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / f.clamp_min(1e-12)
    return (rho_new, sigma2_new.clamp_min(1e-12), a_new.clamp_min(1e-4),
            b_new.clamp_min(1e-4))


def _anchor_poses(m: MapState) -> torch.Tensor:
    return m.kf_pose[m.cand_kf.clamp(0, m.kf_valid.shape[0] - 1)]


def update_candidates(m: MapState, intr, cur_pyr, pose_cur: torch.Tensor,
                      n_samples: int = 32, max_failed: int = 15,
                      use_orb: bool = False, patch_half: int = 4,
                      lk_iters: int = 8, orb_radius: int = 15,
                      stale_kf_window: int = 10,
                      map_scale: float = 1.0,
                      scale_min_dist: float = 0.25,
                      corner_gate: bool = False,
                      corner_thresh: float = 50.0) -> MapState:
    """Epipolar-match every candidate and update its depth filter.

    Match -> triangulate -> Bayesian update; misses bump the fail counter;
    candidates with more evidence for outlier than inlier (b > 2a after
    warm-up) or too many failures are freed. A near-zero baseline relative
    to the scene depth skips the attempt (no failure counted); a successful
    match does not update on ~zero parallax or a too-close triangulation.
    The scene depth is the median depth of valid map points in front of
    this camera that project in-image, else the candidate's own depth.
    Candidates invisible from this frame whose anchor keyframe is
    ``stale_kf_window`` keyframes old or more age out.
    """
    res: EpipolarResult = epipolar_search(
        m, intr, cur_pyr, pose_cur, n_samples=n_samples, use_orb=use_orb,
        half=patch_half, lk_iters=lk_iters, orb_radius=orb_radius,
        corner_gate=corner_gate, corner_thresh=corner_thresh,
    )

    apose = _anchor_poses(m)
    T_cur_ref = se3.compose(pose_cur[None], se3.inverse(apose))
    # translation anchor->cur expressed in the anchor frame
    t_ref = se3.translation(se3.inverse(T_cur_ref))
    z = res.depth_anchor.clamp_min(1e-6)
    tau = compute_tau(t_ref, m.cand_bearing, z, cam.pixel_error_angle(intr))
    # depth variance -> inverse-depth variance
    tau_inv = 0.5 * (1.0 / (z - tau).clamp_min(1e-6) - 1.0 / (z + tau))
    x = 1.0 / z
    rho_range = m.cand_rho + 4.0 * torch.sqrt(m.cand_sigma2)

    rho_n, sig_n, a_n, b_n = vogiatzis_update(
        m.cand_rho, m.cand_sigma2, m.cand_a, m.cand_b,
        x, tau_inv * tau_inv, rho_range,
    )
    depth_cand = 1.0 / m.cand_rho.clamp_min(1e-6)
    p_cam_all = se3.transform(pose_cur[None], m.pt_pos)
    H0, W0 = cur_pyr[0].shape
    px_all = cam.project(intr, p_cam_all)
    vis_pt = (m.pt_valid & (p_cam_all[:, 2] > 1e-6)
              & (px_all[:, 0] >= 0) & (px_all[:, 0] < W0)
              & (px_all[:, 1] >= 0) & (px_all[:, 1] < H0))
    depth_scene = geometry.masked_median(p_cam_all[:, 2], vis_pt)
    scale_depth = torch.where(depth_scene > 1e-6, depth_scene, depth_cand)
    baseline_ok = (_norm(t_ref) / scale_depth.clamp_min(1e-6)) >= 0.01
    anchor_pos = se3.translation(se3.inverse(apose))
    cur_pos = se3.translation(se3.inverse(pose_cur))
    p_world = se3.transform(se3.inverse(apose), m.cand_bearing * z[:, None])
    cosa = geometry.parallax_cosine(p_world, anchor_pos, cur_pos[None])
    deep_enough = ((z >= map_scale * scale_min_dist)
                   & (z >= scale_depth * scale_min_dist))
    upd = (res.ok & m.cand_valid & baseline_ok
           & (cosa < 0.999999) & deep_enough)
    # a gated-out attempt is a skip, not a failure
    miss = res.attempted & baseline_ok & ~res.ok
    m = m._replace(
        cand_rho=torch.where(upd, rho_n, m.cand_rho),
        cand_sigma2=torch.where(upd, sig_n, m.cand_sigma2),
        cand_a=torch.where(upd, a_n, m.cand_a),
        cand_b=torch.where(upd, b_n, m.cand_b),
        cand_fail=torch.where(upd, torch.zeros_like(m.cand_fail),
                              m.cand_fail + miss.to(torch.int32)),
    )
    n_upd = m.cand_a + m.cand_b
    bad = (m.cand_fail > max_failed) | ((n_upd > 20)
                                        & (m.cand_b > 2 * m.cand_a))
    # aging: invisible from this frame AND anchored >= stale_kf_window
    # keyframes ago (rank by kf_frame_id among valid keyframes)
    anchor_fid = m.kf_frame_id[m.cand_kf.clamp(0, m.kf_valid.shape[0] - 1)]
    newer = torch.sum(
        (m.kf_frame_id[None, :] > anchor_fid[:, None]) & m.kf_valid[None, :],
        dim=1,
    )
    stale = m.cand_valid & ~res.attempted & (newer >= stale_kf_window)
    return m._replace(cand_valid=m.cand_valid & ~bad & ~stale)


def promote_converged(m: MapState, threshold_converged: float = 0.1,
                      min_inlier_ratio: float = 0.6) -> MapState:
    """Move converged candidates into the point store: the depth interval
    spanned by +-2 sigma in inverse depth, relative to the depth, must
    shrink below the threshold, and the Beta inlier ratio must support
    it."""
    sigma = torch.sqrt(m.cand_sigma2)
    z = 1.0 / m.cand_rho.clamp_min(1e-6)
    z_min = 1.0 / (m.cand_rho + 2 * sigma)
    z_max = 1.0 / (m.cand_rho - 2 * sigma).clamp_min(1e-6)
    ratio = m.cand_a / (m.cand_a + m.cand_b).clamp_min(1e-6)
    converged = (
        m.cand_valid
        & ((z_max - z_min) / z < threshold_converged)
        & (ratio > min_inlier_ratio)
        & (m.cand_rho > 1e-6)
    )

    slots, ok = alloc_slots(~m.pt_valid, converged)
    p_anchor = m.cand_bearing * z[:, None]
    p_world = se3.transform(se3.inverse(_anchor_poses(m)), p_anchor)
    return m._replace(
        pt_pos=scatter(m.pt_pos, slots, p_world),
        pt_valid=scatter(m.pt_valid, slots, True),
        pt_anchor_kf=scatter(m.pt_anchor_kf, slots, m.cand_kf),
        pt_fail=scatter(m.pt_fail, slots, 0),
        pt_found=scatter(m.pt_found, slots, 1),
        pt_desc=scatter(m.pt_desc, slots, m.cand_desc),
        obs_mask=scatter(m.obs_mask, (m.cand_kf, slots), True),
        obs_px=scatter(m.obs_px, (m.cand_kf, slots), m.cand_px),
        obs_level=scatter(m.obs_level, (m.cand_kf, slots), m.cand_level),
        cand_valid=m.cand_valid & ~ok,
    )


def seed_candidates(m: MapState, intr, fs_pyr, fs_corners,
                    kf_slot: torch.Tensor, scene_depth_median: torch.Tensor,
                    cell: int, orb_radius: int = 15):
    """Seed new candidates at detected corners of a new keyframe: corners
    in cells not already holding an observation of that keyframe become
    inverse-depth seeds at rho = 1 / median scene depth with a wide prior.
    Returns ``(m, new_mask (C,))``; pass ``new_mask`` to
    :func:`triangulate_new_seeds`."""
    corner_xy, corner_level, corner_valid = fs_corners
    H, W = fs_pyr[0].shape
    desc = orb.descriptors(fs_pyr[0], corner_xy, radius=orb_radius)

    # suppress cells already occupied by observations of this keyframe
    occ = fast_ops.occupied_cells(
        interp.take_row(m.obs_px, kf_slot), interp.take_row(m.obs_mask,
                                                            kf_slot),
        H, W, cell)
    gw = W // cell
    ccx = fast_ops._cell_index(corner_xy[:, 0], cell, gw)
    ccy = fast_ops._cell_index(corner_xy[:, 1], cell, H // cell)
    new_valid = corner_valid & ~occ[ccy * gw + ccx]

    slots, _ok = alloc_slots(~m.cand_valid, new_valid)
    rho0 = 1.0 / scene_depth_median.clamp_min(1e-6)
    sigma0 = rho0 / 3.0  # ~95% mass within (0, ~1.7*rho0]: wide prior
    bearing = cam.unproject(intr, corner_xy)

    n = corner_xy.shape[0]
    f32 = torch.float32
    new_mask = scatter(torch.zeros_like(m.cand_valid), slots, True)
    m = m._replace(
        cand_valid=scatter(m.cand_valid, slots, True),
        cand_kf=scatter(m.cand_kf, slots, kf_slot.reshape(1).expand(n)),
        cand_px=scatter(m.cand_px, slots, corner_xy),
        cand_level=scatter(m.cand_level, slots, corner_level),
        cand_bearing=scatter(m.cand_bearing, slots, bearing),
        cand_rho=scatter(m.cand_rho, slots, rho0.to(f32).expand(n)),
        cand_sigma2=scatter(m.cand_sigma2, slots,
                            (sigma0 * sigma0).to(f32).expand(n)),
        cand_a=scatter(m.cand_a, slots, 10.0),
        cand_b=scatter(m.cand_b, slots, 10.0),
        cand_fail=scatter(m.cand_fail, slots, 0),
        cand_desc=scatter(m.cand_desc, slots, desc),
    )
    return m, new_mask


def triangulate_new_seeds(m: MapState, intr, anchor_slot: torch.Tensor,
                          scene_depth_median: torch.Tensor,
                          new_mask: torch.Tensor, n_samples: int = 32,
                          n_best: int = 5, scale_min_dist: float = 0.25,
                          map_scale: float = 1.0,
                          use_orb: bool = False, patch_half: int = 4,
                          lk_iters: int = 8,
                          orb_radius: int = 15,
                          corner_gate: bool = False,
                          corner_thresh: float = 50.0) -> MapState:
    """Re-center fresh seeds at a triangulated depth.

    Each new seed is epipolar-matched against the first of the best
    covisible keyframes with enough baseline (distance / depth >= 0.01);
    on success its filter re-initializes at rho = 1 / triangulated depth.
    Near-zero parallax is rejected, too-close points are dropped, and
    unmatched seeds keep the median-depth prior.
    """
    n_best = min(n_best, m.kf_valid.shape[0])
    conn_idx, conn_counts = best_connections(m, anchor_slot, n_best)
    anchor_pos = se3.translation(se3.inverse(
        interp.take_row(m.kf_pose, anchor_slot)))
    kf_pos = se3.translation(se3.inverse(m.kf_pose[conn_idx]))
    dist = _norm(kf_pos - anchor_pos)
    depth_med = scene_depth_median.clamp_min(1e-6)
    ok_kf = ((conn_counts > 0) & m.kf_valid[conn_idx]
             & (dist / depth_med >= 0.01))
    any_ok = torch.any(ok_kf)
    ref = conn_idx.index_select(0, torch.argmax(ok_kf.to(torch.uint8))
                                .reshape(1))[0]

    ref_pyr = tuple(interp.take_row(p, ref) for p in m.kf_pyr)
    ref_pose = interp.take_row(m.kf_pose, ref)
    m_search = m._replace(cand_valid=new_mask & m.cand_valid)
    res = epipolar_search(m_search, intr, ref_pyr, ref_pose,
                          n_samples=n_samples, use_orb=use_orb,
                          half=patch_half, lk_iters=lk_iters,
                          orb_radius=orb_radius,
                          corner_gate=corner_gate,
                          corner_thresh=corner_thresh)

    z = res.depth_anchor.clamp_min(1e-6)
    p_anchor = m.cand_bearing * z[:, None]
    p_world = se3.transform(se3.inverse(_anchor_poses(m)), p_anchor)
    ref_pos = se3.translation(se3.inverse(ref_pose))
    cosa = geometry.parallax_cosine(p_world, anchor_pos, ref_pos)

    matched = new_mask & m.cand_valid & res.ok & any_ok
    min_depth = scale_min_dist * depth_med.clamp_min(map_scale)
    deep_enough = z > min_depth
    good = matched & deep_enough & (cosa < 0.999999)
    too_close = matched & ~deep_enough

    rho_t = 1.0 / z
    sigma_t = rho_t / 3.0
    return m._replace(
        cand_rho=torch.where(good, rho_t, m.cand_rho),
        cand_sigma2=torch.where(good, sigma_t * sigma_t, m.cand_sigma2),
        cand_valid=m.cand_valid & ~too_close,
    )
