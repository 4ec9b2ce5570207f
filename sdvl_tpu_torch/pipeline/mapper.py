"""Map maintenance: keyframe insertion, candidate updates, local and global
BA, pruning.

Counterpart of ``sdvl_tpu/pipeline/mapper.py``: each function is a pure
``MapState -> MapState`` map (out-of-place tensor updates), run inline with
tracking by the SLAM step, on the async mapper's thread, or (global BA)
once at the end of a run.

Scatters with repeated indices, where the reference relies on what XLA does
with them:

* ``.at[].add`` adds up repeats: ``scatter(..., accumulate=True)``.
* ``.at[].min`` of a mask over repeats: the AND of all writes, computed as
  an accumulated count of the removals.
* ``.at[].set`` of keyframe poses after local BA: the window can hold one
  slot twice (the centre again among zero-covisibility fill-ins, held
  fixed), and XLA on the CPU applies updates in order, so the LAST write of
  a slot wins. The port writes exactly those (deterministic on any device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import geometry, se3
from ..solvers import ba
from ..state.map_state import (MapState, best_connections, kf_slot_to_evict,
                               scatter, set_row, store_pyramid)
from . import depth_filter, matcher


def add_keyframe(m: MapState, intr, pyr, pose: torch.Tensor,
                 frame_id: torch.Tensor, match_pt_idx: torch.Tensor,
                 match_px: torch.Tensor, match_ok: torch.Tensor,
                 match_level: torch.Tensor,
                 corners_xy: torch.Tensor, corners_level: torch.Tensor,
                 corners_valid: torch.Tensor, cell: int,
                 n_search_kf: int = 5, max_reobs: int = 512,
                 scale_min_dist: float = 0.25, map_scale: float = 1.0,
                 use_orb: bool = False, epipolar_samples: int = 32,
                 patch_half: int = 4, lk_iters: int = 8,
                 orb_radius: int = 15,
                 corner_gate: bool = False,
                 corner_thresh: float = 50.0):
    """Insert the current frame as a keyframe; returns ``(m, slot)``.

    Stores the pyramid (uint8) and pose, writes the frame's matches as
    observations, re-links existing points seen by covisible keyframes,
    seeds depth-filter candidates in unoccupied grid cells and re-centers
    them at triangulated depths. If the keyframe store is full the furthest
    keyframe is evicted: its observation row, anchored candidates and
    anchored points die with it.
    """
    K, P, C = m.capacities

    cur_pos = se3.translation(se3.inverse(pose))
    evict = kf_slot_to_evict(m, cur_pos)
    full = torch.sum(~m.kf_valid) == 0
    first_free = torch.argmax((~m.kf_valid).to(torch.uint8))
    slot = torch.where(full, evict, first_free)

    # clear any state anchored to the slot being reused
    m = m._replace(
        obs_mask=set_row(m.obs_mask, slot, False),
        cand_valid=m.cand_valid & (m.cand_kf != slot),
        pt_valid=m.pt_valid & ~(full & (m.pt_anchor_kf == slot)),
        n_evicted=m.n_evicted + full.to(torch.int32),
    )

    m = m._replace(
        kf_pose=set_row(m.kf_pose, slot, pose),
        kf_valid=set_row(m.kf_valid, slot, True),
        kf_frame_id=set_row(m.kf_frame_id, slot, frame_id),
        kf_pyr=tuple(set_row(lvl, slot, img)
                     for lvl, img in zip(m.kf_pyr, store_pyramid(pyr))),
        n_keyframes=m.n_keyframes + 1,
    )

    # observations from this frame's matches
    idx = torch.where(match_ok & m.pt_valid[match_pt_idx], match_pt_idx,
                      torch.full_like(match_pt_idx, P))
    m = m._replace(
        obs_mask=scatter(m.obs_mask, (slot, idx), True),
        obs_px=scatter(m.obs_px, (slot, idx), match_px),
        obs_level=scatter(m.obs_level, (slot, idx), match_level),
    )

    # median scene depth of the matched points
    p_cam = se3.transform(pose[None], m.pt_pos[match_pt_idx])
    depth_med = geometry.masked_median(
        p_cam[:, 2], match_ok & (p_cam[:, 2] > 1e-6))
    depth_med = torch.where(depth_med > 1e-6, depth_med,
                            torch.ones_like(depth_med))

    # re-link existing points BEFORE seeding, so their cells count as
    # occupied; max_reobs=0 disables
    if max_reobs > 0:
        m = matcher.reobserve_points(
            m, intr, pyr, pose, slot, n_best=n_search_kf,
            max_reobs=max_reobs, half=patch_half, lk_iters=lk_iters)
    m, new_seeds = depth_filter.seed_candidates(
        m, intr, pyr, (corners_xy, corners_level, corners_valid), slot,
        depth_med, cell, orb_radius=orb_radius)
    m = depth_filter.triangulate_new_seeds(
        m, intr, slot, depth_med, new_seeds, n_samples=epipolar_samples,
        n_best=n_search_kf, scale_min_dist=scale_min_dist,
        map_scale=map_scale, use_orb=use_orb, patch_half=patch_half,
        lk_iters=lk_iters, orb_radius=orb_radius,
        corner_gate=corner_gate, corner_thresh=corner_thresh)
    return m, slot


def update_map(m: MapState, intr, cur_pyr, pose_cur: torch.Tensor,
               n_samples: int = 32, threshold_converged: float = 0.1,
               max_failed: int = 15, use_orb: bool = False,
               patch_half: int = 4, lk_iters: int = 8,
               orb_radius: int = 15,
               stale_kf_window: int = 10,
               map_scale: float = 1.0,
               scale_min_dist: float = 0.25,
               corner_gate: bool = False,
               corner_thresh: float = 50.0) -> MapState:
    """Per-frame mapper iteration: update every candidate's depth filter
    against this frame, promote the converged ones, and retire at most one
    redundant keyframe."""
    m = depth_filter.update_candidates(
        m, intr, cur_pyr, pose_cur, n_samples=n_samples,
        max_failed=max_failed, use_orb=use_orb, patch_half=patch_half,
        lk_iters=lk_iters, orb_radius=orb_radius,
        stale_kf_window=stale_kf_window,
        map_scale=map_scale, scale_min_dist=scale_min_dist,
        corner_gate=corner_gate, corner_thresh=corner_thresh,
    )
    m = depth_filter.promote_converged(m, threshold_converged)
    return check_redundant_keyframes(m)


class BAWindow(NamedTuple):
    kf_idx: torch.Tensor   # (Kw,) keyframe slots in window
    pt_idx: torch.Tensor   # (Pw,) point slots in window
    problem: ba.BAProblem


def extract_local_ba(m: MapState, intr, center_kf: torch.Tensor,
                     window: int = 10, max_points: int = 1024) -> BAWindow:
    """The fixed-capacity local BA problem around ``center_kf``: the center
    and its ``window`` best covisible keyframes, the points they observe at
    least twice (the ``max_points`` most observed; stable order), the two
    oldest valid window keyframes held fixed (the monocular gauge)."""
    Kw = window + 1
    dev = center_kf.device

    conn_idx, conn_counts = best_connections(m, center_kf, window)
    kf_idx = torch.cat([center_kf.reshape(1).long(), conn_idx])
    kf_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       conn_counts > 0]) & m.kf_valid[kf_idx]

    obs_win = m.obs_mask[kf_idx] & kf_ok[:, None]                # (Kw, P)
    n_obs = torch.sum(obs_win, dim=0)
    pt_ok = m.pt_valid & (n_obs >= 2)
    key = torch.where(pt_ok, -n_obs.float(),
                      torch.full_like(n_obs, float("inf"), dtype=torch.float32))
    pt_idx = torch.sort(key, stable=True)[1][:max_points]
    pt_sel_ok = pt_ok[pt_idx]

    obs_mask = obs_win[:, pt_idx].T & pt_sel_ok[:, None]          # (Pw, Kw)
    px = m.obs_px[kf_idx][:, pt_idx].transpose(0, 1)              # (Pw, Kw, 2)
    uv = torch.stack([
        (px[..., 0] - intr.cx) / intr.fx,
        (px[..., 1] - intr.cy) / intr.fy,
    ], -1)

    # fix the two oldest valid window keyframes (gauge incl. scale)
    age = torch.where(kf_ok, m.kf_frame_id[kf_idx],
                      torch.full_like(m.kf_frame_id[kf_idx],
                                      np.iinfo(np.int32).max))
    order_age = torch.sort(age, stable=True)[1]
    fixed = scatter(torch.zeros(Kw, dtype=torch.bool, device=dev),
                    order_age[:2], True)
    fixed = fixed | ~kf_ok

    problem = ba.BAProblem(
        poses=m.kf_pose[kf_idx],
        fixed=fixed,
        points=m.pt_pos[pt_idx],
        obs_uv=uv,
        obs_mask=obs_mask,
    )
    return BAWindow(kf_idx=kf_idx, pt_idx=pt_idx, problem=problem)


def huber_threshold(intr) -> float:
    """sqrt(5.991) pixels (95 % of chi2 with 2 dof) on the unit plane,
    rounded as the reference computes it in float32."""
    return float(np.sqrt(np.float32(5.991))
                 / np.float32(min(intr.fx, intr.fy)))


def local_ba(m: MapState, intr, center_kf: torch.Tensor, window: int = 10,
             max_points: int = 1024) -> MapState:
    """Local bundle adjustment + write-back; observations the BA gated out
    are removed from the map."""
    win = extract_local_ba(m, intr, center_kf, window, max_points)
    res = ba.solve(win.problem, huber=huber_threshold(intr))

    K = m.kf_valid.shape[0]
    kf_ok = ~win.problem.fixed
    new_kf_pose = torch.where(kf_ok[:, None], res.poses, win.problem.poses)
    # a slot listed twice: the later entry's write wins
    idx = win.kf_idx
    n = idx.shape[0]
    later = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=idx.device), diagonal=1)
    overwritten = torch.any((idx[:, None] == idx[None, :]) & later, dim=1)
    kf_write = torch.where(overwritten, torch.full_like(idx, K), idx)
    m = m._replace(
        kf_pose=scatter(m.kf_pose, kf_write, new_kf_pose),
        pt_pos=scatter(m.pt_pos, win.pt_idx, res.points),
    )
    # clear observations the BA gated out (min over repeated slots)
    removed = win.problem.obs_mask & ~res.inlier_mask           # (Pw, Kw)
    kill = scatter(torch.zeros(m.obs_mask.shape, dtype=torch.int32,
                               device=idx.device),
                   (win.kf_idx[None, :], win.pt_idx[:, None]),
                   removed.to(torch.int32), accumulate=True)
    return m._replace(obs_mask=m.obs_mask & (kill == 0))


def extract_global_ba(m: MapState, intr) -> ba.BAProblem:
    """Whole-map BA problem: every valid keyframe and every valid point
    seen by at least two of them. The map capacities are the problem's
    shape. Gauge: the two oldest valid keyframes are held fixed (equal ages
    keep slot order, a stable sort), and every empty slot."""
    K = m.kf_valid.shape[0]
    kf_ok = m.kf_valid
    pt_ok = m.pt_valid & (torch.sum(m.obs_mask & kf_ok[:, None], dim=0) >= 2)
    obs_mask = (m.obs_mask & kf_ok[:, None] & pt_ok[None, :]).T   # (P, K)
    uv = torch.stack([
        (m.obs_px[..., 0] - intr.cx) / intr.fx,
        (m.obs_px[..., 1] - intr.cy) / intr.fy,
    ], -1).transpose(0, 1)                                        # (P, K, 2)

    age = torch.where(kf_ok, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, np.iinfo(np.int32).max))
    oldest = torch.sort(age, stable=True)[1][:2]
    fixed = scatter(torch.zeros(K, dtype=torch.bool, device=age.device),
                    oldest, True) | ~kf_ok
    return ba.BAProblem(poses=m.kf_pose, fixed=fixed, points=m.pt_pos,
                        obs_uv=uv, obs_mask=obs_mask)


def global_ba(m: MapState, intr, mesh=None, stage_iters=(8, 12),
              axis: str = "point", graphs: Optional[bool] = None,
              stats: Optional[dict] = None) -> MapState:
    """Full-map bundle adjustment + write-back: poses of the free slots,
    positions of the valid points, and the observations the BA gated out
    removed. The reduced camera solve is dense Cholesky up to
    ``ba.CG_KF_THRESHOLD`` keyframe slots and PCG above. With a ``mesh``
    (``torch.distributed.device_mesh.DeviceMesh``), the point blocks are
    sharded over its ``axis`` and the reduced camera system all-reduced
    (``dist.ba_sharded.solve_sharded``); every rank of the axis calls it
    with the same map and gets the same result.

    On the card (``graphs`` None or True) the solve and the write-back are
    one replay of a CUDA graph captured over the map
    (``device_fsm.StageGraph``: its warm-up passes run each loop body once,
    its LM and CG loops are WHILE nodes), and nothing is read back before
    the result; ``graphs=False`` runs them eagerly. Over an nccl mesh the
    graph holds the collectives too: the all-reduces of the LM steps and
    the PCG in the WHILE bodies, the gather of the point rows at the top
    level; every rank captures and replays alike (the warm-up passes make
    the communicator before the capture). A gloo mesh runs eagerly: its
    collectives cannot be captured, and ``graphs=True`` with one raises.
    ``stats``, a dict, receives ``cg_iterations`` (the result's per-LM-step
    counts, a device tensor) and ``chi2``, and on the graph path the
    graph's ``capture_s``, ``pool_bytes`` and ``replays``."""
    gloo = (mesh is not None and torch.distributed.get_backend(
        mesh.get_group(mesh_dim=axis)) == "gloo")
    if gloo and graphs:
        raise ValueError("global_ba(mesh=...) over a gloo mesh runs "
                         "eagerly: gloo collectives cannot be captured in "
                         "a CUDA graph (graphs=True needs nccl)")
    if graphs is None:
        graphs = not gloo and m.kf_pose.is_cuda
    if graphs and not m.kf_pose.is_cuda:
        raise ValueError("graphs=True needs a CUDA device")

    def solve(map_):
        problem = extract_global_ba(map_, intr)
        if mesh is None:
            res = ba.solve(problem, huber=huber_threshold(intr),
                           stage_iters=tuple(stage_iters))
        else:
            from ..dist import ba_sharded

            res = ba_sharded.solve_sharded(
                problem, mesh, huber=huber_threshold(intr),
                stage_iters=tuple(stage_iters), axis=axis)
        free = ~problem.fixed
        removed = problem.obs_mask & ~res.inlier_mask             # (P, K)
        return (torch.where(free[:, None], res.poses, map_.kf_pose),
                torch.where(map_.pt_valid[:, None], res.points, map_.pt_pos),
                map_.obs_mask & ~removed.T, res.cg_iterations, res.chi2)

    if graphs:
        from .device_fsm import StageGraph, StepState

        g = StageGraph("global_ba", lambda st: solve(st.m),
                       StepState(m, None, inplace=True), (),
                       shared_map=True)
        out = tuple(t.clone() for t in g())
        if stats is not None:
            stats.update(capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                         replays=g.replays)
        del g
    else:
        out = solve(m)
    kf_pose, pt_pos, obs_mask, cg_iterations, chi2 = out
    if stats is not None:
        stats.update(cg_iterations=cg_iterations, chi2=chi2)
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos, obs_mask=obs_mask)


def prune_weak_points(m: MapState, min_obs: int = 2,
                      grace_keyframes: int = 2) -> MapState:
    """Drop points whose observation support collapsed (BA gating or
    keyframe eviction can orphan them); points anchored at recent keyframes
    get a grace period to gather observations."""
    K = m.kf_valid.shape[0]
    n_obs = torch.sum(m.obs_mask & m.kf_valid[:, None], dim=0)
    anchor_age = m.kf_frame_id[m.pt_anchor_kf.clamp(0, K - 1)]
    newest = torch.max(torch.where(m.kf_valid, m.kf_frame_id,
                                   torch.full_like(m.kf_frame_id, -1)))
    recent = anchor_age >= newest - grace_keyframes
    keep = (n_obs >= min_obs) | recent
    return m._replace(pt_valid=m.pt_valid & keep)


def check_redundant_keyframes(m: MapState) -> MapState:
    """Prune at most one keyframe whose observed points are >= 80 % also
    seen by >= 3 other keyframes at the same or finer scale (level <= its
    level + 1); the newest two are protected. Points anchored at the
    pruned keyframe move their anchor to their newest other observer (or
    die without one); its candidates die."""
    K, P, _ = m.capacities
    L = len(m.kf_pyr)
    dev = m.obs_mask.device
    obs_at = m.obs_mask & m.kf_valid[:, None] & m.pt_valid[None, :]
    lvls = torch.arange(L + 1, dtype=m.obs_level.dtype, device=dev)
    cnt_le = torch.sum(
        obs_at[None] & (m.obs_level[None] <= lvls[:, None, None]), dim=1
    )                                                            # (L+1, P)
    thr = (m.obs_level + 1).clamp(0, L)                          # (K, P)
    support = torch.gather(cnt_le, 0, thr) - 1                   # (K, P)
    redundant = obs_at & (support >= 3)
    per_kf_total = torch.sum(m.obs_mask & m.pt_valid[None, :], dim=1)
    per_kf_red = torch.sum(redundant, dim=1)
    frac = per_kf_red / per_kf_total.clamp_min(1)
    age = torch.where(m.kf_valid, m.kf_frame_id,
                      torch.full_like(m.kf_frame_id, -1))
    newest = torch.sort(-age, stable=True)[1][:2]
    protect = scatter(torch.zeros(K, dtype=torch.bool, device=dev), newest,
                      True)
    drop = m.kf_valid & (frac > 0.8) & (per_kf_total > 10) & ~protect
    first = torch.argmax(drop.to(torch.uint8))
    do = torch.any(drop)

    # re-home anchors before the obs row dies: newest OTHER observer wins
    slots = torch.arange(K, device=dev)
    obs_other = obs_at & (slots != first)[:, None]               # (K, P)
    alt_key = torch.where(obs_other, m.kf_frame_id[:, None],
                          torch.full_like(obs_other, -1, dtype=torch.int32))
    new_anchor = torch.argmax(alt_key, dim=0)                    # (P,)
    has_alt = torch.any(obs_other, dim=0)
    rehome = do & m.pt_valid & (m.pt_anchor_kf == first)
    pt_anchor_kf = torch.where(rehome & has_alt, new_anchor, m.pt_anchor_kf)
    pt_valid = m.pt_valid & ~(rehome & ~has_alt)

    is_first = slots == first
    kf_valid = m.kf_valid & ~(do & is_first)
    obs_mask = m.obs_mask & ~(do & is_first)[:, None]
    cand_valid = m.cand_valid & ~(do & (m.cand_kf == first))
    return m._replace(kf_valid=kf_valid, obs_mask=obs_mask,
                      cand_valid=cand_valid, pt_anchor_kf=pt_anchor_kf,
                      pt_valid=pt_valid,
                      n_pruned=m.n_pruned + do.to(torch.int32))


# the keyframe policy's shares of the matches at the last keyframe: a
# keyframe once this many are lost after min_keyframe_its frames, or once
# LOST_ANY are lost at all (map.cc:170-188)
LOST_AFTER_ITS, LOST_ANY = 0.1, 0.3


def keyframe_margin(n_matches: int, kf_matches: int, frames_since_kf: int,
                    min_keyframe_its: int = 30) -> float:
    """How far a tracked frame's keyframe decision (``need_keyframe``, on
    the carry's ``kf_matches`` and ``frames_since_kf`` before the frame,
    the latter already counting the frame) lies from flipping, in matches:
    negative where it inserts a keyframe (the matches it would have to
    gain), positive where it does not (the matches it would have to
    lose). A decision within a match or two of its threshold is a tie
    that float32 rounding of the match count can take either way."""
    k = max(float(kf_matches), 1.0)
    thresholds = [(1 - LOST_ANY) * k] + (
        [(1 - LOST_AFTER_ITS) * k] if frames_since_kf >= min_keyframe_its
        else [])
    below = [t - n_matches for t in thresholds if n_matches < t]
    return -max(below) if below else min(n_matches - t for t in thresholds)


def need_keyframe(n_matches, kf_matches, frames_since_kf,
                  min_keyframe_its: int = 30):
    """Keyframe policy: enough frames elapsed AND 10 % of the matches since
    the last keyframe lost, OR 30 % lost outright. On tensors (the step's)
    a () bool tensor; on host numbers (the host driver's) a bool, computed
    in float64 as the reference's host driver computes it."""
    if isinstance(kf_matches, torch.Tensor):
        kf_matches = kf_matches.float().clamp_min(1.0)
    else:
        kf_matches = max(float(kf_matches), 1.0)
    lost = 1.0 - n_matches / kf_matches
    return (((frames_since_kf >= min_keyframe_its) & (lost > LOST_AFTER_ITS))
            | (lost > LOST_ANY))


def transform_initial_map(m: MapState, gumbel: torch.Tensor,
                          dist_thresh: float = 0.1):
    """Move the world so the dominant plane of the initial map becomes
    z = 0 with the first camera on the +z side. ``gumbel`` (iters, P) is the
    plane RANSAC's noise. Returns ``(m', T_new_old (7,))``: apply ``T`` to
    external pose records with ``se3.compose(pose, se3.inverse(T))``."""
    (n, d), _inl = geometry.fit_plane_ransac(
        m.pt_pos, m.pt_valid, gumbel, thresh=dist_thresh)
    # orient the plane so the first camera (world origin) is above it
    flip = d < 0
    n = torch.where(flip, -n, n)
    d = torch.where(flip, -d, d)
    e3 = torch.zeros(3, dtype=torch.float32, device=n.device)
    e3[2:].fill_(1.0)
    R = geometry.rotation_between(n, e3)
    T = se3.from_rt(R, e3 * d)  # world_old -> world_new

    pt_pos = se3.transform(T[None], m.pt_pos)
    kf_pose = se3.compose(m.kf_pose, se3.inverse(T)[None])
    return m._replace(pt_pos=pt_pos, kf_pose=kf_pose), T
