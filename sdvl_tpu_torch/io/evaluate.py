"""Trajectory evaluation: Umeyama alignment, ATE-RMSE, RPE.

The port's own copy of ``sdvl_tpu/io/evaluate.py`` (NumPy, with the port's
``core.se3`` on CPU tensors where poses are composed). Standard
definitions: ATE after Sim(3) (monocular) or SE(3) alignment; RPE over fixed
frame deltas.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst, (N,3) each.

    Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after alignment. Positions (N,3)."""
    s, R, t = umeyama(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(aligned - gt_pos, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe(est_pos: np.ndarray, gt_pos: np.ndarray, delta: int = 1) -> float:
    """Positional drift RMSE over ``delta`` frames (translation deltas
    only — a cheap drift gate, NOT the TUM RPE; use :func:`rpe_tum` for
    the standard per-pair relative-transform metric)."""
    d_est = est_pos[delta:] - est_pos[:-delta]
    d_gt = gt_pos[delta:] - gt_pos[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_tum(est_wc: np.ndarray, gt_wc: np.ndarray, delta: int = 1,
            scale: float = 1.0, idx: np.ndarray | None = None) -> dict:
    """TUM-benchmark RPE: per-pair relative-transform error, translation
    AND rotation (the external ``rpe.py`` the reference defers to,
    SURVEY.md §6).

    For cam->world poses ``P`` (est) and ``Q`` (gt), each pair (i, i+delta)
    scores ``E_i = (Q_i^-1 Q_{i+delta})^-1 (P_i^-1 P_{i+delta})``;
    translational error is ``||trans(E_i)||``, rotational error the angle
    of ``rot(E_i)``. Inputs here are world->cam (N, 7) arrays (the
    pipeline's native convention), for which
    ``P_i^-1 P_{i+delta} = W_i ∘ W_{i+delta}^-1``.

    ``scale`` rescales the estimated relative translations (monocular
    gauge — pass the Umeyama scale from the ATE alignment; rotation is
    scale-free). ``idx`` gives each row's original frame index: only pairs
    whose indices differ by exactly ``delta`` count (gaps from lost or
    unassociated frames must not be charged as ``delta``-frame drift).

    Returns ``{"rpe_trans": m, "rpe_rot_deg": deg, "n_pairs": n}`` (RMSE
    over pairs) or an empty dict when no valid pair exists.
    """
    est = _t(est_wc)
    gt = _t(gt_wc)
    if est.shape[0] <= delta:
        return {}
    rel_est = se3.compose(est[:-delta], se3.inverse(est[delta:]))
    rel_gt = se3.compose(gt[:-delta], se3.inverse(gt[delta:]))
    rel_est = torch.cat(
        [rel_est[:, :4], rel_est[:, 4:7] * float(np.float32(scale))], dim=-1
    )
    E = se3.compose(se3.inverse(rel_gt), rel_est).numpy()
    t_err = np.linalg.norm(E[:, 4:7], axis=-1)
    q = E[:, :4]  # (w, x, y, z)
    r_err = 2.0 * np.arctan2(np.linalg.norm(q[:, 1:], axis=-1),
                             np.abs(q[:, 0]))
    if idx is not None:
        idx = np.asarray(idx)
        keep = (idx[delta:] - idx[:-delta]) == delta
        t_err, r_err = t_err[keep], r_err[keep]
    if len(t_err) == 0:
        return {}
    return {
        "rpe_trans": float(np.sqrt(np.mean(t_err ** 2))),
        "rpe_rot_deg": float(np.degrees(np.sqrt(np.mean(r_err ** 2)))),
        "n_pairs": int(len(t_err)),
    }


def positions_from_poses(poses_wc: np.ndarray) -> np.ndarray:
    """Camera centers from world->cam pose arrays (N, 7)."""
    return se3.translation(se3.inverse(_t(poses_wc))).numpy()


def rebase_trajectory(traj_wc: np.ndarray, frame_ids: np.ndarray,
                      kf_frame_ids: np.ndarray, kf_old: np.ndarray,
                      kf_new: np.ndarray, kf_valid: np.ndarray) -> np.ndarray:
    """Propagate keyframe pose corrections (e.g. from global BA) to every
    frame of a trajectory.

    Each frame f keeps its tracked pose *relative to* the most recent
    keyframe k at-or-before it — the quantity the front-end actually
    estimated — and inherits k's correction:

        T_f_new = (T_f_old ∘ T_k_old^{-1}) ∘ T_k_new

    (world->cam convention throughout). Frames before the first keyframe
    are left untouched.
    """
    traj = np.asarray(traj_wc, np.float32)
    frame_ids = np.asarray(frame_ids, np.int64)
    valid = np.asarray(kf_valid, bool)
    kf_ids = np.asarray(kf_frame_ids, np.int64)[valid]
    old = np.asarray(kf_old, np.float32)[valid]
    new = np.asarray(kf_new, np.float32)[valid]
    if kf_ids.size == 0:
        return traj
    order = np.argsort(kf_ids)
    kf_ids, old, new = kf_ids[order], old[order], new[order]

    # most recent keyframe at-or-before each frame; -1 = none yet
    anchor = np.searchsorted(kf_ids, frame_ids, side="right") - 1
    has = anchor >= 0
    a = np.clip(anchor, 0, len(kf_ids) - 1)

    delta = se3.compose(se3.inverse(_t(old[a])), _t(new[a]))
    rebased = se3.compose(_t(traj), delta).numpy()
    return np.where(has[:, None], rebased, traj)


def associate(stamps_est, stamps_gt, max_dt: float = 0.02):
    """Nearest-timestamp association (the TUM benchmark's associate.py
    semantics): for each estimate timestamp, the closest ground-truth
    timestamp within ``max_dt`` seconds. Returns (idx_est, idx_gt)."""
    est = np.asarray(stamps_est, np.float64)
    gt = np.asarray(stamps_gt, np.float64)
    ia, ib = [], []
    for i, t in enumerate(est):
        j = int(np.searchsorted(gt, t))
        cands = [k for k in (j - 1, j) if 0 <= k < len(gt)]
        if not cands:
            continue
        best = min(cands, key=lambda k: abs(gt[k] - t))
        if abs(gt[best] - t) <= max_dt:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
