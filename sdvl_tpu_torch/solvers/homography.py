"""Two-view homography estimation + Faugeras decomposition, batched.

Counterpart of ``sdvl_tpu/solvers/homography.py``: a 4-point DLT RANSAC on
unit-plane coordinates whose hypotheses are one batch (the reference
``vmap``s them), weighted-DLT refinement, the Faugeras-Lustman SVD
decomposition into 8 (R, t, n) candidates and their visibility/Sampson
scoring. RANSAC takes its Gumbel noise as an argument.

The ``eigh`` and the SVD are ``ops/cuda/small_eig.py``'s: on the card a
kernel that reads nothing back (``torch.linalg``'s read cuSOLVER's status
on the host), on the CPU ``torch.linalg`` itself. Eigenvector and
singular-vector signs are not unique and differ between LAPACK, cuSOLVER
and the kernel; nothing below depends on them: H is normalised by its
(3, 3) entry, and a sign flip of a singular-vector pair permutes the 8
candidates among themselves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import const
from ..core import geometry, se3
from ..ops.cuda import small_eig


def dlt_homography(uv_a: torch.Tensor, uv_b: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Weighted DLT: H such that uv_b ~ H uv_a (unit-plane homogeneous),
    from the smallest eigenvector of the weighted 9x9 ``A^T A``.
    ``weights`` is (..., N): leading dimensions are independent problems,
    solved in one batched ``eigh`` (``small_eig.eigh``). Returns (..., 3,
    3)."""
    x, y = uv_a[:, 0], uv_a[:, 1]
    xp, yp = uv_b[:, 0], uv_b[:, 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp], -1)
    A = torch.cat([r1, r2], dim=0)                         # (2N, 9)
    w = torch.cat([weights, weights], dim=-1)              # (..., 2N)
    AtA = torch.einsum("ni,nj,...n->...ij", A, A, w)
    _, v = small_eig.eigh(AtA)
    H = v[..., :, 0].reshape(v.shape[:-2] + (3, 3))
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12),
                           h22)


def transfer_error(H: torch.Tensor, uv_a: torch.Tensor,
                   uv_b: torch.Tensor) -> torch.Tensor:
    """Forward transfer error |H a - b| on the unit plane; H may carry
    leading batch dimensions, giving (..., N)."""
    ha = torch.cat([uv_a, torch.ones_like(uv_a[:, :1])], -1)
    hb = torch.einsum("...ij,nj->...ni", H, ha)
    w = hb[..., 2:3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    d = hb[..., :2] / w - uv_b
    return torch.sqrt(torch.sum(d * d, dim=-1))


def ransac_homography(uv_a: torch.Tensor, uv_b: torch.Tensor,
                      valid: torch.Tensor, gumbel: torch.Tensor,
                      thresh: float = 2.0 / 525.0, refine_iters: int = 2):
    """Fixed-shape RANSAC + weighted-DLT refinement.

    ``gumbel`` (n_hyp, N) is standard Gumbel noise, one row per hypothesis:
    each row picks 4 distinct valid correspondences. All hypotheses are
    fitted and scored at once; the first best one is refined on its inliers
    ``refine_iters`` times. Returns (H (3, 3), inlier mask (N,)).
    """
    n_hyp, N = gumbel.shape
    idx = geometry.sample_without_replacement(gumbel, valid, 4)   # (n_hyp, 4)
    w = torch.zeros((n_hyp, N), dtype=torch.float32, device=uv_a.device)
    w = w.scatter(1, idx, 1.0)
    Hs = dlt_homography(uv_a, uv_b, w)                              # (n_hyp,3,3)
    err = transfer_error(Hs, uv_a, uv_b)                            # (n_hyp, N)
    scores = torch.sum((err < thresh) & valid, dim=-1)
    H = Hs.index_select(0, torch.argmax(scores).reshape(1))[0]

    inl = valid & (transfer_error(H, uv_a, uv_b) < thresh)
    for _ in range(refine_iters):
        H = dlt_homography(uv_a, uv_b, inl.float())
        inl = valid & (transfer_error(H, uv_a, uv_b) < thresh)
    return H, inl


class Decomposition(NamedTuple):
    R: torch.Tensor  # (8, 3, 3)
    t: torch.Tensor  # (8, 3)
    n: torch.Tensor  # (8, 3)
    d: torch.Tensor  # (8,)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no factorisation, no host
    check)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _mat3(*entries) -> torch.Tensor:
    """(4, 3, 3) matrices from 9 row-major entries, each (4,) or ()."""
    e = torch.broadcast_tensors(*entries)
    return torch.stack(e, -1).reshape(e[0].shape + (3, 3))


def decompose_homography(H: torch.Tensor) -> Decomposition:
    """Faugeras-Lustman SVD decomposition into 8 (R, t, n) candidates: both
    the d' > 0 and d' < 0 families with the four epsilon sign combinations.
    Degenerate (near-equal singular value) cases give harmless duplicates
    rather than branches."""
    U, S, Vt = small_eig.svd3(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = _det3(U) * _det3(Vt)
    V = Vt.T
    dev = H.device

    d2sq = d2 * d2
    denom = (d1 - d3).clamp_min(1e-12) * (d1 + d3).clamp_min(1e-12)
    aux1 = torch.sqrt(((d1 * d1 - d2sq) / denom).clamp_min(0.0))
    aux3 = torch.sqrt(((d2sq - d3 * d3) / denom).clamp_min(0.0))

    e1 = const((1.0, 1.0, -1.0, -1.0), torch.float32, dev)
    e3 = const((1.0, -1.0, 1.0, -1.0), torch.float32, dev)
    x1 = e1 * aux1
    x3 = e3 * aux3
    zero = torch.zeros_like(x1)
    root = torch.sqrt(((d1 * d1 - d2sq) * (d2sq - d3 * d3)).clamp_min(0.0))

    # --- d' = +d2 family ---
    aux_st = root / ((d1 + d3) * d2).clamp_min(1e-12)
    st = e1 * e3 * aux_st
    ct = (d2sq + d1 * d3) / ((d1 + d3) * d2).clamp_min(1e-12)
    one = torch.ones_like(x1)
    Rp = _mat3(ct, zero, -st, zero, one, zero, st, zero, ct)
    tp = torch.stack([x1, zero, -x3], -1) * (d1 - d3)
    np_ = torch.stack([x1, zero, x3], -1)
    R_pos = s * torch.einsum("ij,njk,lk->nil", U, Rp, V)
    t_pos = torch.einsum("ij,nj->ni", U, tp)
    n_pos = torch.einsum("ij,nj->ni", V, np_)
    d_pos = (s * d2).expand(4)

    # --- d' = -d2 family ---
    aux_sp = root / ((d1 - d3) * d2).clamp_min(1e-12)
    sp = e1 * e3 * aux_sp
    cp = (d1 * d3 - d2sq) / ((d1 - d3) * d2).clamp_min(1e-12)
    Rn = _mat3(cp, zero, sp, zero, -one, zero, sp, zero, -cp)
    tn = torch.stack([x1, zero, x3], -1) * (d1 + d3)
    R_neg = s * torch.einsum("ij,njk,lk->nil", U, Rn, V)
    t_neg = torch.einsum("ij,nj->ni", U, tn)
    d_neg = (-s * d2).expand(4)

    return Decomposition(
        R=torch.cat([R_pos, R_neg]),
        t=torch.cat([t_pos, t_neg]),
        n=torch.cat([n_pos, n_pos]),
        d=torch.cat([d_pos, d_neg]),
    )


def choose_decomposition(dec: Decomposition, uv_a: torch.Tensor,
                         uv_b: torch.Tensor, weights: torch.Tensor):
    """Pick the (R, t) with the most in-front-of-both-cameras votes, ties by
    the smaller Sampson score (combined into one key, the first best wins).
    Returns (pose_b_a (7,) with unit-norm t, votes of the winner)."""
    ha = torch.cat([uv_a, torch.ones_like(uv_a[:, :1])], -1)     # (N, 3)
    # visibility: point on plane n.x = d; depth in a: d / (n . ray)
    denom = torch.einsum("cj,nj->cn", dec.n, ha)
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    depth_a = dec.d[:, None] / denom                              # (8, N)
    p_a = ha[None] * depth_a[..., None]                           # (8, N, 3)
    p_b = torch.einsum("cij,cnj->cni", dec.R, p_a) + dec.t[:, None]
    front = (p_a[..., 2] > 0) & (p_b[..., 2] > 0)
    votes = torch.sum(front * weights, dim=-1)                    # (8,)
    E = se3.hat(dec.t) @ dec.R
    samps = torch.sum(geometry.sampson_error_unit_plane(
        E[:, None], uv_a[None], uv_b[None]) * weights, dim=-1)
    key = votes - samps / (torch.max(samps) + 1e-12)
    best = torch.argmax(key).reshape(1)
    R = dec.R.index_select(0, best)[0]
    t = dec.t.index_select(0, best)[0]
    tn = t / torch.sqrt(torch.sum(t * t)).clamp_min(1e-12)
    return se3.from_rt(R, tn), votes.index_select(0, best)[0]
