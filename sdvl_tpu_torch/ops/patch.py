"""Affine patch warping between views, ZMSSD scoring and grid search.

Counterpart of ``sdvl_tpu/ops/patch.py``: the first-order affine warp and
the search level that map-point matching uses, the warped patch itself, the
zero-mean SSD scorer, and
the exhaustive integer-offset ZMSSD search that the two-view bootstrap runs
before LK.
"""

from __future__ import annotations

import torch

from ..core import camera as cam
from ..core import se3
from . import interp


def warp_matrix_affine(intr, px_ref: torch.Tensor, level_ref: torch.Tensor,
                       depth_ref: torch.Tensor, pose_cur_ref: torch.Tensor,
                       ) -> torch.Tensor:
    """First-order affine warp A_cur_ref (..., 2, 2) between views.

    Finite-difference construction: project the patch corner offsets
    (halfpatch+border px at the feature's level) through ref-depth into the
    current view and difference. ``pose_cur_ref`` maps ref-cam coords to
    cur-cam coords.
    """
    du = 5.0 * torch.exp2(level_ref.float())  # halfpatch+1 at level
    bearing_c = cam.unproject(intr, px_ref)
    xyz_ref = bearing_c * (depth_ref / bearing_c[..., 2])[..., None]

    def _project_offset(offset):
        b = cam.unproject(intr, px_ref + offset)
        xyz = b * (xyz_ref[..., 2] / b[..., 2])[..., None]
        return cam.project(intr, se3.transform(pose_cur_ref, xyz))

    zero = torch.zeros_like(du)
    px_cur = cam.project(intr, se3.transform(pose_cur_ref, xyz_ref))
    dx = (_project_offset(torch.stack([du, zero], -1)) - px_cur) / du[..., None]
    dy = (_project_offset(torch.stack([zero, du], -1)) - px_cur) / du[..., None]
    return torch.stack([dx, dy], dim=-1)  # columns: image-x / image-y derivs


def search_level_from_warp(A: torch.Tensor, max_level: int = 4) -> torch.Tensor:
    """Best pyramid level to search in, from the warp determinant:
    ``ceil(log4(det/3))`` clamped to [0, max_level]. A non-finite
    determinant (a point at ``z ~ 0``) is made finite before the integer
    cast, which saturates in the reference and is undefined in torch."""
    det = (A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]).abs()
    lvl = torch.ceil(torch.log2((det / 3.0).clamp_min(1e-6)) * 0.5)
    return torch.nan_to_num(lvl, nan=0.0).clamp(0, max_level).long()


def warp_patch(img_ref: torch.Tensor, A_ref_cur: torch.Tensor,
               px_ref_level: torch.Tensor, half: int) -> torch.Tensor:
    """Warp a square patch from the reference image: for each offset ``o``
    of the output patch (in the current view's search level), sample the
    reference image at ``px_ref_level + A_ref_cur @ o``. Batched over the
    leading dims of ``A_ref_cur`` / ``px_ref_level``; returns
    (..., 2*half, 2*half)."""
    s = 2 * half
    offs = interp.patch_offsets(half, img_ref.device).reshape(s * s, 2)
    warped = torch.einsum("...ij,pj->...pi", A_ref_cur, offs)
    pos = px_ref_level[..., None, :] + warped                    # (..., P, 2)
    vals = interp.bilinear(img_ref, pos)
    return vals.reshape(vals.shape[:-1] + (s, s))


def grid_search(img: torch.Tensor, ref_patches: torch.Tensor,
                xy: torch.Tensor, radius: int, step: float = 1.0):
    """Exhaustive integer-offset patch search around ``xy``, batched.

    Scores the ZMSSD of ``ref_patches`` (N, s, s) against the
    (2*radius+1)^2 offset grid in ``img``; returns the best position and
    its score, ``(xy_best (N, 2), score_best (N,))`` (the first grid
    position on a tie, row-major with y outer).
    """
    dev = xy.device
    g = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=dev) * step
    oy, ox = torch.meshgrid(g, g, indexing="ij")
    offs = torch.stack([ox, oy], dim=-1).reshape(-1, 2)          # (G, 2)
    pos = xy[:, None, :] + offs[None]                            # (N, G, 2)
    s = ref_patches.shape[-1]
    cur = interp.extract_patches(img, pos.reshape(-1, 2), s // 2)
    cur = cur.reshape(xy.shape[0], offs.shape[0], s, s)          # (N, G, s, s)
    score = zmssd(ref_patches[:, None], cur)                     # (N, G)
    best = torch.argmin(score, dim=1)
    xy_best = torch.gather(pos, 1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    return xy_best, torch.gather(score, 1, best[:, None])[:, 0]


def zmssd(ref_patch: torch.Tensor, cur_patch: torch.Tensor) -> torch.Tensor:
    """Zero-mean SSD between patches (lower is better); broadcasts over
    leading dims."""
    r = ref_patch - torch.mean(ref_patch, dim=(-2, -1), keepdim=True)
    c = cur_patch - torch.mean(cur_patch, dim=(-2, -1), keepdim=True)
    return torch.sum((r - c) ** 2, dim=(-2, -1))
