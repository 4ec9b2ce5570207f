"""FAST-9/16 corner detection + Shi-Tomasi scoring + grid selection.

Counterpart of ``sdvl_tpu/ops/fast.py``. :func:`detect_pyramid` computes one
corner slot per grid cell per level through the detection kernel's wrapper
(``ops/cuda/detect.py``): on CUDA tensors one hand-written kernel computes
the score maps and the cell winners of all levels in one launch, on CPU
tensors its plain torch version does. Both follow the reference's Pallas
route, which rejects every pixel within 4 px of the border; the reference's
plain route (:func:`fast_corner_mask` + :func:`shi_tomasi` + ``_grid_best``
per level) scores those pixels too, so the winners of border cells may
differ. What follows -- the level-0 cell lock, the ``max_features`` budget
-- is the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from .cuda import detect as fused
from .cuda.detect import grid_best as _grid_best  # noqa: F401 (reference's name)


class Corners(NamedTuple):
    """Fixed-capacity corner set. One slot per grid cell per level."""

    xy: torch.Tensor      # (N, 2) position at level-0 coordinates, f32
    score: torch.Tensor   # (N,) Shi-Tomasi score
    level: torch.Tensor   # (N,) pyramid level, int32
    valid: torch.Tensor   # (N,) bool


def fast_corner_mask(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 segment test with edge-replicated borders.
    Returns (H, W) bool."""
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return fused.segment_test(img, pad, 3, threshold)


def shi_tomasi(img: torch.Tensor, half_box: int = 2) -> torch.Tensor:
    """Dense min-eigenvalue (Shi-Tomasi) response map, (H, W): Sobel 3x3
    derivatives (wrapping at the image edge, as the reference's ``roll``),
    a ``2*half_box`` box sum of the structure tensor anchored like OpenCV's
    boxFilter, min eigenvalue normalized by the window area."""
    f = img.float()
    fy = torch.roll(f, -1, 0) - torch.roll(f, 1, 0)
    fx = torch.roll(f, -1, 1) - torch.roll(f, 1, 1)
    dx = 0.25 * (torch.roll(fx, 1, 0) + 2.0 * fx + torch.roll(fx, -1, 0))
    dy = 0.25 * (torch.roll(fy, 1, 1) + 2.0 * fy + torch.roll(fy, -1, 1))
    box = 2 * half_box

    def _boxsum(x):
        H, W = x.shape
        p = F.pad(x, (0, 0, half_box, half_box - 1))
        v = sum(p[i: i + H] for i in range(box))
        p = F.pad(v, (half_box, half_box - 1, 0, 0))
        return sum(p[:, i: i + W] for i in range(box))

    dxx = _boxsum(dx * dx)
    dyy = _boxsum(dy * dy)
    dxy = _boxsum(dx * dy)
    norm = 1.0 / (2.0 * box * box)
    tr = dxx + dyy
    det_term = torch.sqrt(((dxx - dyy) ** 2 + 4.0 * dxy * dxy).clamp_min(0.0))
    return 0.5 * (tr - det_term) * norm * 2.0


def _cell_index(v: torch.Tensor, cell: int, n: int) -> torch.Tensor:
    """``clip(v // cell, 0, n - 1)`` as int64, finite before the cast."""
    return torch.nan_to_num(torch.floor_divide(v, cell), nan=0.0).clamp(
        0, n - 1).long()


def detect_pyramid(pyr: Sequence[torch.Tensor], levels: int = 3,
                   cell: int = 32, fast_threshold: float = 10.0,
                   st_threshold: float = 50.0,
                   max_features: Optional[int] = None,
                   lock_xy: Optional[torch.Tensor] = None,
                   lock_valid: Optional[torch.Tensor] = None) -> Corners:
    """Detect over the first ``levels`` pyramid levels and concatenate.

    ``lock_xy``/``lock_valid`` (level-0 px, (M, 2)/(M,)) suppress corners in
    LEVEL-0 grid cells already holding tracked features, applied to each
    corner's level-0 position after per-cell selection. ``max_features``
    keeps the best-scoring corners only (a stable top-k: equal scores keep
    index order, as the reference's ``top_k``). All levels' cell winners
    come from one call of the detection kernel's wrapper: the kernel on a
    CUDA pyramid, its plain version on a CPU one.
    """
    _, xy, score, valid, level = fused.fast_shi_tomasi_cells(
        pyr[:levels], cell, fast_threshold, st_threshold)
    out = Corners(xy=xy, score=score, level=level, valid=valid)
    if lock_xy is not None:
        H0, W0 = pyr[0].shape
        gw0, gh0 = W0 // cell, H0 // cell
        occ0 = occupied_cells(lock_xy, lock_valid, H0, W0, cell)
        cx = _cell_index(out.xy[:, 0], cell, gw0)
        cy = _cell_index(out.xy[:, 1], cell, gh0)
        out = out._replace(valid=out.valid & ~occ0[cy * gw0 + cx])
    if max_features is not None and max_features < out.xy.shape[0]:
        key = torch.where(out.valid, out.score,
                          torch.full_like(out.score, float("-inf")))
        keep = torch.sort(key, descending=True, stable=True)[1][:max_features]
        out = Corners(*(t[keep] for t in out))
    return out


def occupied_cells(feature_xy: torch.Tensor, feature_valid: torch.Tensor,
                   height: int, width: int, cell: int) -> torch.Tensor:
    """(gh*gw,) bool mask of grid cells containing a valid feature.
    ``feature_xy`` is in level-0 coordinates. Features in the border remnant
    the grid does not cover lock NO cell."""
    gh, gw = height // cell, width // cell
    in_grid = ((feature_xy[:, 0] >= 0) & (feature_xy[:, 0] < gw * cell)
               & (feature_xy[:, 1] >= 0) & (feature_xy[:, 1] < gh * cell))
    cx = _cell_index(feature_xy[:, 0], cell, gw)
    cy = _cell_index(feature_xy[:, 1], cell, gh)
    occ = torch.zeros(gh * gw, dtype=torch.int32, device=feature_xy.device)
    occ.index_add_(0, cy * gw + cx, (feature_valid & in_grid).to(torch.int32))
    return occ > 0
