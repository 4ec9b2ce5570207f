"""FAST-9/16 corner detection + Shi-Tomasi scoring + grid selection.

Counterpart of ``sdvl_tpu/ops/fast.py``. :func:`detect_pyramid` computes one
corner slot per grid cell per level through the detection kernel's wrapper
(``ops/cuda/detect.py``): on CUDA tensors one hand-written kernel computes
the score maps and the cell winners of all levels in one launch, on CPU
tensors its plain torch version does. ``border`` picks which of the
reference's two routes it computes: ``"plain"`` (its default route,
:func:`fast_corner_mask` + :func:`shi_tomasi` + ``_grid_best`` per level,
which scores pixels up to the image edge) or ``"pallas"`` (its Pallas
kernel's, which rejects every pixel within 4 px of the border); the config
key ``use_pallas_detect`` chooses. What follows -- the level-0 cell lock, the
``max_features`` budget -- is the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .cuda import detect as fused
from .cuda.detect import (fast_corner_mask, shi_tomasi,  # noqa: F401
                          grid_best as _grid_best)  # (the reference's names)


class Corners(NamedTuple):
    """Fixed-capacity corner set. One slot per grid cell per level."""

    xy: torch.Tensor      # (N, 2) position at level-0 coordinates, f32
    score: torch.Tensor   # (N,) Shi-Tomasi score
    level: torch.Tensor   # (N,) pyramid level, int32
    valid: torch.Tensor   # (N,) bool


def _cell_index(v: torch.Tensor, cell: int, n: int) -> torch.Tensor:
    """``clip(v // cell, 0, n - 1)`` as int64, finite before the cast."""
    return torch.nan_to_num(torch.floor_divide(v, cell), nan=0.0).clamp(
        0, n - 1).long()


def detect_pyramid(pyr: Sequence[torch.Tensor], levels: int = 3,
                   cell: int = 32, fast_threshold: float = 10.0,
                   st_threshold: float = 50.0,
                   max_features: Optional[int] = None,
                   lock_xy: Optional[torch.Tensor] = None,
                   lock_valid: Optional[torch.Tensor] = None,
                   border: str = "plain") -> Corners:
    """Detect over the first ``levels`` pyramid levels and concatenate.

    ``lock_xy``/``lock_valid`` (level-0 px, (M, 2)/(M,)) suppress corners in
    LEVEL-0 grid cells already holding tracked features, applied to each
    corner's level-0 position after per-cell selection. ``max_features``
    keeps the best-scoring corners only (a stable top-k: equal scores keep
    index order, as the reference's ``top_k``). All levels' cell winners
    come from one call of the detection kernel's wrapper under the
    ``border`` rule (``"plain"`` or ``"pallas"``, the reference's
    ``use_pallas``): the kernel on a CUDA pyramid, its plain version on a
    CPU one.
    """
    _, xy, score, valid, level = fused.fast_shi_tomasi_cells(
        pyr[:levels], cell, fast_threshold, st_threshold, border)
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
