"""Point-sharded Schur-complement bundle adjustment over ``torch.distributed``.

Counterpart of ``sdvl_tpu/dist/ba_sharded.py``. The BA observation grid
(P points x K cameras) shards its POINT dimension over the ranks of a mesh
axis: every rank linearizes and eliminates its own point blocks (V and W
stay local), and only the reduced camera system is summed over the ranks --
``U``, ``b_c``, ``S_cross``, the reduced rhs and the cost, or with the PCG
one (K, 6) product per iteration. Cameras are replicated. The arithmetic is
``solvers/ba.py``'s, through its reduction hook (``group``).
"""

from __future__ import annotations

from typing import Optional

from ..solvers import ba as ba_mod
from ..solvers.ba import BAProblem, BAResult
from . import mesh as mesh_mod


def solve_sharded(problem: BAProblem, mesh, huber: float,
                  stage_iters=(5, 10), gate_scale: float = 1.0,
                  axis: str = "point",
                  method: Optional[str] = None) -> BAResult:
    """Two-stage LM over ``mesh`` with the points sharded on ``axis``.

    Every rank passes the same whole problem (replicated, as the reference's
    global arrays are) and solves its own contiguous block of point rows;
    the point count must divide the axis size. The result is whole on every
    rank: poses replicated, points and inlier masks gathered in rank order.
    Semantics are ``solvers.ba.solve``'s (the same two-stage gating with the
    gate at ``huber * gate_scale``), including the method auto-pick: dense
    Cholesky up to ``ba.CG_KF_THRESHOLD`` keyframe slots, PCG beyond.
    Collective: every rank of the axis calls it.
    """
    rows = mesh_mod.shard_rows(problem.points.shape[0], mesh, axis)
    group = mesh_mod.axis_group(mesh, axis)
    local = problem._replace(points=problem.points[rows],
                             obs_uv=problem.obs_uv[rows],
                             obs_mask=problem.obs_mask[rows])
    res = ba_mod.solve(local, huber=huber, stage_iters=tuple(stage_iters),
                       gate_thresh=huber * gate_scale, group=group,
                       method=method)
    return res._replace(
        points=mesh_mod.gather_rows(res.points, group),
        inlier_mask=mesh_mod.gather_rows(res.inlier_mask, group))
