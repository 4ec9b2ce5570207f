"""Bundle adjustment via Schur complement, dense Cholesky on the camera system.

Counterpart of ``sdvl_tpu/solvers/ba.py`` for the local-BA sizes the SLAM
step uses. The observation structure is a dense (P, K) grid of point x camera
slots with a validity mask; the Schur trick is three batched contractions:

    S  = U - W V^{-1} W^T        (reduced camera system, (6K, 6K) dense)
    dc = chol_solve(S, b)        (camera updates)
    dp = V^{-1} (b_p - W^T dc)   (point back-substitution)

Huber weights on unit-plane residuals, two-stage outlier gating (optimize,
drop edges beyond the gate, optimize again) and Levenberg damping with
accept/reject as a ``where`` select: the fixed iteration count runs with no
read back to the host.

A matrix that is not positive definite: ``jnp.linalg.cholesky`` returns NaN
and the NaN step is then rejected by the cost comparison. ``torch``'s
``cholesky`` raises (and checks on the host), and ``cholesky_ex`` returns a
finite partial factor whose step could be accepted; so the port calls
``cholesky_ex`` and sets the step to NaN where ``info != 0``.

Above ``CG_KF_THRESHOLD`` keyframe slots :func:`solve` takes the matrix-free
block-Jacobi PCG of :func:`_schur_solve_cg` instead, as the reference does:
whole-map BA at the shipped 1000-slot capacity never forms the (6K, 6K)
system. On CUDA tensors its products with ``Wm`` and ``WVinv`` and each CG
iteration's vector work are the kernels of ``ops/cuda/ba_pcg.py``, which
read the two (P, K, 6, 3) tensors in their stored layout (an einsum on the
card copies each into a transposed layout first); on the CPU the same
functions are their plain versions, einsums. Each call counts its route on
the process tracer: ``ba.pcg.kernel`` or ``ba.pcg.plain``.

Loops. The reference's CG is a ``while_loop`` that stops at an iteration
bound computed on the device or at a residual tolerance, and its two LM
stages are ``fori_loop``s. The port's are ``device_fsm.device_while`` and
``device_fori``: while a CUDA graph captures, WHILE nodes that read nothing
back (the CG's nested in the LM step's); eagerly, Python loops, the CG's
with a frozen-lane flag (a lane past the tolerance or the bound no longer
moves) read on the host every ``CG_CHECK_EVERY`` iterations to stop early.
Each LM step's CG iteration count stays on the device
(``BAResult.cg_iterations``).

Stage marks (``utils/trace.mark``, captured into a graph only while the
tracer is active) at the boundaries, never inside the CG body: ``gate``
(each LM stage's opening cost and the gating between stages),
``linearize`` (residuals, robust weights, the normal equations), on the
PCG route ``pcg_setup`` (``Vinv``, ``WVinv``, the right-hand side,
``U_d``, the block-Jacobi ``D`` and its inverse, ``r0``, ``z0``) and
``pcg_loop`` (the CG's WHILE node), on the dense route ``schur`` (the
reduced system, its Cholesky and solves), then ``update``
(back-substitution, ``boxplus``, the candidate's cost, accept).

Every solve takes the reference's reduction hook (its ``axis``): ``group``,
a ``torch.distributed`` process group the POINT dimension of the problem is
sharded over (``dist/ba_sharded.py``). Each rank then holds its own point
rows, and ``U``, ``b_c``, every point-contracted term and the cost are
all-reduced over the group (:func:`_psum`): the dense path
reduces the (K, K, 6, 6) ``S_cross`` once per LM step, the PCG one (K, 6)
product per iteration. Every branch -- the PCG's early exit, its iteration
bound, each LM step's accept -- reads reduced values only, so all ranks
take it alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import camera as cam
from ..core import geometry, se3
from ..ops.cuda import ba_pcg
from ..utils import trace


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (a new tensor), or ``x``
    itself where ``group`` is None: the reference's ``lax.psum``."""
    if group is None:
        return x
    out = x.contiguous().clone()
    torch.distributed.all_reduce(out, group=group)
    return out


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem.

    poses:     (K, 7) world->cam keyframe poses
    fixed:     (K,) bool, poses held constant
    points:    (P, 3) world points
    obs_uv:    (P, K, 2) unit-plane measurements
    obs_mask:  (P, K) bool, observation exists
    """

    poses: torch.Tensor
    fixed: torch.Tensor
    points: torch.Tensor
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor          # final robust cost
    inlier_mask: torch.Tensor   # (P, K) observations that survived gating
    cg_iterations: Optional[torch.Tensor] = None
    # (n LM steps,) int32 on the device: the CG iterations of each LM step
    # (PCG route; (0,) on the dense route)


# keyframe-slot count above which solve() switches the reduced camera
# system from dense Cholesky to matrix-free PCG (a shape decision)
CG_KF_THRESHOLD = 200

# PCG iterations between two host reads of the "converged" flag
CG_CHECK_EVERY = 8


def _residuals(poses, points, obs_uv, w_mask):
    """r (P,K,2), p_cam (P,K,3), front-of-camera mask folded into w."""
    p_cam = se3.transform(poses[None, :, :], points[:, None, :])
    uv = cam.project_unit_plane(p_cam)
    r = obs_uv - uv
    w = w_mask * (p_cam[..., 2] > 1e-4)
    return r, p_cam, w.float()


def _robust_weights(r, w, huber):
    """Huber IRLS weights per observation."""
    n = torch.sqrt(torch.sum(r * r, dim=-1))
    scale = torch.where(n <= huber, torch.ones_like(n),
                        huber / n.clamp_min(1e-12))
    return w * scale


def _build_system(poses, points, r, w):
    """Assemble U, V, W, b_c, b_p for the current linearization."""
    p_cam = se3.transform(poses[None, :, :], points[:, None, :])
    Jc = -geometry.jacobian_unit_plane(p_cam)                  # (P,K,2,6)
    Jp = -geometry.jacobian_point(poses[None, :, :4], p_cam)   # (P,K,2,3)

    U = torch.einsum("pkri,pkrj,pk->kij", Jc, Jc, w)           # (K,6,6)
    V = torch.einsum("pkri,pkrj,pk->pij", Jp, Jp, w)           # (P,3,3)
    Wm = torch.einsum("pkri,pkrj,pk->pkij", Jc, Jp, w)         # (P,K,6,3)
    b_c = torch.einsum("pkri,pkr,pk->ki", Jc, r, w)            # (K,6)
    b_p = torch.einsum("pkri,pkr,pk->pi", Jp, r, w)            # (P,3)
    return U, V, Wm, b_c, b_p


def _schur_solve(U, V, Wm, b_c, b_p, fixed, lam, group=None):
    """Solve the damped normal equations by marginalizing point blocks.
    A reduced system that is not positive definite gives a NaN step.
    ``group``: the points are sharded over it (see the module note)."""
    trace.mark("schur")
    U, b_c = _psum(U, group), _psum(b_c, group)
    K = U.shape[0]
    dev = U.device
    eye3 = torch.eye(3, dtype=V.dtype, device=dev)
    eye6 = torch.eye(6, dtype=U.dtype, device=dev)

    V_d = V + (lam + 1e-8) * eye3[None]
    Vinv = torch.linalg.inv_ex(V_d).inverse                    # (P,3,3)

    # S_kl = delta_kl (U_k + lam I) - sum_p W_pk Vinv_p W_pl^T
    WVinv = torch.einsum("pkij,pjl->pkil", Wm, Vinv)           # (P,K,6,3)
    S = -_psum(torch.einsum("pkil,pmjl->kmij", WVinv, Wm), group)
    diag = torch.arange(K, device=dev)                         # (K,K,6,6)
    S[diag, diag] += U + lam * eye6[None]

    rhs = b_c - _psum(torch.einsum("pkil,pl->ki", WVinv, b_p), group)

    # gauge/fixed handling: zero rows+cols of fixed cameras, identity diag
    free = (~fixed).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[diag, diag] += (1.0 - free)[:, None, None] * eye6[None]
    rhs = rhs * free[:, None]

    S_full = S.transpose(1, 2).reshape(K * 6, K * 6)
    L, info = torch.linalg.cholesky_ex(
        S_full + 1e-8 * torch.eye(K * 6, dtype=S.dtype, device=dev))
    # the reference's cho_solve: two triangular solves. (cholesky_solve
    # would be cuSOLVER's potrs, which can allocate stream-ordered memory
    # inside a CUDA graph capture; a conditional node's body cannot hold
    # such an allocation.)
    y = torch.linalg.solve_triangular(L, rhs.reshape(K * 6, 1), upper=False)
    dc = torch.linalg.solve_triangular(L.mT, y, upper=True).reshape(K, 6)
    dc = torch.where(info != 0, torch.full_like(dc, float("nan")), dc)

    trace.mark("update")
    # back-substitute points: dp = Vinv (b_p - sum_k W_pk^T dc_k)
    t = b_p - torch.einsum("pkij,ki->pj", Wm, dc)
    dp = torch.einsum("pij,pj->pi", Vinv, t)
    return dc, dp


def _schur_solve_cg(U, V, Wm, b_c, b_p, fixed, lam, group=None):
    """Matrix-free PCG on the reduced camera system -- the large-map path.

    S is never formed: each iteration applies

        y_k = (U_k + lam I) x_k - sum_p W_pk V^-1_p (sum_m W_pm^T x_m)

    as three O(P*K) contractions, preconditioned by the exact 6x6 block
    diagonal of S (block-Jacobi). The iterations stop at
    ``min(max(64, K), max(6 * n_free, 16))`` for ``n_free`` free cameras (a
    bound computed on the device; ``max(64, K)`` is the static ceiling, the
    reference's ``cg_iters``), or once the preconditioned residual ``rz``
    has dropped to 1e-12 of its start: the reference's ``while_loop`` exit,
    through :func:`device_fsm.device_while` (a lane past either no longer
    moves, so the eager loop reads the predicate every ``CG_CHECK_EVERY``
    iterations only).

    ``group``: the points are sharded over it (see the module note): the
    per-iteration wire cost is one (K, 6) all-reduce, whatever P and K.

    An iteration is ``ops/cuda/ba_pcg.py``'s ``wt_x``, ``wvinv_t`` and
    ``cg_tail``, the all-reduce between the last two: on CUDA tensors
    three kernels, ``cg_tail`` writing the carry in place (so a captured
    WHILE body copies nothing back); on CPU tensors their plain versions.

    Returns ``(dc, dp, n_iter)``, ``n_iter`` a () int32 tensor: the
    iterations the reference's loop runs on the same numbers.
    """
    from ..pipeline.device_fsm import device_while

    trace.mark("pcg_setup")
    K = U.shape[0]
    dev = U.device
    eye3 = torch.eye(3, dtype=V.dtype, device=dev)
    eye6 = torch.eye(6, dtype=U.dtype, device=dev)
    free = (~fixed).to(U.dtype)
    trace.tracer().count("ba.pcg.kernel" if Wm.is_cuda else "ba.pcg.plain")

    V_d = V + (lam + 1e-8) * eye3[None]
    Vinv = torch.linalg.inv_ex(V_d).inverse                    # (P,3,3)
    WVinv = torch.einsum("pkij,pjl->pkil", Wm, Vinv)           # (P,K,6,3)
    scratch = ba_pcg.Scratch(WVinv)

    rhs = _psum(b_c - ba_pcg.wvinv_t(WVinv, b_p, scratch),
                group) * free[:, None]
    U_d = _psum(U, group) + (lam + 1e-8) * eye6[None]

    # block-Jacobi preconditioner: exact 6x6 diagonal blocks of S, each
    # inverse row-major as cg_tail reads it (inv_ex's are column-major)
    D = U_d - _psum(torch.einsum("pkil,pkjl->kij", WVinv, Wm), group)
    D = D * free[:, None, None] + eye6[None] * (1.0 - free)[:, None, None]
    Dinv = torch.linalg.inv_ex(D + 1e-8 * eye6[None]).inverse.contiguous()

    r0 = rhs
    z0 = torch.einsum("kij,kj->ki", Dinv, r0)
    rz0 = torch.sum(r0 * z0)
    tol = 1e-12 * rz0.clamp_min(1e-30)
    ceiling = max(64, K)
    n_free = torch.sum(~fixed).to(torch.int32)
    max_it = (6 * n_free).clamp_min(16).clamp_max(ceiling)

    def cond(c):
        _, _, _, rz, i = c
        return (i < max_it) & (rz > tol)

    def body(c):
        # S p: t = W^T (free p), s = sum_p W V^-1 t, reduced over the
        # group; then the rest of the iteration (on CUDA in place)
        t = ba_pcg.wt_x(Wm, c[2], free)
        s = _psum(ba_pcg.wvinv_t(WVinv, t, scratch), group)
        return ba_pcg.cg_tail(s, U_d, Dinv, free, c, max_it, tol)

    trace.mark("pcg_loop")
    x, _, _, _, n_iter = device_while(
        cond, body, (torch.zeros_like(rhs), r0, z0, rz0,
                     torch.zeros((), dtype=torch.int32, device=dev)),
        max_iters=ceiling, check_every=CG_CHECK_EVERY)
    trace.mark("update")
    dc = x * free[:, None]

    t = b_p - ba_pcg.wt_x(Wm, dc)
    dp = torch.einsum("pij,pj->pi", Vinv, t)
    return dc, dp, n_iter


def _robust_chi2(r, w, huber):
    n2 = torch.sum(r * r, dim=-1)
    n = torch.sqrt(n2.clamp_min(0.0))
    rho = torch.where(n <= huber, n2, 2.0 * huber * n - huber * huber)
    return torch.sum(rho * w)


def solve(problem: BAProblem, huber: float, stage_iters=(5, 10),
          gate_thresh: Optional[float] = None, group=None,
          method: Optional[str] = None) -> BAResult:
    """Two-stage Levenberg-Marquardt with Schur elimination.

    ``huber`` and ``gate_thresh`` are in unit-plane units (pixels / focal).
    Stage 1 optimizes with all observations; observations whose squared
    error exceeds ``gate_thresh**2`` (or with negative depth) are then
    removed, and stage 2 re-optimizes. Each iteration accepts the step only
    if the robust cost fell, halving the damping, else quadruples it. The
    reduced camera system is solved by dense Cholesky up to
    ``CG_KF_THRESHOLD`` keyframe slots and by PCG above (eagerly one host
    read per ``CG_CHECK_EVERY`` CG iterations, none under a CUDA graph
    capture; the result's ``cg_iterations`` holds the count of each LM step
    in one device tensor); ``method`` ("chol" or "cg") overrides that
    choice. Both LM stages are ``device_fsm.device_fori`` loops. ``group``:
    the problem holds this rank's point rows only, and every sum over
    points is all-reduced over it (see the module note; the result's
    ``points`` and ``inlier_mask`` are the local rows).
    """
    from ..pipeline.device_fsm import device_fori

    if gate_thresh is None:
        gate_thresh = huber
    if method not in (None, "chol", "cg"):
        raise ValueError(f"method {method!r} is not 'chol' or 'cg'")
    use_cg = (problem.poses.shape[0] > CG_KF_THRESHOLD if method is None
              else method == "cg")
    dev = problem.poses.device
    n_steps = sum(stage_iters) if use_cg else 0

    def chi2_of(poses, points, w_mask):
        r, _, w = _residuals(poses, points, problem.obs_uv, w_mask)
        return _psum(_robust_chi2(r, _robust_weights(r, w, huber), huber),
                     group)

    def lm_run(poses, points, counts, w_mask, iters, first_step):
        def step(i, c):
            poses, points, lam, prev_chi2, counts = c
            trace.mark("linearize")
            r, _, w0 = _residuals(poses, points, problem.obs_uv, w_mask)
            w = _robust_weights(r, w0, huber)
            system = _build_system(poses, points, r, w)
            if use_cg:
                dc, dp, n_iter = _schur_solve_cg(*system, problem.fixed, lam,
                                                 group=group)
                counts = counts.index_copy(
                    0, (i + first_step).long().reshape(1), n_iter.reshape(1))
            else:
                dc, dp = _schur_solve(*system, problem.fixed, lam,
                                      group=group)
            new_poses = se3.boxplus(poses, -dc)
            new_points = points - dp
            chi2 = chi2_of(new_poses, new_points, w_mask)
            accept = chi2 < prev_chi2
            poses = torch.where(accept, new_poses, poses)
            points = torch.where(accept, new_points, points)
            lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e3)
            prev_chi2 = torch.where(accept, chi2, prev_chi2)
            return poses, points, lam, prev_chi2, counts

        trace.mark("gate")
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        poses, points, _, chi2, counts = device_fori(
            iters, step, (poses, points, lam,
                          chi2_of(poses, points, w_mask), counts))
        return poses, points, chi2, counts

    w_mask = problem.obs_mask.float()
    counts = torch.zeros(n_steps, dtype=torch.int32, device=dev)
    poses, points, _, counts = lm_run(problem.poses, problem.points, counts,
                                      w_mask, stage_iters[0], 0)

    # outlier gating between stages
    trace.mark("gate")
    r, p_cam, _ = _residuals(poses, points, problem.obs_uv, w_mask)
    err2 = torch.sum(r * r, dim=-1)
    keep = (err2 < gate_thresh * gate_thresh) & (p_cam[..., 2] > 1e-4)
    w_mask2 = w_mask * keep

    poses, points, chi2, counts = lm_run(poses, points, counts, w_mask2,
                                         stage_iters[1], stage_iters[0])
    return BAResult(
        poses=poses, points=points, chi2=chi2,
        inlier_mask=(w_mask2 > 0) & problem.obs_mask,
        cg_iterations=counts,
    )
