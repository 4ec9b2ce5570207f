"""The small eigensolver of the bootstrap (``ops/cuda/small_eig.py``) on the
CPU: the parallel Jacobi schedule that its CUDA kernel runs, a float64
numpy model of the kernel's sweep on that schedule, and the wrapper's CPU
path against the reference's ``jnp.linalg.eigh``.

The kernel itself runs on the card only (``tests/test_torch_cuda_kernel.py``
holds it against ``torch.linalg.eigh`` and against the model below). Here:

- ``jacobi_rounds(n)``: each round's pairs are disjoint, and each sweep
  holds every pair p < q < n exactly once (the padding index of odd n
  aside);
- the model (``torch_port_helpers.jacobi_eigh_model``) converges within
  ``MAX_SWEEPS`` and gives ``numpy.linalg.eigh``'s values within 1e-12 of
  the largest in magnitude (float64 Jacobi on float32 inputs: a few units
  of float64 rounding per sweep), ``A V = V diag(w)`` and ``V^T V = I``
  within 1e-12; exact ties come out in index order;
- ``small_eig.eigh`` on CPU tensors against ``jnp.linalg.eigh`` on the same
  float32 batch: values within 1e-5 of the largest (float32 LAPACK on both
  sides), eigenvectors whose values stand apart by 1e-3 of the largest
  with |cos| >= 1 - 1e-4 (a vector's sign is not unique).

The 3x3 SVD's kernel has a float64 numpy model too
(``torch_port_helpers.jacobi_svd3_model``), held here against
``numpy.linalg.svd`` in float64 (values within 1e-12 of the largest,
``U diag(S) Vh = A`` within 1e-12 of the largest, U and Vh orthonormal
within 1e-12) and against ``jnp.linalg.svd`` up to signs (float32:
values within 1e-5 of the largest, vectors whose values stand apart by
1e-3 of the largest with |cos| >= 1 - 1e-4), on the cases of
``torch_port_helpers.svd3_cases`` (plane homographies as the bootstrap
decomposes them, ties, ranks 0 to 2, a near-degenerate matrix, 1000 random
matrices); tied values come out in index order, and the wrapper's CPU path
(``torch.linalg.svd``) meets the same bounds against JAX.

The cases are those of ``chip_smoke.py``'s ``eig_cases`` (the bootstrap's
128-hypothesis DLT ``A^T A`` at 400 points, a weighted refit, a plane's 3x3
covariance, a near-degenerate 9x9), made from the same seeded numpy, and
random symmetric matrices of 1, 2, 5 and 8 rows and a diagonal with exact
ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvl_tpu_torch.ops.cuda import small_eig
from torch_port_helpers import T, jacobi_eigh_model, jacobi_svd3_model, \
    svd3_cases


def eig_arrays(seed=0) -> dict:
    """name -> (..., n, n) float32 symmetric numpy matrices: the bootstrap's
    shapes, as ``chip_smoke.eig_cases`` makes them from the same seed, and
    sizes 1, 2, 5, 8 and exact ties."""
    rs = np.random.default_rng(seed)
    uv = rs.uniform(-0.6, 0.6, (400, 2))
    uvb = uv + rs.normal(0, 0.02, (400, 2))
    x, y, xp, yp = uv[:, 0], uv[:, 1], uvb[:, 0], uvb[:, 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    A = np.concatenate([
        np.stack([x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp], -1),
        np.stack([zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp], -1)])
    w = np.zeros((128, 400))
    for h in range(128):            # four points per RANSAC hypothesis
        w[h, rs.choice(400, 4, replace=False)] = 1.0
    ransac = np.einsum("ni,nj,hn->hij", A, A, np.concatenate([w, w], 1))
    refit = np.einsum("ni,nj,n->ij", A, A, np.repeat(
        rs.uniform(0, 1, 400) > 0.3, 2).astype(float))
    pts = rs.normal(0, 1, (4096, 3)) * [2.0, 1.5, 0.01]
    q = np.linalg.qr(rs.normal(0, 1, (9, 9)))[0]
    cases = dict(ransac_9x9=ransac, refit_9x9=refit,
                 cov_3x3=pts.T @ pts / len(pts),
                 near_degenerate_9x9=q @ np.diag(
                     [1, 1, 1 + 1e-7, 2, 3, 3, 3, 5, 8]) @ q.T)
    sym = np.random.default_rng(seed + 1)
    for n in (1, 2, 5, 8):
        m = sym.normal(0, 1, (16, n, n))
        cases[f"n{n}"] = m + np.swapaxes(m, 1, 2)
    cases["ties"] = np.diag([2.0, 2.0, 1.0, 3.0, 1.0, 2.0])
    return {k: np.asarray(v, np.float32) for k, v in cases.items()}


CASES = list(eig_arrays())


@pytest.mark.parametrize("n", range(1, small_eig.MAX_N + 1))
def test_jacobi_rounds_pair_every_index_once_per_sweep(n):
    rounds = small_eig.jacobi_rounds(n)
    m = n + n % 2
    assert rounds.shape == (m - 1, m // 2, 2) and rounds.dtype == np.int8
    seen = []
    for pairs in rounds:
        idx = pairs.ravel().tolist()
        assert sorted(idx) == list(range(m))        # disjoint, all seats
        for p, q in pairs.tolist():
            assert 0 <= p < q < m
            if q < n:
                seen.append((p, q))
            else:
                assert n % 2 == 1 and q == n        # the padding index
    want = [(p, q) for p in range(n) for q in range(p + 1, n)]
    assert sorted(seen) == want                     # each pair once


def test_jacobi_rounds_refuse_sizes_the_kernel_cannot_take():
    for n in (0, small_eig.MAX_N + 1):
        with pytest.raises(ValueError):
            small_eig.jacobi_rounds(n)


@pytest.mark.parametrize("case", CASES)
def test_parallel_sweep_model_matches_numpy_eigh(case):
    A = eig_arrays()[case]
    n = A.shape[-1]
    w, V, sweeps = jacobi_eigh_model(A, small_eig.jacobi_rounds(n),
                                     small_eig.MAX_SWEEPS)
    flat = A.reshape(-1, n, n).astype(np.float64)
    assert (sweeps >= 1).all(), f"no convergence in {small_eig.MAX_SWEEPS}"
    want = np.linalg.eigh(flat)[0]
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(w - want).max()) <= 1e-12 * scale
    assert (np.diff(w, axis=-1) >= 0).all()
    resid = flat @ V - V * w[:, None, :]
    assert float(np.abs(resid).max()) <= 1e-12 * scale
    eye = np.eye(n)
    assert float(np.abs(np.swapaxes(V, 1, 2) @ V - eye).max()) <= 1e-12
    if case == "ties":
        # a diagonal rotates nothing: values ascending, equal ones in
        # index order, the vectors the unit vectors of that order
        order = [2, 4, 0, 1, 5, 3]
        assert sweeps.tolist() == [1]
        np.testing.assert_array_equal(w[0], np.diag(A)[order])
        np.testing.assert_array_equal(V[0], eye[:, order])


@pytest.mark.parametrize("case", CASES)
def test_eigh_on_cpu_matches_jax(case):
    A = eig_arrays()[case]
    n = A.shape[-1]
    w, V = small_eig.eigh(T(A))
    assert w.dtype == V.dtype == torch.float32
    assert tuple(w.shape) == A.shape[:-1] and tuple(V.shape) == A.shape
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    w, V = w.numpy().reshape(-1, n), V.numpy().reshape(-1, n, n)
    wj, Vj = wj.reshape(-1, n), Vj.reshape(-1, n, n)
    for b in range(len(w)):
        scale = max(float(np.abs(wj[b]).max()), 1e-30)
        assert float(np.abs(w[b] - wj[b]).max()) <= 1e-5 * scale, b
        for k in range(n):
            gaps = np.abs(np.delete(wj[b], k) - wj[b, k])
            if n > 1 and gaps.min() < 1e-3 * scale:
                continue                            # not apart
            cos = abs(float(V[b, :, k] @ Vj[b, :, k]))
            assert cos >= 1 - 1e-4, (b, k, cos)


SVD_CASES = list(svd3_cases())


def _assert_close_to_jax_svd(U, S, Vh, A):
    """(batch, 3, 3) U, Vh and (batch, 3) S against ``jnp.linalg.svd`` of
    ``A`` up to signs: values within 1e-5 of the largest, columns of U and
    rows of Vh whose values stand apart by 1e-3 of it with |cos| >= 1 -
    1e-4."""
    Uj, Sj, Vhj = (np.asarray(x) for x in jnp.linalg.svd(
        jnp.asarray(A.reshape(-1, 3, 3))))
    for b in range(len(S)):
        scale = max(float(Sj[b].max()), 1e-30)
        assert float(np.abs(S[b] - Sj[b]).max()) <= 1e-5 * scale, b
        for k in range(3):
            if np.abs(np.delete(Sj[b], k) - Sj[b, k]).min() < 1e-3 * scale:
                continue                            # not apart
            assert abs(float(U[b, :, k] @ Uj[b, :, k])) >= 1 - 1e-4, (b, k)
            assert abs(float(Vh[b, k] @ Vhj[b, k])) >= 1 - 1e-4, (b, k)


@pytest.mark.parametrize("case", SVD_CASES)
def test_svd3_model_matches_numpy_and_jax(case):
    A = svd3_cases()[case]
    U, S, Vh, sweeps = jacobi_svd3_model(A, small_eig.MAX_SWEEPS)
    flat = A.reshape(-1, 3, 3).astype(np.float64)
    assert (sweeps >= 1).all(), f"no convergence in {small_eig.MAX_SWEEPS}"
    want = np.linalg.svd(flat)[1]
    scale = max(float(want.max()), 1e-30)
    assert float(np.abs(S - want).max()) <= 1e-12 * scale
    assert (np.diff(S, axis=-1) <= 0).all()            # descending
    recon = U * S[:, None, :] @ Vh
    assert float(np.abs(recon - flat).max()) <= 1e-12 * scale
    eye = np.eye(3)
    assert float(np.abs(np.swapaxes(U, 1, 2) @ U - eye).max()) <= 1e-12
    assert float(np.abs(Vh @ np.swapaxes(Vh, 1, 2) - eye).max()) <= 1e-12
    # a vanishing value's column of U completes a right-handed basis
    assert (np.linalg.det(U[S[:, 2] <= 1e-13 * S[:, 0] + 1e-30]) > 0).all()
    _assert_close_to_jax_svd(U, S, Vh, A)


def test_svd3_model_orders_ties_by_index():
    """Equal values come out in index order, the vectors with them: columns
    of norms (1, 1, 2) give values (2, 1, 1) from columns 2, 0, 1 (a
    selection swap gave 2, 1, 0), and (3, 3, 3) keeps 0, 1, 2."""
    eye = np.eye(3)
    for diag, order in (([1.0, 1.0, 2.0], [2, 0, 1]),
                        ([1.0, 2.0, 1.0], [1, 0, 2]),
                        ([2.0, 1.0, 2.0], [0, 2, 1]),
                        ([3.0, 3.0, 3.0], [0, 1, 2])):
        U, S, Vh, sweeps = jacobi_svd3_model(np.diag(diag))
        assert sweeps.tolist() == [1]                   # nothing rotates
        np.testing.assert_array_equal(S[0], np.asarray(diag)[order])
        np.testing.assert_array_equal(Vh[0], eye[order])
        np.testing.assert_array_equal(U[0], eye[:, order])


@pytest.mark.parametrize("case", SVD_CASES)
def test_svd3_on_cpu_matches_jax(case):
    A = svd3_cases()[case]
    U, S, Vh = small_eig.svd3(T(A))
    assert U.dtype == S.dtype == Vh.dtype == torch.float32
    assert tuple(U.shape) == A.shape and tuple(S.shape) == A.shape[:-1]
    _assert_close_to_jax_svd(U.numpy().reshape(-1, 3, 3),
                             S.numpy().reshape(-1, 3),
                             Vh.numpy().reshape(-1, 3, 3), A)
