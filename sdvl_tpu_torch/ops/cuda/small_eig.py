"""Batched small symmetric ``eigh`` and 3x3 SVD that read nothing back:
CUDA kernel, wrapper, plain version.

The two-view bootstrap solves small dense problems: the smallest
eigenvector of the 9x9 ``A^T A`` of each homography hypothesis and refit
(``solvers/homography.py``), the SVD of the chosen 3x3 homography (the
Faugeras decomposition) and the smallest eigenvector of the ground plane's
3x3 covariance (``core/geometry.py``). On CUDA, ``torch.linalg.eigh`` and
``torch.linalg.svd`` read cuSOLVER's ``info`` back to the host; that read is
what keeps a CUDA graph from capturing the bootstrap. The kernels are
``csrc/small_eig.cu``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first
use into ``sdvl_tpu_torch/_build/`` and bound through ``ctypes``, as the
detection kernel is: ``eigh`` is parallel Jacobi in float64, one warp per
matrix, on the pairing schedule :func:`jacobi_rounds`, which the wrapper
hands to each launch; the SVD is one-sided Jacobi, one thread per matrix.
They are the port's own: the reference's ``eigh``/``svd`` are XLA's, not
Pallas kernels.

Output contract: :func:`eigh` as ``torch.linalg.eigh`` (eigenvalues
ascending, eigenvectors as columns; the lower triangle is read), for
square matrices of 1 to 9 rows with any leading batch dimensions;
:func:`svd3` as ``torch.linalg.svd`` of (..., 3, 3) matrices (``U``,
singular values descending, ``Vh``). Eigen- and singular-vector signs are
not unique; the callers do not depend on them.

On CPU tensors both take their plain version, ``torch.linalg.eigh`` and
``torch.linalg.svd``. On CUDA tensors they launch the kernel or raise.
Each launch adds 1 to its kernel's counter on the card (:func:`launches`).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np
import torch

from . import detect

SOURCE = os.path.join(detect._PKG_DIR, "csrc", "small_eig.cu")
MAX_N = 9            # csrc/small_eig.cu MAX_N
MAX_SWEEPS = 30      # csrc/small_eig.cu MAX_SWEEPS
KERNELS = ("eigh", "svd3")

_lib = None
_lib_lock = threading.Lock()
# per CUDA device index, the (2,) int64 counts of the kernels' launches, in
# the order of KERNELS, added to by the kernels themselves (a launch replayed
# from a CUDA graph included)
_counters = {}


@functools.lru_cache(maxsize=None)
def jacobi_rounds(n: int) -> np.ndarray:
    """The pairing schedule of the ``eigh`` kernel's parallel Jacobi sweep
    for n x n matrices: (m - 1, m // 2, 2) int8, m = n rounded up to even;
    round r rotates the m // 2 disjoint pairs ``[r, k] = (p, q)``, p < q,
    at once, and the m - 1 rounds together hold every p < q < m once. A
    pair with q = n (odd n) holds the padding index and does nothing. The
    round-robin (circle) order: index 0 stays, the others turn one seat a
    round. Read-only; the launch copies it into the kernel's parameters."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"jacobi_rounds takes 1 <= n <= {MAX_N}, got {n}")
    m = n + n % 2
    ring = list(range(1, m))
    rounds = []
    for _ in range(m - 1):
        seats = [0] + ring
        rounds.append([sorted((seats[i], seats[m - 1 - i]))
                       for i in range(m // 2)])
        ring = ring[-1:] + ring[:-1]
    out = np.array(rounds, dtype=np.int8).reshape(m - 1, m // 2, 2)
    out.setflags(write=False)
    return out


def load_library(verbose: bool = False):
    """Build (once per process) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(detect.build_library(
                verbose=verbose, source=SOURCE, name="libsdvl_small_eig.so"))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.sdvl_eigh.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
            lib.sdvl_svd3.argtypes = [vp, vp, vp, vp, ci, vp, vp]
            lib.sdvl_eigh.restype = lib.sdvl_svd3.restype = ci
            _lib = lib
    return _lib


def _counter(dev: torch.device) -> torch.Tensor:
    """The launch counters of ``dev`` (one per kernel, in the order of
    ``KERNELS``), made at the first launch there. A graph holds their
    address, so they must exist before a capture."""
    c = _counters.get(dev.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the small eigensolver's first launch on a device must be "
                "eager: a CUDA graph cannot make its launch counter")
        c = _counters[dev.index] = torch.zeros(len(KERNELS),
                                               dtype=torch.int64, device=dev)
    return c


def _counter_ptr(dev: torch.device, kernel: str) -> int:
    return _counter(dev).data_ptr() + 8 * KERNELS.index(kernel)


def reset_launches(device="cuda") -> None:
    """Set the launch counters of ``device`` to 0."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _counter(dev).zero_()


def launches(device="cuda", kernel=None) -> int:
    """Launches on ``device`` since :func:`reset_launches` of ``kernel``
    (one of ``KERNELS``), or of both kernels where it is None (a host
    read)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    c = _counter(dev)
    return int(c.sum() if kernel is None else c[KERNELS.index(kernel)])


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _batched(A: torch.Tensor, n_max: int, what: str) -> torch.Tensor:
    if A.dim() < 2 or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] \
            <= n_max:
        raise ValueError(f"{what} takes (..., n, n) matrices with n <= "
                         f"{n_max}, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError(f"{what} takes float32, got {A.dtype}")
    n = A.shape[-1]
    return A.reshape(-1, n, n).contiguous()


def eigh_plain(A: torch.Tensor):
    """The plain version: ``torch.linalg.eigh``."""
    return torch.linalg.eigh(A)


def svd3_plain(A: torch.Tensor):
    """The plain version: ``torch.linalg.svd``."""
    return torch.linalg.svd(A)


def eigh(A: torch.Tensor):
    """``(eigenvalues, eigenvectors)`` of symmetric (..., n, n) float32
    ``A``, n <= 9, as ``torch.linalg.eigh`` gives them (ties in index
    order): on CUDA one launch of the kernel, reading nothing back; on the
    CPU the plain version."""
    if not A.is_cuda:
        return eigh_plain(A)
    flat = _batched(A, MAX_N, "eigh")
    batch, n = flat.shape[0], flat.shape[-1]
    w = torch.empty((batch, n), dtype=torch.float32, device=A.device)
    V = torch.empty((batch, n, n), dtype=torch.float32, device=A.device)
    lib = load_library()
    rounds = jacobi_rounds(n)
    _check(lib.sdvl_eigh(flat.data_ptr(), w.data_ptr(), V.data_ptr(), batch,
                         n, rounds.ctypes.data, _counter_ptr(A.device, "eigh"),
                         torch.cuda.current_stream(A.device).cuda_stream),
           "the eigh kernel's launch")
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def svd3(A: torch.Tensor):
    """``(U, S, Vh)`` of (..., 3, 3) float32 ``A`` as ``torch.linalg.svd``
    gives them: on CUDA one launch of the kernel, reading nothing back; on
    the CPU the plain version."""
    if not A.is_cuda:
        return svd3_plain(A)
    if A.shape[-2:] != (3, 3):
        raise ValueError(f"svd3 takes (..., 3, 3) matrices, got "
                         f"{tuple(A.shape)}")
    flat = _batched(A, 3, "svd3")
    batch = flat.shape[0]
    U = torch.empty((batch, 3, 3), dtype=torch.float32, device=A.device)
    S = torch.empty((batch, 3), dtype=torch.float32, device=A.device)
    Vh = torch.empty((batch, 3, 3), dtype=torch.float32, device=A.device)
    lib = load_library()
    _check(lib.sdvl_svd3(flat.data_ptr(), U.data_ptr(), S.data_ptr(),
                         Vh.data_ptr(), batch, _counter_ptr(A.device, "svd3"),
                         torch.cuda.current_stream(A.device).cuda_stream),
           "the svd3 kernel's launch")
    return (U.reshape(A.shape), S.reshape(A.shape[:-1]),
            Vh.reshape(A.shape))
