"""The whole-map BA's CG iteration as CUDA kernels that read ``Wm`` and
``WVinv`` where they lie: wrapper and plain versions.

``solvers/ba.py::_schur_solve_cg`` applies the reduced camera system
``S p`` through two products with the (P, K, 6, 3) blocks of the normal
equations, ``t = W^T (free * x)`` and ``s = sum_p W V^-1 t``, and closes
each CG iteration with vector work on (K, 6). On CUDA tensors these run as
the three kernels of ``csrc/ba_pcg.cu`` (see its note: what bounds them and
how): :func:`wt_x`, :func:`wvinv_t` and :func:`cg_tail`. The source is
compiled into the conditional-node library (``ops/cuda/graph_if``), which
the BA's graph path builds and loads anyway.

On CPU tensors each function takes its plain version (:func:`wt_x_plain`,
:func:`wvinv_t_plain`, :func:`cg_tail_plain`): the CG's einsums and
vector work as torch operations, the one copy of them the solve runs. On
CUDA tensors each launches its kernel or raises. Each launch adds 1 to its
kernel's counter on the card (:func:`launches`).

Sums are taken in another order than the einsums' (float32, no atomics on
floats): the results agree with the plain versions to float32 rounding,
and two launches on the same inputs give the same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import graph_if

KERNELS = ("wt_x", "wvinv_t", "cg_tail")
TILE_SLOTS = 64       # csrc/ba_pcg.cu kTileSlots
CHUNK_POINTS = 128    # csrc/ba_pcg.cu kChunkPoints
WT_WARPS = 8          # csrc/ba_pcg.cu kWarps
MAX_K = 9600          # K * 6 floats of shared memory within 227 KB

_bound = None
# per CUDA device index, the (3,) int64 counts of the kernels' launches, in
# the order of KERNELS, added to by the kernels themselves (a launch replayed
# from a CUDA graph included)
_counters = {}


def load_library(verbose: bool = False):
    """Build (once per process) and load the library that holds the
    kernels (the conditional-node library's)."""
    global _bound
    lib = graph_if.load_library(verbose=verbose)
    if _bound is not lib:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sdvl_ba_wt_x.argtypes = [vp] * 4 + [ci] * 4 + [vp, vp]
        lib.sdvl_ba_wvinv_t.argtypes = [vp] * 5 + [ci] * 3 + [vp, vp]
        lib.sdvl_ba_cg_tail.argtypes = [vp] * 11 + [ci, vp, vp]
        for fn in (lib.sdvl_ba_wt_x, lib.sdvl_ba_wvinv_t,
                   lib.sdvl_ba_cg_tail):
            fn.restype = ci
        _bound = lib
    return lib


def _counter(dev: torch.device) -> torch.Tensor:
    """The launch counters of ``dev`` (one per kernel, in the order of
    ``KERNELS``), made at the first launch there. A graph holds their
    address, so they must exist before a capture."""
    c = _counters.get(dev.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the BA's CG kernels' first launch on a device must be "
                "eager: a CUDA graph cannot make their launch counter")
        c = _counters[dev.index] = torch.zeros(len(KERNELS),
                                               dtype=torch.int64, device=dev)
    return c


def _device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def reset_launches(device="cuda") -> None:
    """Set the launch counters of ``device`` to 0."""
    _counter(_device(device)).zero_()


def launches(device="cuda", kernel=None) -> int:
    """Launches on ``device`` since :func:`reset_launches` of ``kernel``
    (one of ``KERNELS``), or of all three where it is None (a host
    read)."""
    c = _counter(_device(device))
    return int(c.sum() if kernel is None else c[KERNELS.index(kernel)])


def _launch(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"the {kernel} kernel's launch failed: CUDA "
                           f"error {err}")


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_cuda \
            or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous {dtype} "
                         f"CUDA tensor of shape {tuple(shape)}, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def _blocks(P: int, dev: torch.device) -> int:
    """wt_x's grid: four blocks an SM (at the Zurich shape 84 % of the
    bytes bound, where two read 78 % and three 73 %: an uneven last round
    of points), fewer where P has fewer points."""
    return max(1, min(-(-P // WT_WARPS), 4 * _sms(dev.index)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vec(*ts) -> bool:
    """16-byte loads: every row of K * 18 floats starts on 16 bytes."""
    return all(t.shape[1] % 2 == 0 and t.data_ptr() % 16 == 0 for t in ts)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------------ plain versions
def wt_x_plain(Wm: torch.Tensor, x: torch.Tensor, free=None) -> torch.Tensor:
    """``sum_{k,i} Wm[p,k,i,:] (free * x)[k,i]`` as an einsum (``free``
    None: ``x`` as it is): ``W^T x`` of ``S x``, and the
    back-substitution's product."""
    if free is not None:
        x = x * free[:, None]
    return torch.einsum("pkij,ki->pj", Wm, x)


def wvinv_t_plain(WVinv: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``sum_p WVinv[p,k,:,:] t_p`` as an einsum: the right-hand side's
    product and ``S x``'s second."""
    return torch.einsum("pkil,pl->ki", WVinv, t)


def ap_plain(s, U_d, free, p):
    """``S p`` from ``s`` (the reduced ``sum_p WVinv t`` of ``p``):
    ``U_d (free p) - s`` on the free cameras; the fixed ones act as
    identity rows (keeps the operator positive definite)."""
    pm = p * free[:, None]
    y = torch.einsum("kij,kj->ki", U_d, pm) - s
    return y * free[:, None] + pm * (1.0 - free)[:, None]


def cg_tail_plain(s, U_d, Dinv, free, carry, max_it, tol):
    """One preconditioned CG iteration of
    ``solvers/ba.py::_schur_solve_cg`` from ``s`` (the reduced
    ``sum_p WVinv t`` of the carry's ``p``) on: ``S p``, the step, the
    block-Jacobi ``z = Dinv r`` and the next direction. Returns the next
    carry ``(x, r, p, rz, i)``; a carry whose condition is false (the
    loop's: ``i < max_it`` and ``rz > tol``) comes back as it was."""
    x, r, p, rz, i = carry
    active = (i < max_it) & (rz > tol)
    Ap = ap_plain(s, U_d, free, p)
    alpha = rz / torch.sum(p * Ap).clamp_min(1e-30)
    alpha = torch.where(active, alpha, torch.zeros_like(alpha))
    x = x + alpha * p
    r = r - alpha * Ap
    z = torch.einsum("kij,kj->ki", Dinv, r)
    rz_new = torch.sum(r * z)
    beta = rz_new / rz.clamp_min(1e-30)
    p = torch.where(active, z + beta * p, p)
    rz = torch.where(active, rz_new, rz)
    return x, r, p, rz, i + active.to(torch.int32)


# ------------------------------------------------------------------ kernels
class Scratch:
    """:func:`wvinv_t`'s scratch on the device of ``WVinv`` (P, K, 6, 3):
    the chunks' partial sums (n_chunks, K, 6) and a ticket per tile of
    slots, zero between launches (the last block of a tile sets its ticket
    back). Made before a CG loop, so that a captured loop's body sets
    nothing to zero. The plain version takes none of it: for a CPU
    ``WVinv`` nothing is allocated."""

    def __init__(self, WVinv: torch.Tensor):
        self.partial = self.tickets = None
        if not WVinv.is_cuda:
            return
        P, K = WVinv.shape[:2]
        dev = WVinv.device
        self.partial = torch.empty((-(-P // CHUNK_POINTS), K, 6),
                                   dtype=torch.float32, device=dev)
        self.tickets = torch.zeros(-(-K // TILE_SLOTS), dtype=torch.int32,
                                   device=dev)


def wt_x(Wm: torch.Tensor, x: torch.Tensor, free=None) -> torch.Tensor:
    """``t`` (P, 3) with ``t_p = sum_{k,i} Wm[p,k,i,:] (free * x)[k,i]``
    for ``Wm`` (P, K, 6, 3), ``x`` (K, 6) and ``free`` (K,) or None (no
    mask): on CUDA one launch of the kernel, on the CPU the plain
    version."""
    if not Wm.is_cuda:
        return wt_x_plain(Wm, x, free)
    P, K = Wm.shape[:2]
    if not 1 <= K <= MAX_K or P < 1:
        raise ValueError(f"wt_x takes 1 <= K <= {MAX_K} slots and P >= 1 "
                         f"points, got {tuple(Wm.shape)}")
    _check("Wm", Wm, (P, K, 6, 3))
    _check("x", x, (K, 6))
    if free is not None:
        _check("free", free, (K,))
    dev = _device(Wm.device)
    t = torch.empty((P, 3), dtype=torch.float32, device=dev)
    _launch(load_library().sdvl_ba_wt_x(
        Wm.data_ptr(), x.data_ptr(), None if free is None else
        free.data_ptr(), t.data_ptr(), P, K, _blocks(P, dev), int(_vec(Wm)),
        _counter(dev).data_ptr(), _stream(dev)), "wt_x")
    return t


def wvinv_t(WVinv: torch.Tensor, t: torch.Tensor,
            scratch: Scratch = None) -> torch.Tensor:
    """``s`` (K, 6) with ``s_k = sum_p WVinv[p,k,:,:] t_p`` for ``WVinv``
    (P, K, 6, 3) and ``t`` (P, 3): on CUDA one launch of the kernel, with
    ``scratch`` (a :class:`Scratch` of ``WVinv``; made here where None), on
    the CPU the plain version."""
    if not WVinv.is_cuda:
        return wvinv_t_plain(WVinv, t)
    P, K = WVinv.shape[:2]
    if not 1 <= K <= MAX_K or P < 1:
        raise ValueError(f"wvinv_t takes 1 <= K <= {MAX_K} slots and P >= 1 "
                         f"points, got {tuple(WVinv.shape)}")
    _check("WVinv", WVinv, (P, K, 6, 3))
    _check("t", t, (P, 3))
    if scratch is None:
        scratch = Scratch(WVinv)
    _check("partial", scratch.partial, (-(-P // CHUNK_POINTS), K, 6))
    _check("tickets", scratch.tickets, (-(-K // TILE_SLOTS),), torch.int32)
    dev = _device(WVinv.device)
    s = torch.empty((K, 6), dtype=torch.float32, device=dev)
    _launch(load_library().sdvl_ba_wvinv_t(
        WVinv.data_ptr(), t.data_ptr(), scratch.partial.data_ptr(),
        scratch.tickets.data_ptr(), s.data_ptr(), P, K, int(_vec(WVinv)),
        _counter(dev).data_ptr() + 8, _stream(dev)), "wvinv_t")
    return s


def cg_tail(s, U_d, Dinv, free, carry, max_it, tol):
    """One CG iteration from ``s`` on, as :func:`cg_tail_plain`: on CUDA
    one launch of the kernel, which writes the carry's tensors ``(x, r, p,
    rz, i)`` in place and returns the carry; on the CPU the plain version,
    which returns new tensors. ``s``, ``x``, ``r``, ``p`` (K, 6), ``U_d``,
    ``Dinv`` (K, 6, 6), ``free`` (K,), ``rz`` and ``tol`` () float32, ``i``
    and ``max_it`` () int32."""
    if not s.is_cuda:
        return cg_tail_plain(s, U_d, Dinv, free, carry, max_it, tol)
    x, r, p, rz, i = carry
    K = s.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"cg_tail takes 1 <= K <= {MAX_K} slots, got {K}")
    for name, v, shape in (("s", s, (K, 6)), ("U_d", U_d, (K, 6, 6)),
                           ("Dinv", Dinv, (K, 6, 6)), ("free", free, (K,)),
                           ("x", x, (K, 6)), ("r", r, (K, 6)),
                           ("p", p, (K, 6)), ("rz", rz, ()),
                           ("tol", tol, ())):
        _check(name, v, shape)
    _check("i", i, (), torch.int32)
    _check("max_it", max_it, (), torch.int32)
    dev = _device(s.device)
    _launch(load_library().sdvl_ba_cg_tail(
        s.data_ptr(), U_d.data_ptr(), Dinv.data_ptr(), free.data_ptr(),
        x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(),
        i.data_ptr(), max_it.data_ptr(), tol.data_ptr(), K,
        _counter(dev).data_ptr() + 16, _stream(dev)), "cg_tail")
    return carry
