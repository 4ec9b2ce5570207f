"""Fused FAST-9/16 + Shi-Tomasi detection with per-cell selection: CUDA
kernel, wrapper, plain version.

Replaces the TPU kernel ``sdvl_tpu/ops/pallas/detect.py::fast_shi_tomasi_map``
(its row-tiled call for H > 80 and its single-block call alike) together with
the per-cell selection that consumes its output (``_grid_best`` of
``sdvl_tpu/ops/fast.py``), and the reference's plain route
(``fast_corner_mask`` + ``shi_tomasi`` + ``_grid_best``) as well: the two
differ in their border rule, chosen by ``border``. The kernel is
``csrc/detect.cu``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use
into ``sdvl_tpu_torch/_build/`` and bound through ``ctypes``. One launch
covers all levels of a frame.

Output contract, for each (H, W) float32 level:

* the score map. ``border="pallas"`` (the Pallas kernel's rule): the
  Shi-Tomasi min-eigenvalue score where the pixel passes the FAST segment
  test, lies at least 4 px inside the image and scores above
  ``st_threshold``; ``-inf`` elsewhere. ``border="plain"`` (the plain
  route's): the score wherever the pixel passes the FAST test, whatever the
  score, ``-inf`` elsewhere, with no border cut; FAST samples edge-replicated
  pixels, the Sobel derivatives wrap at the image edge (``roll``), the 4x4
  box sums count zero outside the image;
* one corner slot per cell of the cropped ``(H // cell) x (W // cell)`` grid:
  its best pixel of the map by :func:`grid_best`'s rule (highest score, then
  the smallest in-cell index; an all ``-inf`` cell gives index 0), at level-0
  coordinates, with its score (0 where it is ``-inf``), valid where the score
  is above ``st_threshold``. Under the plain rule an invalid cell keeps the
  position and score of its best FAST corner, as the reference's does.

Bound on an H100 (3.35 TB/s): memory -- one float32 read and one float32
write of every level plus 8 bytes per cell, 3.23 MB at the three preset
levels, against ~77 float operations per pixel. What the kernel does about
it is in the note of ``csrc/detect.cu``.

:func:`fast_shi_tomasi_cells` and :func:`fast_shi_tomasi_map` take the plain
torch version for CPU tensors only. For CUDA tensors they launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from typing import Sequence

import torch
import torch.nn.functional as F

from ...utils import trace

_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9
_BORDER = 4
BORDERS = ("plain", "pallas")   # the reference's two border rules
MAX_LEVELS = 4      # csrc/detect.cu MAX_LEVELS
MAX_CELL = 32768    # in-cell index cy * cell + cx must fit 31 bits
_INT32_MIN = -(1 << 31)
_LOW32 = 0xFFFFFFFF

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG_DIR, "csrc", "detect.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# library name -> the compiler's output of its last verbose build (with
# ``-Xptxas -v``: each kernel's registers, stack frame and spills)
BUILD_LOGS = {}

_lib = None
_lib_lock = threading.Lock()
# per CUDA device index, the () int64 count of the kernel's launches, added
# to by the kernel itself (a launch replayed from a CUDA graph included)
_counters = {}


def _find_nvcc() -> str:
    candidates = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "detection kernel is built from csrc/detect.cu at first use"
    )


def build_library(verbose: bool = False, source=SOURCE,
                  name: str = "libsdvl_detect.so") -> str:
    """Compile ``source`` (default ``csrc/detect.cu``; a path, or a tuple
    of paths) into ``_build/<name>`` and return its path. Several sources
    are one translation unit (``_build/<name>.cu`` includes them in turn):
    ``nvcc`` compiles each unit's host code and headers anew, some two
    seconds of set-up a file. Raises when the compiler is missing or fails.
    Every build counts in the process tracer's ``kernels.builds``, and the
    compiler's seconds in ``kernels.build_s`` (``utils/trace.py``), failed
    builds too."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    if not isinstance(source, str):
        unit = out + ".cu"
        with open(unit, "w") as f:
            f.writelines(f'#include "{os.path.abspath(p)}"\n' for p in source)
        source = unit
    cmd = [_find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", out, source]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        tracer = trace.tracer()
        tracer.count("kernels.builds")
        tracer.count("kernels.build_s", time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        print(BUILD_LOGS[name], flush=True)
    return out


def bind_library(path: str):
    """Load a built kernel library and declare its C entry point."""
    lib = ctypes.CDLL(path)
    fn = lib.sdvl_detect_levels
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def load_library(verbose: bool = False):
    """Build (once per process) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind_library(build_library(verbose=verbose))
    return _lib


def _counter(dev: torch.device) -> torch.Tensor:
    """The launch counter of ``dev``, made at the first launch there. A
    graph holds its address, so it must exist before a capture."""
    c = _counters.get(dev.index)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the detection kernel's first launch on a device must be "
                "eager: a CUDA graph cannot make its launch counter")
        c = _counters[dev.index] = torch.zeros((), dtype=torch.int64,
                                               device=dev)
    return c


def reset_launches() -> None:
    """Set every device's launch count to 0 (on the device's current
    stream, without synchronising)."""
    for c in _counters.values():
        c.zero_()


def launches() -> int:
    """The kernel's launches on every device since :func:`reset_launches`
    (or the first launch), as the kernel counted them. Reads the counters
    back: waits for the work before it on the current streams."""
    return sum(int(c) for c in _counters.values())


def _check_border(border: str) -> None:
    if border not in BORDERS:
        raise ValueError(f"border {border!r} is not one of {BORDERS}")


def _launch(levels: Sequence[torch.Tensor], cell: int, fast_threshold: float,
            st_threshold: float, lib=None, border: str = "pallas"):
    """One kernel launch over ``levels`` (CUDA tensors) under the ``border``
    rule, with ``lib`` or the package's library. Returns the maps and the
    (sum of cells,) int64 key buffer (``cell`` = 0: no cells). The kernel
    adds 1 to the device's launch counter each time it runs."""
    _check_border(border)
    n = len(levels)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, got {n}")
    if not 0 <= cell <= MAX_CELL:
        raise ValueError(f"cell {cell} outside 1..{MAX_CELL}")
    dev = levels[0].device
    dims, n_cells = [], 0
    for img in levels:
        if (img.dtype != torch.float32 or img.dim() != 2
                or not img.is_contiguous() or img.device != dev):
            raise ValueError(
                "the detection kernel takes contiguous (H, W) float32 "
                f"tensors on one device, got {tuple(img.shape)} {img.dtype} "
                f"{img.device} contiguous={img.is_contiguous()}"
            )
        H, W = img.shape
        if H < 2 * _BORDER + 1 or W < 2 * _BORDER + 1:
            raise ValueError(f"image {H}x{W} smaller than the 9x9 stencil")
        # 16-byte cp.async staging needs an aligned base and row pitch
        dims += [H, W, int(W % 4 == 0 and img.data_ptr() % 16 == 0)]
        if cell:
            n_cells += (H // cell) * (W // cell)
    lib = lib or load_library()
    maps = [torch.empty_like(img) for img in levels]
    keys = torch.empty(n_cells, dtype=torch.int64, device=dev)
    counter = _counter(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdvl_detect_levels(
            (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels]),
            (ctypes.c_void_p * n)(*[m.data_ptr() for m in maps]),
            (ctypes.c_int * (3 * n))(*dims), n, cell, int(border == "plain"),
            float(fast_threshold), float(st_threshold), keys.data_ptr(),
            counter.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"detection kernel launch failed: CUDA error {err}")
    return maps, keys


# ------------------------------------------------------------ cell keys
def encode_keys(score: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit cell key of each pixel, as the bits of a uint64
    held in int64: high word the order-preserving bits of ``score`` (-0.0
    made +0.0; sign clear: bits | 0x80000000, sign set: ~bits), low word the
    complement of the in-cell index ``idx``. The unsigned maximum over a cell
    is :func:`grid_best`'s winner."""
    s = torch.where(score == 0, torch.zeros_like(score), score)
    b = s.float().view(torch.int32)
    hi = torch.where(b >= 0, b ^ _INT32_MIN, ~b)
    return hi.long() * (1 << 32) + (idx.long() ^ _LOW32)


def decode_keys(keys: torch.Tensor):
    """Inverse of :func:`encode_keys`: (score float32, in-cell index int64)."""
    hi = (keys >> 32).to(torch.int32)
    bits = torch.where(hi < 0, hi ^ _INT32_MIN, ~hi)
    return bits.view(torch.float32), (keys & _LOW32) ^ _LOW32


@functools.lru_cache(maxsize=None)   # never evicted: graphs read them
def _cell_grid(shapes, cell: int, device: str):
    """Per cell of all levels: origin (x, y) in level pixels (int64),
    level-0 scale (float32, (n, 1)) and level (int32). Built once per
    shapes; shared, never written to."""
    origin, scale, level = [], [], []
    for l, (H, W) in enumerate(shapes):
        gh, gw = H // cell, W // cell
        g = torch.arange(gh * gw)
        origin.append(torch.stack((g % gw, g // gw), -1) * cell)
        scale.append(torch.full((gh * gw, 1), float(1 << l)))
        level.append(torch.full((gh * gw,), l, dtype=torch.int32))
    return tuple(torch.cat(t).to(device) for t in (origin, scale, level))


def _cells_from_keys(keys, shapes, cell: int, st_threshold: float):
    """Corner slots of all levels from the kernel's concatenated keys."""
    best, idx = decode_keys(keys)
    origin, scale, level = _cell_grid(shapes, cell, str(keys.device))
    xy = (origin + torch.stack((idx % cell, idx // cell), -1)) * scale
    return (xy, torch.where(torch.isfinite(best), best, 0.0),
            best > st_threshold, level.clone())


def grid_best(score_map: torch.Tensor, mask: torch.Tensor, cell: int):
    """Best-scoring masked pixel per cell. Returns (gh*gw,) xy/score/valid.
    The image is cropped to a whole number of cells. ``argmax`` takes the
    first maximum, as the reference's does."""
    H, W = score_map.shape
    gh, gw = H // cell, W // cell
    s = torch.where(mask, score_map,
                    torch.full_like(score_map, float("-inf")))
    s = s[: gh * cell, : gw * cell].reshape(gh, cell, gw, cell)
    s = s.permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    idx = torch.argmax(s, dim=1)
    best = torch.gather(s, 1, idx[:, None])[:, 0]
    cy, cx = idx // cell, idx % cell
    g = torch.arange(gh * gw, device=score_map.device)
    gy, gx = g // gw, g % gw
    x = (gx * cell + cx).float()
    y = (gy * cell + cy).float()
    valid = torch.isfinite(best)
    return (torch.stack([x, y], dim=-1),
            torch.where(valid, best, torch.zeros_like(best)), valid)


# ------------------------------------------------------- plain versions
def _any_arc(flags):
    """Circular run of >= 9 among 16 boolean planes (prefix-AND doubling)."""
    cur, run = list(flags), 1
    while run * 2 <= _ARC:
        cur = [cur[s] & cur[(s + run) % 16] for s in range(16)]
        run *= 2
    if run < _ARC:
        cur = [cur[s] & flags[(s + run) % 16] for s in range(16)]
    hit = cur[0]
    for s in range(1, 16):
        hit = hit | cur[s]
    return hit


def segment_test(f: torch.Tensor, pad: torch.Tensor, r: int,
                 threshold: float) -> torch.Tensor:
    """FAST-9/16 on ``f`` (H, W), neighbours read from ``pad``, which is
    ``f`` padded by ``r >= 3`` on every side."""
    H, W = f.shape
    hi = f + threshold
    lo = f - threshold
    bright, dark = [], []
    for dx, dy in _CIRCLE:
        nb = pad[r + dy: r + dy + H, r + dx: r + dx + W]
        bright.append(nb > hi)
        dark.append(nb < lo)
    return _any_arc(bright) | _any_arc(dark)


def fast_shi_tomasi_map_plain(img: torch.Tensor, fast_threshold: float = 10.0,
                              st_threshold: float = 50.0,
                              half_box: int = 2) -> torch.Tensor:
    """The kernel's score map in torch ops, same output contract.

    Reads outside the image are edge-clamped; they only reach the 4-px
    border, which is ``-inf`` by contract. The float operation order is the
    TPU kernel's, so interior scores agree with it to rounding.
    """
    f = img.float()
    H, W = f.shape
    R = _BORDER
    pad = F.pad(f[None, None], (R, R, R, R), mode="replicate")[0, 0]

    corner = segment_test(f, pad, R, fast_threshold)

    # Sobel-smoothed central differences, on the image padded by 2 so the
    # box window can read them: work on the R-padded plane throughout.
    fy = torch.zeros_like(pad)
    fx = torch.zeros_like(pad)
    fy[1:-1] = pad[2:] - pad[:-2]
    fx[:, 1:-1] = pad[:, 2:] - pad[:, :-2]
    dxp = torch.zeros_like(pad)
    dyp = torch.zeros_like(pad)
    dxp[1:-1] = 0.25 * (fx[:-2] + 2.0 * fx[1:-1] + fx[2:])
    dyp[:, 1:-1] = 0.25 * (fy[:, :-2] + 2.0 * fy[:, 1:-1] + fy[:, 2:])
    Wp = pad.shape[1]

    def boxsum(p):
        """p is an R-padded plane; returns the (H, W) box sum over offsets
        -half_box .. half_box-1, down the columns first."""
        v = torch.zeros((H, Wp), dtype=p.dtype, device=p.device)
        for i in range(-half_box, half_box):
            v = v + p[R + i: R + i + H]
        h = torch.zeros((H, W), dtype=p.dtype, device=p.device)
        for j in range(-half_box, half_box):
            h = h + v[:, R + j: R + j + W]
        return h

    box = 2 * half_box
    dxx = boxsum(dxp * dxp)
    dyy = boxsum(dyp * dyp)
    dxy = boxsum(dxp * dyp)
    tr = dxx + dyy
    det_term = torch.sqrt(((dxx - dyy) ** 2 + 4.0 * dxy * dxy).clamp_min(0.0))
    score = 0.5 * (tr - det_term) / (box * box)

    interior = torch.zeros((H, W), dtype=torch.bool, device=f.device)
    interior[R: H - R, R: W - R] = True
    keep = corner & interior & (score > st_threshold)
    return torch.where(keep, score, torch.full_like(score, float("-inf")))


def fast_corner_mask(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """The reference's dense FAST-9/16 segment test with edge-replicated
    borders (``fast_corner_mask`` of ``sdvl_tpu/ops/fast.py``). Returns
    (H, W) bool."""
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return segment_test(img, pad, 3, threshold)


def shi_tomasi(img: torch.Tensor, half_box: int = 2) -> torch.Tensor:
    """The reference's dense min-eigenvalue (Shi-Tomasi) response map, (H, W)
    (``shi_tomasi`` of ``sdvl_tpu/ops/fast.py``): Sobel 3x3 derivatives
    wrapping at the image edge (its ``roll``), a ``2*half_box`` box sum of the
    structure tensor anchored like OpenCV's boxFilter with zeros outside the
    image (its ``pad``), min eigenvalue normalized by the window area."""
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


def plain_route_map(img: torch.Tensor,
                    fast_threshold: float = 10.0) -> torch.Tensor:
    """The score map of the plain border rule in torch ops: the reference's
    ``shi_tomasi`` where its ``fast_corner_mask`` holds, ``-inf``
    elsewhere."""
    score = shi_tomasi(img)
    return torch.where(fast_corner_mask(img, fast_threshold), score,
                       torch.full_like(score, float("-inf")))


def fast_shi_tomasi_cells_plain(levels: Sequence[torch.Tensor], cell: int = 32,
                                fast_threshold: float = 10.0,
                                st_threshold: float = 50.0,
                                border: str = "plain"):
    """The kernel's function in torch ops on any device: per level the
    ``border`` rule's score map, then :func:`grid_best` on it (for the plain
    rule the reference's ``fast_corner_mask`` + ``shi_tomasi`` +
    ``_grid_best``). Same outputs as :func:`fast_shi_tomasi_cells`."""
    _check_border(border)
    maps, xy, score, valid, level = [], [], [], [], []
    for l, img in enumerate(levels):
        if border == "plain":
            smap = plain_route_map(img, fast_threshold)
        else:
            smap = fast_shi_tomasi_map_plain(img, fast_threshold, st_threshold)
        p, best, ok = grid_best(smap, torch.isfinite(smap), cell)
        maps.append(smap)
        xy.append(p * float(1 << l))
        score.append(best)
        valid.append(ok & (best > st_threshold))
        level.append(torch.full((p.shape[0],), l, dtype=torch.int32,
                                device=img.device))
    return (maps, torch.cat(xy), torch.cat(score), torch.cat(valid),
            torch.cat(level))


# ------------------------------------------------------------- wrappers
def fast_shi_tomasi_cells(levels: Sequence[torch.Tensor], cell: int = 32,
                          fast_threshold: float = 10.0,
                          st_threshold: float = 50.0, border: str = "plain"):
    """Score maps and per-cell corners of up to four pyramid levels under the
    ``border`` rule (``"plain"``: the reference's plain route, its default;
    ``"pallas"``: its Pallas kernel's).

    Returns ``(maps, xy, score, valid, level)``: the (H_l, W_l) score maps,
    then one slot per cell of every level in level order -- position at
    level-0 coordinates (N, 2) float32, score (N,) (0 where invalid), valid
    (N,) bool, level (N,) int32.

    CUDA tensors: one kernel launch for all levels on the current stream (no
    synchronisation), counted on the device (:func:`launches`); then ~15 torch ops decode the cells of all
    levels together. CPU tensors: the plain version.
    """
    if not levels[0].is_cuda:
        return fast_shi_tomasi_cells_plain(levels, cell, fast_threshold,
                                           st_threshold, border)
    if cell < 1:
        raise ValueError(f"cell {cell} outside 1..{MAX_CELL}")
    maps, keys = _launch(levels, cell, fast_threshold, st_threshold,
                         border=border)
    shapes = tuple(tuple(m.shape) for m in maps)
    return (maps, *_cells_from_keys(keys, shapes, cell, st_threshold))


def fast_shi_tomasi_map(img: torch.Tensor, fast_threshold: float = 10.0,
                        st_threshold: float = 50.0) -> torch.Tensor:
    """Masked Shi-Tomasi score map of one (H, W) float32 level, the
    counterpart of the TPU function.

    CUDA tensor: launches the same kernel with one level and no cells (no
    synchronisation), counted on the device. CPU tensor: the plain version.
    """
    if img.is_cuda:
        return _launch([img], 0, fast_threshold, st_threshold)[0][0]
    return fast_shi_tomasi_map_plain(img, fast_threshold, st_threshold)
