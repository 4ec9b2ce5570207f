"""The CUDA kernels against their plain torch versions, on the card: the
detection kernel and the small eigensolver.

Needs an NVIDIA GPU and ``nvcc``; skips with a reason anywhere else (a CUDA
kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda_kernel.py -q

Tolerance: none. The kernel keeps the plain version's float operation order
and is built without multiply-add contraction, so under both border rules
(``plain``: the reference's plain route, scored to the image edge;
``pallas``: its Pallas kernel's 4-px border cut) the score maps and the
cell results (position, score, validity, level) are bit-identical.

The small eigensolver (``ops/cuda/small_eig.py``, float64 Jacobi) against
``torch.linalg.eigh`` and ``svd`` on the card, at the bootstrap's shapes
(a RANSAC batch of 128 9x9 ``A^T A``, one weighted 9x9, one 3x3
covariance, one 3x3 SVD), on near-degenerate matrices, on 1, 2, 5 and 8
rows, on a batch of 1000 (more than the kernel's blocks) and on a diagonal
with exact ties (which must come out in index order): eigen- and
singular values within 1e-5 of the largest in magnitude; each vector's
|cos| with the plain one at least 1 - 1e-4 where its value is apart from
the others by 1e-3 of the largest; ``A V = V diag(w)`` and ``U S Vh = A``
within 1e-5 of the largest. The ``eigh`` kernel's output is also held,
bit for bit, against the float64 numpy model of its parallel sweep
(``torch_port_helpers.jacobi_eigh_model``), cast to float32, and the
``svd3`` kernel's against the model of its sweep
(``torch_port_helpers.jacobi_svd3_model``) on ``svd3_cases`` (ties in
index order, ranks 0 to 2, 1000 matrices). ``ptxas`` (``-Xptxas -v``)
reports no stack frame and no spill for any kernel of
``csrc/small_eig.cu`` and ``csrc/graph_if.cu``.
"""

import os
import re

import numpy as np
import pytest
import torch

from sdvl_tpu_torch.ops import pyramid
from sdvl_tpu_torch.ops.cuda import detect, small_eig
from sdvl_tpu_torch.pipeline.device_fsm import CAPTURE_PASSES
from torch_port_helpers import (T, blocky_image, jacobi_eigh_model,
                                jacobi_svd3_model, svd3_cases)

FAST_T, ST_T = 10.0, 50.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode (chip_smoke.py runs this check on the card)")
    return torch.device("cuda")


def _assert_maps_equal(got, want, border="pallas"):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    if border == "pallas":
        assert not bool(torch.isfinite(got[:4]).any())
        assert not bool(torch.isfinite(got[:, -4:]).any())
    return int(torch.isfinite(got).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(120, 160), (64, 96), (123, 171),
                                   (480, 640)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    img = T(blocky_image(7, shape)).to(cuda_device)
    before = detect.launches()
    got = detect.fast_shi_tomasi_map(img, FAST_T, ST_T)
    torch.cuda.synchronize()
    assert detect.launches() == before + 1
    want = detect.fast_shi_tomasi_map_plain(img, FAST_T, ST_T)
    assert _assert_maps_equal(got, want) > 100


def _levels(case, dev):
    """The stream's three levels (a 480x640 pyramid), a small level, a
    ragged one (scalar staging: W % 4 != 0) and an aligned shape at a base
    that is not 16-byte aligned (scalar staging too)."""
    if case == "stream":
        img = T(blocky_image(11, (480, 640))).to(dev)
        return pyramid.build_pyramid(img, 3)
    if case == "small":
        return [T(blocky_image(12, (64, 96))).to(dev)]
    if case == "ragged":
        return [T(blocky_image(13, (123, 171))).to(dev)]
    img = T(blocky_image(14, (120, 160))).to(dev)
    buf = torch.empty(img.numel() + 1, device=dev)
    view = buf[1:].view(120, 160)
    view.copy_(img)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return [view]


def _assert_cells_equal(got, want, border="pallas"):
    maps, xy, score, valid, level = got
    pmaps, pxy, pscore, pvalid, plevel = want
    n = sum(_assert_maps_equal(a, b, border) for a, b in zip(maps, pmaps))
    assert n > 100
    assert torch.equal(valid, pvalid) and torch.equal(level, plevel)
    assert torch.equal(xy, pxy) and torch.equal(score, pscore)
    assert int(valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("border", detect.BORDERS)
@pytest.mark.parametrize("cell", [16, 32, 64])
@pytest.mark.parametrize("case", ["stream", "small", "ragged", "misaligned"])
def test_cells_match_plain_on_card(cuda_device, case, cell, border):
    """All levels in one launch: maps, and cell winners exactly the plain
    version's (per-level score map plus ``grid_best``), under both border
    rules."""
    levels = _levels(case, cuda_device)
    before = detect.launches()
    got = detect.fast_shi_tomasi_cells(levels, cell, FAST_T, ST_T, border)
    torch.cuda.synchronize()
    assert detect.launches() == before + 1
    want = detect.fast_shi_tomasi_cells_plain(levels, cell, FAST_T, ST_T,
                                              border)
    _assert_cells_equal(got, want, border)


@pytest.mark.cuda
@pytest.mark.parametrize("border", detect.BORDERS)
@pytest.mark.parametrize("shape", [(64, 96), (123, 171), (480, 640)])
def test_both_rules_bit_identical_at_the_border(cuda_device, shape, border):
    """Corners on the first and last rows and columns (where the plain rule
    reads edge-replicated pixels for FAST and wrapped ones for the Sobel
    derivatives, and counts zero beyond the edge in the box sums): the
    kernel's maps and cells equal the plain version's; only the plain rule
    scores there."""
    img = T(blocky_image(16, shape)).to(cuda_device)
    H, W = shape
    img[:3, 10:14] = 250.0
    img[H - 2:, W - 12:W - 9] = 0.0
    img[20:23, :2] = 240.0
    img[H // 2:H // 2 + 3, W - 2:] = 230.0
    got = detect.fast_shi_tomasi_cells([img], 16, FAST_T, ST_T, border)
    want = detect.fast_shi_tomasi_cells_plain([img], 16, FAST_T, ST_T,
                                              border)
    _assert_cells_equal(got, want, border)
    ring = torch.ones((H, W), dtype=torch.bool, device=cuda_device)
    ring[4:H - 4, 4:W - 4] = False
    assert bool(torch.isfinite(got[0][0][ring]).any()) == (border == "plain")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [16, 32])
def test_cells_tie_image_on_card(cuda_device, cell):
    """A texture that repeats every 8 px puts equal maxima in every cell,
    across the blocks of a cell too: the first in-cell index must win."""
    rng = np.random.default_rng(15)
    patch = rng.uniform(0, 50, (8, 8)).astype(np.float32)
    patch[2:5, 2:5] += 150.0                 # a bright square: corners
    img = T(patch).repeat(30, 40).to(cuda_device)          # 240x320
    got = detect.fast_shi_tomasi_cells([img], cell, FAST_T, ST_T, "pallas")
    want = detect.fast_shi_tomasi_cells_plain([img], cell, FAST_T, ST_T,
                                              "pallas")
    _assert_cells_equal(got, want)
    # ties really occur: a cell's best score appears more than once in it
    smap = want[0][0]
    H, W = smap.shape
    s = smap[: H // cell * cell, : W // cell * cell].reshape(
        H // cell, cell, W // cell, cell).permute(0, 2, 1, 3).flatten(2)
    best = s.max(dim=2, keepdim=True).values
    assert bool(((s == best) & torch.isfinite(best)).sum(2).gt(1).any())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    for bad in (torch.zeros((64, 96), dtype=torch.float64, device=cuda_device),
                torch.zeros((64, 96), device=cuda_device)[:, ::2],
                torch.zeros((2, 64, 96), device=cuda_device),
                torch.zeros((8, 96), device=cuda_device)):
        with pytest.raises(ValueError):
            detect.fast_shi_tomasi_map(bad)
        with pytest.raises(ValueError):
            detect.fast_shi_tomasi_cells(
                [torch.zeros((64, 96), device=cuda_device), bad], 32)
    ok = torch.zeros((64, 96), device=cuda_device)
    for levels, cell in (([ok] * 5, 32), ([ok], 0), ([ok], -1),
                         ([ok, ok.cpu()], 32)):
        with pytest.raises(ValueError):
            detect.fast_shi_tomasi_cells(levels, cell)


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["host", "stream"])
def test_shipped_config_detects_with_the_kernel(cuda_device, driver):
    """``SDVL(cfg, device="cuda")`` and ``SdvlStream(cfg, device="cuda")``
    with ``configs/tum_f1.cfg`` as shipped (which leaves
    ``use_pallas_detect`` off: the plain border rule) launch the kernel once
    per frame: the implementation follows the device, the config only the
    border rule."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene
    from sdvl_tpu_torch.pipeline.config import load_cfg
    from sdvl_tpu_torch.pipeline.sdvl import SDVL
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    cfg = load_cfg(os.path.join(os.path.dirname(__file__), os.pardir,
                                "configs", "tum_f1.cfg"))
    c = cfg.camera
    scene = PlaneScene(fx=c.fx, fy=c.fy, cx=c.u0, cy=c.v0, width=c.width,
                       height=c.height, plane_z=4.0, dist=c.dist)
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in scene.trajectory(6, translation_amp=1.0)]
    before = detect.launches()
    if driver == "host":
        slam = SDVL(cfg, device="cuda")
        states = [slam.handle_frame(f)["state"] for f in frames]
    else:
        slam = SdvlStream(cfg, device="cuda")
        for f in frames:
            slam.feed(f)
        states = slam.result().states.tolist()
    torch.cuda.synchronize()
    # the kernel counts its own launches: one per frame, and one in each
    # eager pass before the capture of a graph that holds it (the stream's
    # step, the host driver's locked preprocess)
    captures = (sum(name in slam._graphs for name in ("detect",
                                                      "preprocess"))
                if driver == "host" else int(slam.runner.graph is not None))
    assert (detect.launches() - before
            == len(frames) + CAPTURE_PASSES * captures)
    assert len(states) == len(frames)


# ---------------------------------------------------------- small eigensolver
def _eig_cases(seed=0):
    """name -> (..., n, n) float32 symmetric matrices at the bootstrap's
    shapes, and near-degenerate ones."""
    rs = np.random.default_rng(seed)
    uv = rs.uniform(-0.6, 0.6, (64, 2))
    uvb = uv + rs.normal(0, 0.02, (64, 2))
    x, y, xp, yp = uv[:, 0], uv[:, 1], uvb[:, 0], uvb[:, 1]
    one, zero = np.ones_like(x), np.zeros_like(x)
    A = np.concatenate([
        np.stack([x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp], -1),
        np.stack([zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp], -1)])
    w = np.zeros((128, 64))
    for h in range(128):            # four points per RANSAC hypothesis
        w[h, rs.choice(64, 4, replace=False)] = 1.0
    w2 = np.concatenate([w, w], 1)
    ransac = np.einsum("ni,nj,hn->hij", A, A, w2)
    refit = np.einsum("ni,nj,n->ij", A, A, np.repeat(
        rs.uniform(0, 1, 64) > 0.3, 2).astype(float))
    pts = rs.normal(0, 1, (200, 3)) * [2.0, 1.5, 0.01]
    cov = pts.T @ pts / 200
    Q = np.linalg.qr(rs.normal(0, 1, (9, 9)))[0]
    near = Q @ np.diag([1, 1, 1 + 1e-7, 2, 3, 3, 3, 5, 8]) @ Q.T
    cases = {
        "ransac_9x9": ransac, "refit_9x9": refit, "cov_3x3": cov,
        "near_degenerate_9x9": near, "identity_3x3": np.eye(3),
        "zero_4x4": np.zeros((4, 4)),
    }
    for n in (1, 2, 5, 8):          # odd and even n: with and without padding
        m = rs.normal(0, 1, (16, n, n))
        cases[f"n{n}"] = m + np.swapaxes(m, 1, 2)
    # more matrices than the kernel has blocks (the grid strides over them)
    cases["batch_1000"] = ransac[rs.integers(0, 128, 1000)] \
        * rs.uniform(0.5, 2.0, (1000, 1, 1))
    cases["ties"] = np.diag([2.0, 2.0, 1.0, 3.0, 1.0, 2.0])
    return cases


def _assert_vectors_close(got, want, vals, tol=1e-4, gap=1e-3):
    """|cos| of each column pair >= 1 - tol where its value is apart from
    the others by ``gap`` of the largest magnitude."""
    vals = vals.reshape(-1, vals.shape[-1])
    got = got.reshape((-1,) + got.shape[-2:])
    want = want.reshape((-1,) + want.shape[-2:])
    n = vals.shape[-1]
    for b in range(vals.shape[0]):
        scale = max(float(vals[b].abs().max()), 1e-30)
        for k in range(n):
            others = torch.cat([vals[b, :k], vals[b, k + 1:]])
            if n > 1 and float((others - vals[b, k]).abs().min()) \
                    < gap * scale:
                continue
            cos = float(torch.dot(got[b, :, k], want[b, :, k]).abs())
            assert cos >= 1 - tol, (b, k, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ransac_9x9", "refit_9x9", "cov_3x3",
                                  "near_degenerate_9x9", "identity_3x3",
                                  "zero_4x4", "n1", "n2", "n5", "n8",
                                  "batch_1000", "ties"])
def test_small_eigh_matches_plain_on_card(cuda_device, case):
    A = T(_eig_cases()[case], torch.float32).to(cuda_device)
    before = small_eig.launches(kernel="eigh")
    w, V = small_eig.eigh(A)
    torch.cuda.synchronize()
    assert small_eig.launches(kernel="eigh") - before == 1
    # the kernel is the parallel sweep of the float64 model, operation for
    # operation (IEEE division and sqrt, no multiply-add contraction)
    n = A.shape[-1]
    wm, Vm, sweeps = jacobi_eigh_model(A.cpu().numpy(),
                                       small_eig.jacobi_rounds(n))
    assert (sweeps >= 1).all()
    assert np.array_equal(w.cpu().numpy().reshape(-1, n),
                          wm.astype(np.float32))
    assert np.array_equal(V.cpu().numpy().reshape(-1, n, n),
                          Vm.astype(np.float32))
    if case == "ties":              # equal values in index order
        order = [2, 4, 0, 1, 5, 3]
        eye = torch.eye(6, device=cuda_device)
        assert torch.equal(w, A.diagonal()[order])
        assert torch.equal(V, eye[:, order])
    wp, Vp = small_eig.eigh_plain(A)
    scale = float(wp.abs().max()) or 1.0
    assert w.shape == wp.shape and V.shape == Vp.shape
    assert float((w - wp).abs().max()) <= 1e-5 * scale
    assert bool((w[..., 1:] >= w[..., :-1]).all())     # ascending
    resid = A @ V - V * w[..., None, :]
    assert float(resid.abs().max()) <= 1e-5 * scale
    _assert_vectors_close(V, Vp, wp)


def _svd3_case(case):
    if case == "batch":         # 64 random matrices
        rs = np.random.default_rng(1)
        rs.normal(0, 0.2, (3, 3))
        return rs.normal(0, 1, (64, 3, 3))
    return svd3_cases()[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*svd3_cases(), "batch"])
def test_small_svd3_matches_plain_on_card(cuda_device, case):
    A = T(_svd3_case(case), torch.float32).to(cuda_device)
    before = small_eig.launches(kernel="svd3")
    U, S, Vh = small_eig.svd3(A)
    torch.cuda.synchronize()
    assert small_eig.launches(kernel="svd3") - before == 1
    # the kernel is the sweep of the float64 model, operation for operation
    Um, Sm, Vhm, sweeps = jacobi_svd3_model(A.cpu().numpy())
    assert (sweeps >= 1).all()
    for got, want in ((U, Um), (S, Sm), (Vh, Vhm)):
        assert np.array_equal(got.cpu().numpy().reshape(want.shape),
                              want.astype(np.float32))
    if case == "ties":          # values 1, 1, 2: columns 2, 0, 1
        order = [2, 0, 1]
        eye = torch.eye(3, device=cuda_device)
        assert torch.equal(S, A.diagonal()[order])
        assert torch.equal(Vh, eye[order]) and torch.equal(U, eye[:, order])
    Up, Sp, Vhp = small_eig.svd3_plain(A)
    scale = float(Sp.abs().max())
    assert float((S - Sp).abs().max()) <= 1e-5 * scale
    assert bool((S[..., 1:] <= S[..., :-1]).all())     # descending
    recon = U @ torch.diag_embed(S) @ Vh
    assert float((recon - A).abs().max()) <= 1e-5 * scale
    eye = torch.eye(3, device=cuda_device)
    assert float((U.mT @ U - eye).abs().max()) <= 1e-5
    assert float((Vh @ Vh.mT - eye).abs().max()) <= 1e-5
    _assert_vectors_close(U, Up, Sp)
    _assert_vectors_close(Vh.mT, Vhp.mT, Sp)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["small_eig.cu", "graph_if.cu"])
def test_kernels_keep_no_stack_and_spill_nothing(cuda_device, source):
    """``-Xptxas -v`` of a verbose build (into a library of its own name):
    every kernel of the source uses no stack frame and spills nothing."""
    name = f"libsdvl_ptxas_{source.split('.')[0]}.so"
    detect.build_library(verbose=True, source=os.path.join(
        detect._PKG_DIR, "csrc", source), name=name)
    found, kernel = {}, None
    for line in detect.BUILD_LOGS[name].splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            found[kernel] = tuple(int(x) for x in m.groups())
    want = {"small_eig.cu": ("eigh_kernel", "svd3_kernel"),
            "graph_if.cu": ("set_condition_kernel",
                            "launch_floor_kernel")}[source]
    for k in want:
        got = [v for f, v in found.items() if k in f]
        assert got == [(0, 0, 0)], (k, found)


@pytest.mark.cuda
def test_small_eig_refuses_what_the_kernel_cannot_take(cuda_device):
    for bad in (torch.zeros((10, 10), device=cuda_device),
                torch.zeros((3, 4), device=cuda_device),
                torch.zeros((3, 3), dtype=torch.float64,
                            device=cuda_device)):
        with pytest.raises(ValueError):
            small_eig.eigh(bad)
    with pytest.raises(ValueError):
        small_eig.svd3(torch.zeros((4, 4), device=cuda_device))
