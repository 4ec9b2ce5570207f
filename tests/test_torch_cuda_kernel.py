"""The CUDA kernels against their plain torch versions, on the card: the
detection kernel, the small eigensolver and the whole-map BA's CG kernels.

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

The whole-map BA's CG kernels (``ops/cuda/ba_pcg.py``) against their plain
versions at the Zurich map's shape and ragged ones, each tolerance stated
with its reason in its test; two replays of a captured iteration bit for
bit; refusals raise; ``ba.solve(method="cg")`` on the card takes them and
never the plain route.

The relocalizer's lane choice on the card (``torch.argmin`` of the lane
errors, the stable descending sort of the lane keys) follows the rules
``tests/test_torch_reloc_lanes.py`` holds to the JAX package on the CPU:
the first NaN error, else the first least (lane 0 when every error is
inf); NaN keys first, ties in index order.
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
    """The stream's three levels (a 480x640 pyramid), ``configs/euroc.cfg``'s
    (a 480x752 pyramid: 23.5, 11.75 and 5.875 cells of 32 across, a partial
    cell at every level), a small level, a ragged one (scalar staging: W %
    4 != 0) and an aligned shape at a base that is not 16-byte aligned
    (scalar staging too)."""
    if case in ("stream", "euroc"):
        shape = (480, 640) if case == "stream" else (480, 752)
        img = T(blocky_image(11, shape)).to(dev)
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
@pytest.mark.parametrize("case", ["stream", "euroc", "small", "ragged",
                                  "misaligned"])
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


CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
SHIPPED = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".cfg"))


def test_the_card_tests_cover_every_shipped_config():
    assert len(SHIPPED) == 7 and "euroc.cfg" in SHIPPED, SHIPPED


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["host", "stream"])
@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_detects_with_the_kernel(cuda_device, name, driver):
    """``SDVL(cfg, device="cuda")`` and ``SdvlStream(cfg, device="cuda")``
    with each of ``configs/*.cfg`` as shipped (each leaves
    ``use_pallas_detect`` off: the plain border rule; six are 640x480,
    ``euroc.cfg`` 752x480) launch the kernel once per frame, six frames
    each: the implementation follows the device, the config only the
    border rule."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene
    from sdvl_tpu_torch.pipeline.config import load_cfg
    from sdvl_tpu_torch.pipeline.sdvl import SDVL
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    cfg = load_cfg(os.path.join(CONFIGS, name))
    assert not cfg.sdvl.use_pallas_detect
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
    captures = (sum(g in slam._graphs for g in ("detect", "preprocess"))
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
@pytest.mark.parametrize("source", ["small_eig.cu", "graph_if.cu",
                                    "ba_pcg.cu"])
def test_kernels_keep_no_stack_and_spill_nothing(cuda_device, source):
    """``-Xptxas -v`` of a verbose build (into a library of its own name):
    every kernel of the source uses no stack frame and spills nothing
    (``ba_pcg.cu``'s two streaming kernels in both of their forms, 16-byte
    and single loads)."""
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
    want = {"small_eig.cu": {"eigh_kernel": 1, "svd3_kernel": 1},
            "graph_if.cu": {"set_condition_kernel": 1,
                            "launch_floor_kernel": 1},
            "ba_pcg.cu": {"wt_x_kernel": 2, "wvinv_t_kernel": 2,
                          "cg_tail_kernel": 1}}[source]
    for k, n in want.items():
        got = [v for f, v in found.items() if k in f]
        assert got == [(0, 0, 0)] * n, (k, found)


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


def _lane_errors(n: int) -> dict:
    nan, inf = float("nan"), float("inf")
    e = np.linspace(1.0, 2.0, n, dtype=np.float32)
    cases = {"nan_one": {5: nan}, "nan_two": {n - 1: nan, 7: nan},
             "nan_first": {0: nan}, "tie": {3: 0.5, 11: 0.5}}
    out = {}
    for name, vals in cases.items():
        out[name] = e.copy()
        for i, v in vals.items():
            out[name][i] = v
    out["all_inf"] = np.full(n, inf, np.float32)
    out["inf_and_nan"] = np.where(np.arange(n) == 9, nan, inf).astype(
        np.float32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 100, 1000])
def test_lane_choice_on_card(cuda_device, n):
    """The relocalizer's lane choice on the card follows the reference's
    rules, as ``tests/test_torch_reloc_lanes.py`` holds them on the CPU:
    ``argmin`` of the lane errors takes the first NaN, else the first least
    value (lane 0 when all are inf); the stable descending sort of the lane
    keys puts NaN keys first and ties in index order."""
    for name, e in _lane_errors(n).items():
        want = (int(np.flatnonzero(np.isnan(e))[0]) if np.isnan(e).any()
                else int(np.argmin(e)))
        got = int(torch.argmin(torch.from_numpy(e).to(cuda_device)))
        assert got == want, (name, got, want)
    rs = np.random.default_rng(n)
    key = -rs.integers(0, n // 4, n).astype(np.float32)    # many ties
    key[rs.choice(n, n // 10, replace=False)] = -np.inf     # empty slots
    key[rs.choice(n, 3, replace=False)] = np.nan            # NaN poses
    # NaN first, then descending, ties by index
    want = np.lexsort((np.arange(n), -np.nan_to_num(key, nan=0.0),
                       ~np.isnan(key)))
    got = torch.sort(torch.from_numpy(key).to(cuda_device), descending=True,
                     stable=True)[1].cpu().numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- the whole-map BA's CG
def _pcg_system(P, K, filled, dev, seed=0):
    """A seeded CG system on the card, as ``chip_smoke.ba_pcg_system``
    makes it: ``Wm``, ``WVinv`` (P, K, 6, 3) zero past ``filled`` slots
    and on three quarters of the rest, ``U_d`` and ``Dinv`` symmetric
    positive definite (row-major), the first two slots fixed, a carry."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    seen = torch.rand((P, K), generator=g, device=dev) < 0.25
    seen[:, filled:] = False
    eye = torch.eye(6, device=dev)
    A, B = normal(K, 6, 6), normal(K, 6, 6)
    free = torch.ones(K, device=dev)
    free[:2] = 0.0
    r, p = normal(K, 6) * free[:, None], normal(K, 6) * free[:, None]
    return dict(
        Wm=normal(P, K, 6, 3, scale=0.1) * seen[..., None, None],
        WVinv=normal(P, K, 6, 3, scale=0.1) * seen[..., None, None],
        U_d=A @ A.mT + 50.0 * eye,
        Dinv=torch.linalg.inv(B @ B.mT + 50.0 * eye).contiguous(),
        free=free, x=normal(K, 6),
        carry=(normal(K, 6), r, p, (r * p).sum().abs(),
               torch.zeros((), dtype=torch.int32, device=dev)),
        max_it=torch.tensor(10 ** 9, dtype=torch.int32, device=dev),
        tol=torch.zeros((), device=dev))


PCG_SHAPES = {"zurich": (4096, 1000, 320), "ragged_odd": (37, 13, 13),
              "ragged_even": (300, 130, 100)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PCG_SHAPES))
def test_ba_pcg_kernels_match_plain_on_card(cuda_device, case):
    """``wt_x``, ``wvinv_t`` (16-byte loads where K is even, single ones
    where it is odd) and ``cg_tail`` against their plain versions on the
    card, at the Zurich map's shape (4096 points, 1000 slots, 320 filled)
    and ragged ones (a partial slot tile and point chunk). Tolerance: each
    product entry within 3e-5 of the sum of its terms' magnitudes (both
    sides are float32 sums in other orders, of at most some 200 terms in
    sequence: 200 roundings of 2^-24 each, on each side); the tail's
    vectors and ``rz`` within 1e-4 of their largest entry (``alpha`` and
    ``beta`` are quotients of two sums of 6K products, each taken in
    another order); the count exactly."""
    from sdvl_tpu_torch.ops.cuda import ba_pcg

    m = _pcg_system(*PCG_SHAPES[case], cuda_device)
    Wm, WVinv, free, x = m["Wm"], m["WVinv"], m["free"], m["x"]
    for mask in (free, None):
        t = ba_pcg.wt_x(Wm, x, mask)
        err = (t - ba_pcg.wt_x_plain(Wm, x, mask)).abs()
        assert bool((err <= 3e-5 * ba_pcg.wt_x_plain(
            Wm.abs(), x.abs(), mask)).all()), float(err.max())
    t = ba_pcg.wt_x(Wm, x, free)
    s = ba_pcg.wvinv_t(WVinv, t)
    err = (s - ba_pcg.wvinv_t_plain(WVinv, t)).abs()
    assert bool((err <= 3e-5 * ba_pcg.wvinv_t_plain(WVinv.abs(),
                                                      t.abs())).all())
    got = ba_pcg.cg_tail(s, m["U_d"], m["Dinv"], free,
                         tuple(c.clone() for c in m["carry"]), m["max_it"],
                         m["tol"])
    want = ba_pcg.cg_tail_plain(s, m["U_d"], m["Dinv"], free, m["carry"],
                                m["max_it"], m["tol"])
    for a, b in zip(got[:4], want[:4]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert int(got[4]) == int(want[4]) == 1


@pytest.mark.cuda
def test_ba_pcg_frozen_lane_leaves_the_carry_on_card(cuda_device):
    """A carry whose condition is false (the count at its bound, or ``rz``
    at the tolerance) comes back from ``cg_tail`` bit for bit."""
    from sdvl_tpu_torch.ops.cuda import ba_pcg

    m = _pcg_system(300, 130, 100, cuda_device)
    s = ba_pcg.wvinv_t(m["WVinv"], ba_pcg.wt_x(m["Wm"], m["carry"][2],
                                               m["free"]))
    for max_it, tol in ((m["carry"][4].clone(), m["tol"]),
                        (m["max_it"], m["carry"][3].clone())):
        carry = tuple(c.clone() for c in m["carry"])
        ba_pcg.cg_tail(s, m["U_d"], m["Dinv"], m["free"], carry, max_it, tol)
        for a, b in zip(carry, m["carry"]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ba_pcg_replays_give_the_same_bits_on_card(cuda_device):
    """A CG iteration (``wt_x``, ``wvinv_t`` with its scratch, ``cg_tail``
    in place) captured once: two replays from the same carry give the same
    bits (no float atomics; the last block of a tile sums its chunks in
    chunk order), equal to the eager launches', and each replay counts one
    launch of each kernel."""
    from sdvl_tpu_torch.ops.cuda import ba_pcg

    m = _pcg_system(4096, 1000, 320, cuda_device, seed=1)
    scratch = ba_pcg.Scratch(m["WVinv"])
    bufs = tuple(c.clone() for c in m["carry"])

    def iteration():
        t = ba_pcg.wt_x(m["Wm"], bufs[2], m["free"])
        s = ba_pcg.wvinv_t(m["WVinv"], t, scratch)
        ba_pcg.cg_tail(s, m["U_d"], m["Dinv"], m["free"], bufs, m["max_it"],
                       m["tol"])

    iteration()
    eager = tuple(b.clone() for b in bufs)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for b, c in zip(bufs, m["carry"]):
            b.copy_(c)
        iteration()
    ba_pcg.reset_launches(cuda_device)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(bufs, eager))
    assert [ba_pcg.launches(cuda_device, k) for k in ba_pcg.KERNELS] == [
        2, 2, 2]
    assert scratch.tickets.tolist() == [0] * len(scratch.tickets)


@pytest.mark.cuda
def test_ba_pcg_refuses_what_the_kernels_cannot_take(cuda_device):
    """The wrapper raises on a tensor the kernels cannot take (type, shape,
    layout, more slots than shared memory holds), and a launch that the
    runtime refuses (too much shared memory) raises too."""
    from sdvl_tpu_torch.ops.cuda import ba_pcg

    m = _pcg_system(37, 14, 14, cuda_device)
    Wm, x, free = m["Wm"], m["x"], m["free"]
    for bad in (Wm.double(), Wm[:, :13], Wm.transpose(2, 3).contiguous()
                .transpose(2, 3)):
        with pytest.raises(ValueError):
            ba_pcg.wt_x(bad, x[:bad.shape[1]], None)
    with pytest.raises(ValueError):
        ba_pcg.wvinv_t(m["WVinv"], torch.zeros((37, 2), device=cuda_device))
    with pytest.raises(ValueError):
        ba_pcg.cg_tail(x, m["U_d"], m["Dinv"].mT, free, m["carry"],
                       m["max_it"], m["tol"])
    big = torch.zeros((1, ba_pcg.MAX_K + 2, 6, 3), device=cuda_device)
    with pytest.raises(ValueError):
        ba_pcg.wt_x(big, torch.zeros((ba_pcg.MAX_K + 2, 6),
                                     device=cuda_device))
    lib = ba_pcg.load_library()
    counter = ba_pcg._counter(Wm.device).data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.sdvl_ba_wt_x(Wm.data_ptr(), x.data_ptr(), None, x.data_ptr(),
                           1, 100000, 1, 0, counter, stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        ba_pcg._launch(err, "wt_x")
    # the refusal is not reported again by the next launch
    t = ba_pcg.wt_x(Wm, x, free)
    torch.cuda.synchronize()
    assert torch.isfinite(t).all()


@pytest.mark.cuda
def test_ba_solve_cg_takes_the_kernels_on_card(cuda_device):
    """``ba.solve(method="cg")`` on the card counts the kernel route and
    never the plain one, launches each kernel, and ends where the CPU's
    plain route ends (the tolerances of ``tests/test_torch_global_ba.py``,
    5e-4 on poses and 5e-3 on points)."""
    from sdvl_tpu_torch.ops.cuda import ba_pcg
    from sdvl_tpu_torch.solvers import ba
    from sdvl_tpu_torch.utils import trace

    rs = np.random.default_rng(3)
    K, P = 8, 96
    pts = rs.uniform([-3, -3, 4], [3, 3, 10], (P, 3)).astype(np.float32)
    poses = np.zeros((K, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = 0.08 * np.arange(K)
    p_cam = pts[:, None] + poses[None, :, 4:]
    uv = (p_cam[..., :2] / p_cam[..., 2:3]).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    init = poses.copy()
    init[2:, 4:] += rs.normal(0, 0.02, (K - 2, 3)).astype(np.float32)
    arrays = (init, fixed, pts, uv, np.ones((P, K), bool))
    counters = trace.tracer().counters
    before = (counters.get("ba.pcg.kernel", 0),
              counters.get("ba.pcg.plain", 0))
    ba_pcg._counter(cuda_device)   # made eagerly
    ba_pcg.reset_launches(cuda_device)
    got = ba.solve(ba.BAProblem(*(torch.from_numpy(a).to(cuda_device)
                                  for a in arrays)),
                   huber=0.05, stage_iters=(3, 4), method="cg")
    torch.cuda.synchronize()
    assert (counters.get("ba.pcg.kernel", 0) - before[0],
            counters.get("ba.pcg.plain", 0) - before[1]) == (7, 0)
    n = [ba_pcg.launches(cuda_device, k) for k in ba_pcg.KERNELS]
    cg = int(got.cg_iterations.sum())
    assert n[0] >= cg + 7 and n[1] >= cg + 7 and n[2] >= cg, (n, cg)
    want = ba.solve(ba.BAProblem(*(torch.from_numpy(a) for a in arrays)),
                    huber=0.05, stage_iters=(3, 4), method="cg")
    np.testing.assert_allclose(got.poses.cpu().numpy(), want.poses.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(got.points.cpu().numpy(),
                               want.points.numpy(), atol=5e-3)
