"""The CUDA detection kernel against its plain torch version, on the card.

Needs an NVIDIA GPU and ``nvcc``; skips with a reason anywhere else (a CUDA
kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda_kernel.py -q

Tolerance: none. The kernel keeps the plain version's float operation order
and is built without multiply-add contraction, so under both border rules
(``plain``: the reference's plain route, scored to the image edge;
``pallas``: its Pallas kernel's 4-px border cut) the score maps and the
cell results (position, score, validity, level) are bit-identical.
"""

import os

import numpy as np
import pytest
import torch

from sdvl_tpu_torch.ops import pyramid
from sdvl_tpu_torch.ops.cuda import detect
from sdvl_tpu_torch.pipeline.device_fsm import CAPTURE_PASSES
from torch_port_helpers import T, blocky_image

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
    captures = int("preprocess" in slam._graphs if driver == "host"
                   else slam.runner.graph is not None)
    assert (detect.launches() - before
            == len(frames) + CAPTURE_PASSES * captures)
    assert len(states) == len(frames)
