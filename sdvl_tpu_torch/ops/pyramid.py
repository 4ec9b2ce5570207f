"""Image pyramid construction as shift-add stencils.

Counterpart of ``sdvl_tpu/ops/pyramid.py``: one separable 5-tap binomial blur
(reflect-101 borders, as ``cv::pyrDown``) plus 2x decimation per level.
Written as padded-slice shift-adds in the reference's tap order rather than
``conv2d``, so that the float32 sums round the same way and no TF32
convolution path can change which pixels become corners.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Binomial 5-tap kernel -- the same kernel cv::pyrDown uses.
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _pad2d(img: torch.Tensor, pad, mode: str) -> torch.Tensor:
    """``F.pad`` of (..., H, W) images; ``pad`` = (left, right, top,
    bottom)."""
    H, W = img.shape[-2:]
    out = F.pad(img.reshape(-1, 1, H, W), pad, mode=mode)
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def _sep_filter(img: torch.Tensor, taps, mode: str = "reflect") -> torch.Tensor:
    """Separable odd-length filter via padded slices (no conv)."""
    r = len(taps) // 2
    H, W = img.shape[-2:]
    p = _pad2d(img, (0, 0, r, r), mode)
    v = sum(w * p[..., i: i + H, :] for i, w in enumerate(taps))
    p = _pad2d(v, (r, r, 0, 0), mode)
    return sum(w * p[..., i: i + W] for i, w in enumerate(taps))


def _blur_downsample(img: torch.Tensor) -> torch.Tensor:
    return _sep_filter(img, _K5)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int = 5) -> list:
    """Return ``levels`` images, level 0 = input (..., H, W) as float32 (a
    stack of images builds a stack per level). H and W must be divisible by
    ``2**(levels-1)`` (the stream crops frames once at ingest to guarantee
    it)."""
    out = [img.float().contiguous()]
    for _ in range(1, levels):
        out.append(_blur_downsample(out[-1]))
    return out


def gradient(img: torch.Tensor):
    """Central-difference gradients (dx, dy), same shape as img, with
    edge-replicated borders."""
    f = img.float()
    px = _pad2d(f, (1, 1, 0, 0), "replicate")
    dx = 0.5 * (px[:, 2:] - px[:, :-2])
    py = _pad2d(f, (0, 0, 1, 1), "replicate")
    dy = 0.5 * (py[2:] - py[:-2])
    return dx, dy
