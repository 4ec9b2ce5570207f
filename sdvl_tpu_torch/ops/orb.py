"""ORB-style rotated-BRIEF descriptors and Hamming matching, batched.

Counterpart of ``sdvl_tpu/ops/orb.py``: intensity-centroid orientation over
a circular patch, a 256-pair steered binary test on the module's own seeded
Gaussian pair pattern (the same pattern as the reference, so descriptors in a
loaded map match descriptors computed here), and SWAR-popcount Hamming
distance.

Descriptors are (N, 8) int64 tensors whose low 32 bits hold the reference's
uint32 words: torch's uint32 has no shifts or products, and ``>>`` on int32
is arithmetic. The popcount masks after every step, so the high bits stay 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import interp

PATCH_RADIUS = 15  # 31x31 patch
N_BITS = 256
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def _make_pattern(radius: int = PATCH_RADIUS, seed: int = 7) -> np.ndarray:
    """(256, 4) float32 of (x1, y1, x2, y2) test pairs, N(0, (2r/5)^2)
    clipped to the patch."""
    rs = np.random.RandomState(seed)
    sigma = radius / 5.0 * 2.0
    pts = rs.normal(0.0, sigma, size=(N_BITS, 4))
    return np.clip(pts, -radius + 1, radius - 1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _circle_offsets(r: int) -> np.ndarray:
    d = np.arange(-r, r + 1)
    oy, ox = np.meshgrid(d, d, indexing="ij")
    keep = (ox * ox + oy * oy) <= r * r
    return np.stack([ox[keep], oy[keep]], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)   # never evicted: graphs read them
def _table(kind: str, radius: int, device: str) -> torch.Tensor:
    """Device copies of the static tables, made once per device."""
    arr = _circle_offsets(radius) if kind == "circle" else \
        _make_pattern(radius).reshape(N_BITS * 2, 2)
    return torch.from_numpy(arr.copy()).to(device)


def orientations(img: torch.Tensor, centers: torch.Tensor,
                 radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Intensity-centroid orientation (radians) at each center (N, 2):
    moments m01, m10 over the circular patch at integer pixels."""
    circle = _table("circle", radius, str(img.device))
    pos = centers[:, None, :] + circle[None]           # (N, M, 2)
    vals = interp.nearest(img, pos)                    # (N, M)
    m10 = vals @ circle[:, 0]
    m01 = vals @ circle[:, 1]
    return torch.atan2(m01, m10)


def descriptors(img: torch.Tensor, centers: torch.Tensor,
                angles: torch.Tensor | None = None,
                radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Rotated-BRIEF descriptors, (N, 8) int64 words of 32 bits each.
    ``radius`` = ``orb_size // 2``."""
    if angles is None:
        angles = orientations(img, centers, radius=radius)
    ca, sa = torch.cos(angles), torch.sin(angles)
    pts = _table("pattern", radius, str(img.device))   # both endpoints
    x = pts[None, :, 0] * ca[:, None] - pts[None, :, 1] * sa[:, None]
    y = pts[None, :, 0] * sa[:, None] + pts[None, :, 1] * ca[:, None]
    pos = centers[:, None, :] + torch.stack([x, y], dim=-1)  # (N, 512, 2)
    v = interp.nearest(img, pos).reshape(-1, N_BITS, 2)
    bits = (v[..., 0] < v[..., 1]).long()              # (N, 256)
    shifts = torch.arange(32, dtype=torch.int64, device=img.device)
    words = bits.reshape(-1, 8, 32) << shifts[None, None, :]
    return torch.sum(words, dim=-1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Branch-free SWAR popcount of the low 32 bits of int64 lanes."""
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _M32) >> 24).to(torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise-broadcast Hamming distance between (..., 8) descriptors."""
    return torch.sum(_popcount32(torch.bitwise_xor(a, b)), dim=-1)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) all-pairs Hamming distances."""
    return hamming(a[:, None, :], b[None, :, :])
