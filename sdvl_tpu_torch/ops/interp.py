"""Bilinear image sampling -- the gather behind every aligner.

Counterpart of ``sdvl_tpu/ops/interp.py``. Works on arbitrary batches of
sample positions; out-of-bounds samples clamp to the edge and callers mask
validity separately. Two things differ from the reference by necessity:

* a position that is ``nan`` or ``inf`` (a point projected from ``z ~ 0``)
  is made finite before the cast to an integer index: XLA's cast saturates,
  torch's is undefined, and an out-of-range gather faults on the GPU;
* the level-concatenated pyramid buffer can be built once
  (:func:`flatten_pyramid`) and sampled many times, because eager torch does
  not fuse the concatenation away as XLA does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import const


def _index(v: torch.Tensor, hi) -> torch.Tensor:
    """Float coordinate -> int64 index clamped to ``[0, hi]``; ``nan`` -> 0.
    ``hi`` is an int or an int64 tensor that broadcasts against ``v``."""
    v = torch.nan_to_num(v, nan=0.0).clamp_min(0.0)
    if isinstance(hi, torch.Tensor):
        return torch.minimum(v, hi.to(v.dtype)).long()
    return v.clamp_max(float(hi)).long()


def take_row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor ``i``, as a gather that stays on the
    device (no read of ``i`` back to the host)."""
    return t.index_select(0, i.reshape(1).long())[0]


def _lerp4(v00, v01, v10, v11, wx, wy):
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H, W) at positions ``xy`` (..., 2) given as (x, y).
    Returns float32 samples of shape ``(...)``."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = _index(x0, W - 1)
    y0i = _index(y0, H - 1)
    x1i = (x0i + 1).clamp_max(W - 1)
    y1i = (y0i + 1).clamp_max(H - 1)
    flat = img.reshape(-1)
    v00 = flat[y0i * W + x0i].float()
    v01 = flat[y0i * W + x1i].float()
    v10 = flat[y1i * W + x0i].float()
    v11 = flat[y1i * W + x1i].float()
    return _lerp4(v00, v01, v10, v11, wx, wy)


def nearest(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel sampling via one flat gather (round half to even, as
    the reference's ``round``)."""
    H, W = img.shape
    xi = _index(torch.round(xy[..., 0]), W - 1)
    yi = _index(torch.round(xy[..., 1]), H - 1)
    return img.reshape(-1)[yi * W + xi].float()


def _with_grad(sample, xy: torch.Tensor):
    """Intensity and central-difference gradient of the bilinear surface
    ``sample`` at ``xy``: differences of samples at +-0.5 px."""
    val = sample(xy)
    ex = const((0.5, 0.0), xy.dtype, xy.device)
    ey = const((0.0, 0.5), xy.dtype, xy.device)
    dx = 0.5 * (sample(xy + ex) - sample(xy - ex)) * 2.0
    dy = 0.5 * (sample(xy + ey) - sample(xy - ey)) * 2.0
    return val, torch.stack([dx, dy], dim=-1)


def bilinear_with_grad(img: torch.Tensor, xy: torch.Tensor):
    """Sample intensity and image gradient at ``xy``.
    Returns ``(val (...,), grad (..., 2))`` with grad = (dI/dx, dI/dy)."""
    return _with_grad(functools.partial(bilinear, img), xy)


def bilinear_indexed_with_grad(imgs: torch.Tensor, k: torch.Tensor,
                               xy: torch.Tensor):
    """:func:`bilinear_with_grad` on a stack of images, image ``k[i]`` at
    ``xy[i]`` (the lane-batched direct aligner reads each lane's own
    reference image this way)."""
    return _with_grad(functools.partial(bilinear_indexed, imgs, k), xy)


def remap(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Dense remap: sample img at ``grid`` (H', W', 2) of (x, y) positions
    (full-image undistortion through a precomputed map)."""
    return bilinear(img, grid)


def patch_offsets(half: int, device=None) -> torch.Tensor:
    """``(s, s, 2)`` (x, y) pixel offsets over ``[-half, half)``."""
    d = torch.arange(2 * half, dtype=torch.float32, device=device) - half
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([ox, oy], dim=-1)


def patch_grid(center_xy: torch.Tensor, half: int) -> torch.Tensor:
    """Pixel positions of a ``(2*half) x (2*half)`` patch centred at
    ``center_xy`` (..., 2). Returns (..., s, s, 2)."""
    return center_xy[..., None, None, :] + patch_offsets(half,
                                                         center_xy.device)


def extract_patches(img: torch.Tensor, centers: torch.Tensor, half: int):
    """Bilinearly sample square patches at subpixel ``centers`` (N, 2).
    Returns (N, 2*half, 2*half) float32."""
    return bilinear(img, patch_grid(centers, half))


def bilinear_indexed(imgs: torch.Tensor, k: torch.Tensor,
                     xy: torch.Tensor) -> torch.Tensor:
    """Sample a *stack* of images (K, H, W) -- image ``k[i]`` at ``xy[i]``.
    ``k`` broadcasts against the leading dims of ``xy``. The stack may be
    uint8: values are converted after the gather."""
    K, H, W = imgs.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = _index(x0, W - 1)
    y0i = _index(y0, H - 1)
    x1i = (x0i + 1).clamp_max(W - 1)
    y1i = (y0i + 1).clamp_max(H - 1)
    base = k.long().clamp(0, K - 1) * (H * W)
    flat = imgs.reshape(-1)
    v00 = flat[base + y0i * W + x0i].float()
    v01 = flat[base + y0i * W + x1i].float()
    v10 = flat[base + y1i * W + x0i].float()
    v11 = flat[base + y1i * W + x1i].float()
    return _lerp4(v00, v01, v10, v11, wx, wy)


class FlatPyramid(NamedTuple):
    """A pyramid (or a stack of K pyramids) with its levels concatenated."""

    flat: torch.Tensor   # (total,) or (K, total)
    offs: torch.Tensor   # (L,) int64 flat offset of each level
    Hs: torch.Tensor     # (L,) int64
    Ws: torch.Tensor     # (L,) int64


@functools.lru_cache(maxsize=None)   # never evicted: graphs read them
def _pyr_meta(shapes: Tuple[Tuple[int, int], ...], device: str):
    Hs = [s[0] for s in shapes]
    Ws = [s[1] for s in shapes]
    offs, acc = [], 0
    for h, w in shapes:
        offs.append(acc)
        acc += h * w
    mk = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
    return mk(offs), mk(Hs), mk(Ws)


def flatten_pyramid(pyr: Sequence[torch.Tensor]) -> FlatPyramid:
    """Concatenate the levels of a pyramid ``(H_l, W_l)`` -- or of a stack
    of pyramids ``(K, H_l, W_l)`` -- into one buffer, so that a sample at a
    per-element level costs four gathers whatever the number of levels."""
    shapes = tuple((int(p.shape[-2]), int(p.shape[-1])) for p in pyr)
    offs, Hs, Ws = _pyr_meta(shapes, str(pyr[0].device))
    if pyr[0].dim() == 3:
        K = pyr[0].shape[0]
        flat = torch.cat([p.reshape(K, -1) for p in pyr], dim=1)
    else:
        flat = torch.cat([p.reshape(-1) for p in pyr])
    return FlatPyramid(flat, offs, Hs, Ws)


def _flat_level_index(fp: FlatPyramid, level: torch.Tensor,
                      xy_l0: torch.Tensor):
    """Flat indices of the 4 bilinear taps of each sample, with per-element
    pyramid ``level``, and the two weights."""
    lvl = level.long().expand(xy_l0.shape[:-1])
    off = fp.offs[lvl]
    H = fp.Hs[lvl]
    W = fp.Ws[lvl]
    scale = torch.exp2(-lvl.float())
    x = xy_l0[..., 0] * scale
    y = xy_l0[..., 1] * scale
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = _index(x0, W - 1)
    y0i = _index(y0, H - 1)
    x1i = torch.minimum(x0i + 1, W - 1)
    y1i = torch.minimum(y0i + 1, H - 1)
    idx00 = off + y0i * W + x0i
    idx01 = off + y0i * W + x1i
    idx10 = off + y1i * W + x0i
    idx11 = off + y1i * W + x1i
    return idx00, idx01, idx10, idx11, wx, wy


def _as_flat(pyr) -> FlatPyramid:
    return pyr if isinstance(pyr, FlatPyramid) else flatten_pyramid(pyr)


def bilinear_indexed_pyramid(pyr_stack, k: torch.Tensor, level: torch.Tensor,
                             xy_l0: torch.Tensor) -> torch.Tensor:
    """Stacked-pyramid sampling with per-element image index AND level.

    ``pyr_stack`` is a tuple of (K, H/2^l, W/2^l) tensors (or its
    :class:`FlatPyramid`). ``k`` and ``level`` broadcast against
    ``xy_l0``'s leading dims (level-0 coordinates). The store may be uint8:
    gather THEN convert, so no float copy of the keyframe store is made.
    """
    fp = _as_flat(pyr_stack)
    K, total = fp.flat.shape
    i00, i01, i10, i11, wx, wy = _flat_level_index(fp, level, xy_l0)
    base = k.long().clamp(0, K - 1).expand(i00.shape) * total
    flat = fp.flat.reshape(-1)
    v00 = flat[base + i00].float()
    v01 = flat[base + i01].float()
    v10 = flat[base + i10].float()
    v11 = flat[base + i11].float()
    return _lerp4(v00, v01, v10, v11, wx, wy)


def bilinear_pyramid(pyr, level: torch.Tensor,
                     xy_l0: torch.Tensor) -> torch.Tensor:
    """Sample a pyramid at a *per-element dynamic* level.

    ``pyr`` is a tuple of (H/2^l, W/2^l) images (or its
    :class:`FlatPyramid`); ``level`` broadcasts against the leading dims of
    ``xy_l0`` (level-0 pixel coords)."""
    fp = _as_flat(pyr)
    i00, i01, i10, i11, wx, wy = _flat_level_index(fp, level, xy_l0)
    v00 = fp.flat[i00].float()
    v01 = fp.flat[i01].float()
    v10 = fp.flat[i10].float()
    v11 = fp.flat[i11].float()
    return _lerp4(v00, v01, v10, v11, wx, wy)


def extract_patches_pyramid(pyr, level: torch.Tensor,
                            centers_l0: torch.Tensor, half: int):
    """Square patches sampled at each feature's own pyramid level.

    ``centers_l0`` (N, 2) in level-0 coords; patch offsets are applied in
    *level* pixels. Returns (N, s, s)."""
    offs = patch_offsets(half, centers_l0.device)
    scale = torch.exp2(level.float())[:, None, None, None]
    pos_l0 = centers_l0[:, None, None, :] + offs[None] * scale
    return bilinear_pyramid(pyr, level[:, None, None], pos_l0)
