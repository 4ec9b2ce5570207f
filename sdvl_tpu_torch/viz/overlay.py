"""Per-frame feature overlay (reference DrawImage equivalent).

Counterpart of ``sdvl_tpu/viz/overlay.py`` (NumPy only, the same pixels).
Mirrors reference ui/drawimage.cc:53-94: features drawn over the grayscale
frame colored by match status (green = matched/FOUND, red = NOT_FOUND/
OUTLIER, yellow = attempted), and a red/blue tint when tracking quality is
BAD/INSUFFICIENT — but rendered into an RGB numpy array (savable as PNG)
instead of an interactive window.
"""

from __future__ import annotations

import numpy as np


def host(x) -> np.ndarray:
    """A torch tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _disk_mask(r: int) -> np.ndarray:
    d = np.arange(-r, r + 1)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    rr = yy * yy + xx * xx
    return (rr <= r * r) & (rr >= (r - 1) ** 2)  # ring, like cv::circle thickness 1


def draw_frame_overlay(img: np.ndarray, px: np.ndarray, ok: np.ndarray,
                       attempted: np.ndarray | None = None,
                       quality: str = "GOOD", radius: int = 3) -> np.ndarray:
    """Render the tracking overlay; returns (H, W, 3) uint8 RGB.

    ``px`` (N, 2) feature pixels, ``ok`` (N,) matched flags, ``attempted``
    (N,) whether a match was tried (unattempted slots are skipped).
    ``quality`` in GOOD/INSUFFICIENT/BAD applies the reference's tint
    (drawimage.cc:72-76).
    """
    img = np.asarray(img, np.float32)
    H, W = img.shape
    px, ok = host(px), host(ok)
    attempted = None if attempted is None else host(attempted)
    rgb = np.repeat(np.clip(img, 0, 255)[..., None], 3, axis=-1)

    if quality == "BAD":
        rgb[..., 0] = np.minimum(rgb[..., 0] + 80.0, 255.0)
    elif quality == "INSUFFICIENT":
        rgb[..., 2] = np.minimum(rgb[..., 2] + 80.0, 255.0)

    px = np.asarray(px)
    ok = np.asarray(ok, bool)
    att = (np.ones(len(px), bool) if attempted is None
           else np.asarray(attempted, bool))
    ring = _disk_mask(radius)
    ry, rx = np.nonzero(ring)
    ry, rx = ry - radius, rx - radius
    colors = {True: (0.0, 255.0, 0.0), False: (255.0, 0.0, 0.0)}
    for (x, y), good, a in zip(px, ok, att):
        if not a or not np.isfinite(x) or not np.isfinite(y):
            continue
        xi, yi = int(round(float(x))), int(round(float(y)))
        ys, xs = yi + ry, xi + rx
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        rgb[ys[keep], xs[keep]] = colors[bool(good)]
    return rgb.astype(np.uint8)
