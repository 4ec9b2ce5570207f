"""Session recorder: dump overlays + map figures while a run progresses.

Counterpart of ``sdvl_tpu/viz/recorder.py``. The host driver's ``info``
holds device tensors (the match pixels and flags); the recorder copies them,
and the map, to the host only on the frames it writes: a frame it skips adds
no synchronisation. PNGs are written by :func:`save_png` (``zlib`` and
``struct``; no OpenCV).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .overlay import draw_frame_overlay, host
from .scene import plot_map, require_matplotlib


def save_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB (or (H, W) gray) image as a PNG:
    8-bit samples, no filter, one zlib stream."""
    a = np.ascontiguousarray(np.asarray(rgb, np.uint8))
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"save_png takes (H, W) or (H, W, 3), got {a.shape}")
    H, W = a.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), a.reshape(H, -1)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


class VizRecorder:
    """Attach to an SDVL session loop; writes PNGs every ``every`` frames.
    With ``maps`` it needs matplotlib, and says so at construction."""

    def __init__(self, out_dir: str, every: int = 10, overlays: bool = True,
                 maps: bool = True):
        if maps:
            require_matplotlib()
        self.out_dir = out_dir
        self.every = max(1, every)
        self.overlays = overlays
        self.maps = maps
        os.makedirs(out_dir, exist_ok=True)

    def record(self, slam, img: np.ndarray, info: dict) -> None:
        fid = info["frame_id"]
        if fid % self.every:
            return
        if self.overlays and info.get("match_px") is not None:
            rgb = draw_frame_overlay(
                np.asarray(img)[: slam.crop_h, : slam.crop_w],
                info["match_px"], info["match_ok"],
                attempted=info.get("match_attempted"),
                quality=slam.quality.name,
            )
            save_png(os.path.join(self.out_dir, f"frame_{fid:06d}.png"), rgb)
        if self.maps:
            plot_map(slam.m, slam.trajectory,
                     path=os.path.join(self.out_dir, f"map_{fid:06d}.png"))


def render_stream_session(stream, result, frames=None, out_dir: str = "viz",
                          every: int = 10) -> None:
    """Post-run visualization for a stream session (the stream reads its
    results once, at the end, so this renders after
    :meth:`SdvlStream.result`):

      * ``trajectory.png`` + ``map_final.png`` from the final MapState,
      * per-frame overlays every ``every`` frames (if the original frames
        are provided) with the final map points reprojected through each
        recorded pose -- the post-hoc equivalent of DrawImage's live feature
        dots (ui/drawimage.cc:53-94).
    """
    from ..pipeline.config import intrinsics
    from .scene import plot_trajectory

    require_matplotlib()
    os.makedirs(out_dir, exist_ok=True)
    traj = [(i, result.trajectory[i]) for i in range(result.n_frames)]
    plot_trajectory(result.trajectory,
                    path=os.path.join(out_dir, "trajectory.png"))
    plot_map(stream.m, traj, path=os.path.join(out_dir, "map_final.png"))

    if frames is None:
        return
    pts = host(stream.m.pt_pos)[host(stream.m.pt_valid)]
    if not len(pts):
        return
    intr = intrinsics(stream.cfg)
    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)
    for i in range(0, min(len(frames), result.n_frames), max(1, every)):
        if result.states[i] != 2:
            continue
        pose = np.asarray(result.trajectory[i], np.float64)
        w, x, y, z = pose[:4] / np.linalg.norm(pose[:4])
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        p_cam = pts @ R.T + pose[4:]
        zok = p_cam[:, 2] > 1e-3
        px = np.stack([
            fx * p_cam[:, 0] / np.maximum(p_cam[:, 2], 1e-6) + cx,
            fy * p_cam[:, 1] / np.maximum(p_cam[:, 2], 1e-6) + cy,
        ], -1)
        H, W = stream.crop_h, stream.crop_w
        inb = (zok & (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0)
               & (px[:, 1] < H))
        rgb = draw_frame_overlay(np.asarray(frames[i])[:H, :W], px[inb],
                                 np.ones(int(inb.sum()), bool))
        save_png(os.path.join(out_dir, f"frame_{i:06d}.png"), rgb)
