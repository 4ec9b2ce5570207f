"""Dataset readers: image-list sequences, TUM RGB-D, EuRoC MAV, live camera.

Counterpart of ``sdvl_tpu/io/dataset.py``, without OpenCV: binary PGM frames
are decoded in NumPy, PNG and JPEG frames by the repository's native loader
(``io/native_loader.py``), whose decoder needs the image size up front, read
here from the file's header. :func:`camera_source` needs OpenCV and raises
where it is not installed.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from . import native_loader


def _image_size(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from a PNG's IHDR or a JPEG's start-of-frame
    segment; None where neither is found."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            return None
        f.seek(2)
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                return None
            if marker[1] in (0xD8, 0x01) or 0xD0 <= marker[1] <= 0xD7:
                continue
            (length,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8,
                                                               0xCC):
                h, w = struct.unpack(">xHH", f.read(5))
                return w, h
            f.seek(length - 2, 1)


def _imread_gray(path: str) -> np.ndarray:
    """A grayscale uint8 frame from a PGM, PNG or JPEG file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = native_loader.read_pgm(path)
    if img is None:
        size = _image_size(path)
        if size is None:
            raise FileNotFoundError(f"{path}: not a PGM, PNG or JPEG image")
        frames = list(native_loader.frame_source([path], *size))
        if not frames:
            raise FileNotFoundError(f"{path}: could not be decoded")
        img = frames[0]
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def image_list_source(path: str, filename: str = "files.txt"
                      ) -> Iterator[np.ndarray]:
    """Reference-format source: one image filename per line of
    ``<path>/<filename>``; the end of the list ends the iterator."""
    listfile = os.path.join(path, filename)
    with open(listfile) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            yield _imread_gray(os.path.join(path, name))


def camera_source(device: int = 0, width: Optional[int] = None,
                  height: Optional[int] = None) -> Iterator[np.ndarray]:
    """Live camera source (``Video.type: 0``): BGR frames from
    ``cv2.VideoCapture``, yielded as grayscale. Needs OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "a live camera source (Video.type: 0) needs OpenCV (cv2), which "
            "is not installed; pass --images with an image list instead"
        ) from e

    cap = cv2.VideoCapture(device)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open camera device {device}")
    if width:
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
    if height:
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    finally:
        cap.release()


def tum_rgb_index(seq_dir: str):
    """(stamps, absolute image paths) from a TUM ``rgb.txt``."""
    stamps, paths = [], []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            stamps.append(float(parts[0]))
            paths.append(os.path.join(seq_dir, parts[1]))
    return stamps, paths


def tum_rgb_source(seq_dir: str) -> Iterator[Tuple[float, np.ndarray]]:
    """TUM RGB-D format: ``rgb.txt`` with `timestamp filename` rows."""
    stamps, paths = tum_rgb_index(seq_dir)
    for ts, p in zip(stamps, paths):
        yield ts, _imread_gray(p)


def load_tum_groundtruth(seq_dir: str) -> np.ndarray:
    """(N, 8) rows of [t, tx, ty, tz, qx, qy, qz, qw] from groundtruth.txt."""
    rows = []
    with open(os.path.join(seq_dir, "groundtruth.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 8:
                rows.append([float(x) for x in parts[:8]])
    return np.asarray(rows)


def _euroc_root(seq_dir: str) -> str:
    """``seq_dir`` may point at the sequence root or directly at ``mav0``."""
    if os.path.isdir(os.path.join(seq_dir, "mav0")):
        return os.path.join(seq_dir, "mav0")
    return seq_dir


def euroc_index(seq_dir: str, cam: str = "cam0"):
    """(stamps_sec, absolute image paths) from an EuRoC ``data.csv``."""
    camdir = os.path.join(_euroc_root(seq_dir), cam)
    stamps, paths = [], []
    with open(os.path.join(camdir, "data.csv")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            ts_ns, name = line.strip().split(",")[:2]
            stamps.append(float(ts_ns) * 1e-9)
            paths.append(os.path.join(camdir, "data", name))
    return stamps, paths


def euroc_source(seq_dir: str, cam: str = "cam0"
                 ) -> Iterator[Tuple[float, np.ndarray]]:
    """EuRoC MAV format: ``mav0/<cam>/data.csv`` rows of
    `timestamp_ns,filename`, images under ``mav0/<cam>/data/``. Yields
    (seconds, grayscale image)."""
    stamps, paths = euroc_index(seq_dir, cam)
    for ts, p in zip(stamps, paths):
        yield ts, _imread_gray(p)


def load_euroc_groundtruth(seq_dir: str) -> np.ndarray:
    """(N, 8) rows of [t_sec, tx, ty, tz, qx, qy, qz, qw] from the EuRoC
    ``state_groundtruth_estimate0/data.csv`` (stored there as t_ns, p_xyz,
    q_wxyz; reordered to the TUM layout so one ATE path serves both)."""
    path = os.path.join(_euroc_root(seq_dir), "state_groundtruth_estimate0",
                        "data.csv")
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.strip().split(",")[:8]]
            t, px, py, pz, qw, qx, qy, qz = v
            rows.append([t * 1e-9, px, py, pz, qx, qy, qz, qw])
    return np.asarray(rows)


def save_tum_trajectory(path: str, stamps, poses_wc) -> None:
    """Write a TUM-format trajectory (cam->world, x y z qx qy qz qw)."""
    import torch

    from ..core import se3

    poses = np.asarray(poses_wc, np.float32)
    inv = se3.inverse(torch.from_numpy(np.array(poses, copy=True))).numpy()
    with open(path, "w") as f:
        for ts, p in zip(stamps, inv):
            qw, qx, qy, qz, tx, ty, tz = p
            f.write(f"{ts} {tx} {ty} {tz} {qx} {qy} {qz} {qw}\n")
