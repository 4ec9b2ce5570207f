"""ctypes binding of the repository's native prefetching frame loader.

Counterpart of ``sdvl_tpu/io/native_loader.py``. The C++ loader
(``native/frame_loader.cc``) decodes PNG/JPEG/PGM frames on a small worker
pool into a bounded ring ahead of the consumer. The port compiles it with
``g++`` at first use into ``sdvl_tpu_torch/_build/libsdvl_native.so`` and
never writes into ``native/`` (the shared library there is a tracked file).

Without the library (no compiler, or no libpng / libjpeg to link) binary PGM
frames are still decoded, in NumPy; PNG and JPEG input then fails with an
error that says why. There is no OpenCV fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Iterator, List, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "frame_loader.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libsdvl_native.so")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LINK_LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lib = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def _compile() -> None:
    """g++ ``native/frame_loader.cc`` -> ``_build/libsdvl_native.so``
    (through a temporary file and a rename, so concurrent builds are
    safe)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE,
           *LINK_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                f"{proc.stderr.strip()[-2000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_built() -> bool:
    """Build (if missing or older than its source) and bind the library.
    Returns availability; the reason of a failure is in
    :func:`build_error`."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return True
        if _build_error is not None:
            return False
        try:
            if (not os.path.exists(LIB_PATH)
                    or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE)):
                _compile()
            lib = ctypes.CDLL(LIB_PATH)
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return False
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float)]
        lib.loader_remaining.restype = ctypes.c_long
        lib.loader_remaining.argtypes = [ctypes.c_void_p]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return True


def build_error() -> Optional[str]:
    """Why the library is unavailable (None if it built or was not tried)."""
    return _build_error


class NativeFrameLoader:
    """Iterate float32 grayscale frames with background prefetch."""

    def __init__(self, paths: List[str], width: int, height: int,
                 prefetch_depth: int = 8, n_threads: int = 2):
        if not ensure_built():
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self.width, self.height = width, height
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._handle = _lib.loader_create(
            arr, len(paths), width, height, prefetch_depth, n_threads)
        self._buf = np.empty((height, width), np.float32)
        self._idx = -1

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        _, frame = self.next_indexed()
        return frame

    def next_indexed(self):
        """(path_index, frame) of the next decodable image. Every
        ``loader_next`` call consumes exactly one path in order (-1: that
        path failed to decode and is skipped), so the index stays aligned
        with per-path metadata such as timestamps."""
        while True:
            rc = _lib.loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc == 0:
                raise StopIteration
            self._idx += 1
            if rc == 1:
                return self._idx, self._buf.copy()

    def close(self):
        if self._handle:
            _lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _pgm_token(data: bytes, pos: int):
    """Next whitespace-separated header token of a PGM at ``pos`` (comments
    skipped). Returns (token, position after it)."""
    n = len(data)
    while pos < n:
        c = data[pos:pos + 1]
        if c == b"#":
            while pos < n and data[pos:pos + 1] != b"\n":
                pos += 1
        elif c.isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < n and not data[pos:pos + 1].isspace() \
            and data[pos:pos + 1] != b"#":
        pos += 1
    return data[start:pos], pos


def read_pgm(path: str) -> Optional[np.ndarray]:
    """Decode a binary (P5) PGM as float32 grayscale, as the native decoder
    does (16-bit samples scaled to 0-255). None where the file is not a
    binary PGM or is cut short."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    magic, pos = _pgm_token(data, 0)
    if magic != b"P5":
        return None
    vals = []
    for _ in range(3):
        tok, pos = _pgm_token(data, pos)
        if not tok.isdigit():
            return None
        vals.append(int(tok))
    w, h, maxv = vals
    pos += 1            # the single whitespace after the header
    n = w * h
    if maxv < 256:
        body = np.frombuffer(data, np.uint8, count=n, offset=pos) \
            if len(data) >= pos + n else None
        return None if body is None else body.reshape(h, w).astype(np.float32)
    if len(data) < pos + 2 * n:
        return None
    body = np.frombuffer(data, ">u2", count=n, offset=pos).astype(np.float32)
    return (body * np.float32(255.0) / np.float32(maxv)).reshape(h, w)


def _numpy_frames(paths: List[str], width: int, height: int, indexed: bool,
                  why: str):
    """PGM frames decoded in NumPy; a frame that is not a readable PGM of
    the expected size is skipped, as the native loader skips it. A PNG or
    JPEG path is an error: those need the native library."""
    for i, p in enumerate(paths):
        if p.lower().endswith((".png", ".jpg", ".jpeg")):
            raise RuntimeError(
                f"{p}: PNG/JPEG frames are decoded by the native loader "
                f"(native/frame_loader.cc, linked with libpng and libjpeg), "
                f"which is not in use: {why}")
        f = read_pgm(p)
        if f is None or f.shape != (height, width):
            continue
        yield (i, f) if indexed else f


def frame_source(paths: List[str], width: int, height: int,
                 prefer_native: bool = True, indexed: bool = False
                 ) -> Iterator:
    """Frame iterator over ``paths``: the native prefetching loader, else
    PGM decoding in NumPy. With ``indexed`` it yields ``(path_index,
    frame)`` so per-path metadata stays aligned across skipped images."""
    if prefer_native and ensure_built():
        loader = NativeFrameLoader(paths, width, height)
        if indexed:
            def _native_indexed():
                while True:
                    try:
                        yield loader.next_indexed()
                    except StopIteration:
                        return
            return _native_indexed()
        return iter(loader)
    why = ("disabled by the caller" if not prefer_native
           else f"it did not build: {_build_error}")
    return _numpy_frames(paths, width, height, indexed, why)
