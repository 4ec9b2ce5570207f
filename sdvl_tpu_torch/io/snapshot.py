"""Saving and loading a session, in the JAX package's snapshot format.

Counterpart of ``sdvl_tpu/io/snapshot.py``, both halves. A snapshot
(``FORMAT_VERSION 1``) is one ``.npz``, written atomically (a temporary file
in the same directory, then a rename):

* a stream's: ``map.<field>``, ``map.kf_pyr.<i>``, ``carry.<field>``,
  ``carry.pyr1.<i>`` and ``carry.last_pyr.<i>``;
* the host driver's (``SDVL``): the same ``map.*`` keys, the driver's
  scalars as JSON (``host_json``), ``key``, ``last_pose``, ``xi_model``,
  and where set ``last_match_idx``/``last_match_ok``, ``last_pyr.<i>``,
  ``traj_ids``/``traj_poses`` and the kept first frame (``first_pyr.<i>``,
  ``first_corners.<field>``).

Counters added after snapshots existed (``n_evicted``, ``n_pruned``) load as
0 when missing.

Conversions (see ``state/map_state.py``): on the way in, uint32 ORB
descriptor words and the PRNG key become int64 (values kept) and
index-valued int32 fields become int64; on the way out they are written
back with the reference's dtypes (uint32 words and key, int32 indices), so
a snapshot written by the port loads, and resumes, in either package.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Mapping

import numpy as np
import torch

from .. import require_device
from ..ops.fast import Corners
from ..pipeline.device_fsm import SlamCarry
from ..state.map_state import FIELD_DTYPES, MapState

FORMAT_VERSION = 1

_COUNTER_DEFAULTS = ("n_evicted", "n_pruned")

_CARRY_DTYPES = dict(
    state=torch.int32, key=torch.int64, frame_id=torch.int32,
    pose=torch.float32, xi_model=torch.float32,
    frames_since_kf=torch.int32, kf_matches=torch.int32,
    lost_frames=torch.int32, pyr1=torch.float32, c1_xy=torch.float32,
    c1_valid=torch.bool, last_pyr=torch.float32, last_idx=torch.int64,
    last_ok=torch.bool,
)


def _to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)  # torch has no usable uint32; keep the value
    # a writable C-ordered copy (0-d stays 0-d; npz members are read-only)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(
        device=device, dtype=dtype)


def _tree_from_numpy(cls, dtypes, arrays: Mapping, device):
    dev = require_device(device)
    kw = {}
    for name in cls._fields:
        if name not in arrays and name in _COUNTER_DEFAULTS:
            kw[name] = torch.zeros((), dtype=dtypes[name], device=dev)
            continue
        val = arrays[name]
        if isinstance(val, (tuple, list)):
            kw[name] = tuple(_to_tensor(v, dtypes[name], dev) for v in val)
        else:
            kw[name] = _to_tensor(val, dtypes[name], dev)
    return cls(**kw)


def map_from_numpy(arrays: Mapping, device="cuda") -> MapState:
    """MapState from a dict of numpy arrays keyed by field name
    (``kf_pyr``: a tuple of per-level arrays) -- e.g. the ``_asdict()`` of a
    live JAX ``MapState``."""
    return _tree_from_numpy(MapState, FIELD_DTYPES, arrays, device)


def carry_from_numpy(arrays: Mapping, device="cuda") -> SlamCarry:
    """SlamCarry from a dict of numpy arrays keyed by field name (``pyr1``,
    ``last_pyr``: tuples of per-level arrays)."""
    return _tree_from_numpy(SlamCarry, _CARRY_DTYPES, arrays, device)


def _arrays_from_npz(prefix: str, cls, z) -> dict:
    out = {}
    for name in cls._fields:
        flat_key = f"{prefix}.{name}"
        if flat_key in z.files:
            out[name] = z[flat_key]
        elif name in _COUNTER_DEFAULTS:
            continue
        else:
            n = sum(1 for k in z.files if k.startswith(flat_key + "."))
            out[name] = tuple(z[f"{flat_key}.{i}"] for i in range(n))
    return out


def load_stream_arrays(path: str, device="cuda"):
    """Load a stream snapshot's (MapState, SlamCarry) onto ``device``."""
    dev = require_device(device)
    with np.load(path) as z:
        host = json.loads(bytes(z["host_json"]).decode())
        if host.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"snapshot format {host.get('format_version')}")
        return (map_from_numpy(_arrays_from_npz("map", MapState, z), dev),
                carry_from_numpy(_arrays_from_npz("carry", SlamCarry, z), dev))


def _saved_dtype(name: str, t: torch.Tensor):
    """The reference's numpy dtype of a field the port holds as ``t``."""
    if name in ("pt_desc", "cand_desc", "key"):
        return np.uint32
    if t.dtype == torch.int64:
        return np.int32
    return None


def _host(t: torch.Tensor, name: str = "") -> np.ndarray:
    """A tensor as numpy, in the reference's dtype for its field."""
    a = t.detach().cpu().numpy()
    dt = _saved_dtype(name, t)
    return a if dt is None else a.astype(dt)


def _tree_to_arrays(prefix: str, tree) -> dict:
    out = {}
    for name, val in tree._asdict().items():
        leaves = val if isinstance(val, tuple) else (val,)
        arrays = []
        for leaf in leaves:
            arrays.append(_host(leaf, name))
        if isinstance(val, tuple):
            for i, a in enumerate(arrays):
                out[f"{prefix}.{name}.{i}"] = a
        else:
            out[f"{prefix}.{name}"] = arrays[0]
    return out


def _save_atomic(path: str, arrays: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_stream_snapshot(stream, path: str) -> None:
    """Checkpoint a stream's MapState and SlamCarry to ``path``. One
    device->host copy of every field: checkpoint at sequence boundaries,
    not inside the per-frame loop."""
    arrays = _tree_to_arrays("map", stream.m)
    arrays.update(_tree_to_arrays("carry", stream.carry))
    arrays["host_json"] = np.frombuffer(
        json.dumps({"format_version": FORMAT_VERSION,
                    "kind": "stream"}).encode(), dtype=np.uint8)
    _save_atomic(path, arrays)


def load_stream_snapshot(stream, path: str):
    """Restore a stream's MapState and SlamCarry from ``path`` onto the
    stream's device; the capacities must match its config. Returns the
    stream."""
    m, carry = load_stream_arrays(path, device=stream.device)
    if m.capacities != stream.m.capacities:
        raise ValueError(
            f"snapshot capacities {m.capacities} != config "
            f"{stream.m.capacities}")
    stream.m = m
    stream.carry = carry
    return stream


# ------------------------------------------------------------ host driver
_CORNER_DTYPES = dict(xy=torch.float32, score=torch.float32,
                      level=torch.int32, valid=torch.bool)


def save_snapshot(slam, path: str) -> None:
    """Write the complete session state of an ``SDVL`` (the host driver)
    to ``path``; the file loads into the JAX package's ``SDVL`` too."""
    arrays = _tree_to_arrays("map", slam.m)
    host = {
        "state": slam.state.name,
        "quality": slam.quality.name,
        "frame_id": slam.frame_id,
        "frames_since_kf": slam.frames_since_kf,
        "kf_matches": slam.kf_matches,
        "lost_frames": slam.lost_frames,
        "format_version": FORMAT_VERSION,
    }
    arrays["host_json"] = np.frombuffer(json.dumps(host).encode(),
                                        dtype=np.uint8)
    arrays["key"] = np.asarray(slam.key, np.uint32)
    arrays["last_pose"] = _host(slam.last_pose)
    arrays["xi_model"] = _host(slam.xi_model)
    if slam.last_match_idx is not None:
        arrays["last_match_idx"] = _host(slam.last_match_idx)
        arrays["last_match_ok"] = _host(slam.last_match_ok)
    if slam.last_pyr is not None:
        for i, lvl in enumerate(slam.last_pyr):
            arrays[f"last_pyr.{i}"] = _host(lvl)
    if slam.trajectory:
        arrays["traj_ids"] = np.asarray([t[0] for t in slam.trajectory])
        arrays["traj_poses"] = np.stack([t[1] for t in slam.trajectory])
    if slam._first_fs is not None:
        pyr1, corners1 = slam._first_fs
        for i, lvl in enumerate(pyr1):
            arrays[f"first_pyr.{i}"] = _host(lvl)
        for field, val in corners1._asdict().items():
            arrays[f"first_corners.{field}"] = _host(val)
    _save_atomic(path, arrays)


def load_snapshot(slam, path: str):
    """Restore a host-driver snapshot (written by either package) into
    ``slam``, which must have the same capacities. Returns ``slam``."""
    from ..pipeline.sdvl import TrackingQuality, TrackingState
    from ..pipeline.stream import NoiseSource

    dev = slam.device
    with np.load(path) as z:
        host = json.loads(bytes(z["host_json"]).decode())
        if host.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"snapshot format {host.get('format_version')} != "
                f"{FORMAT_VERSION}")
        m = map_from_numpy(_arrays_from_npz("map", MapState, z), dev)
        if m.capacities != slam.m.capacities:
            raise ValueError(
                f"snapshot capacities {m.capacities} != config "
                f"{slam.m.capacities}")
        slam.m = m
        slam.state = TrackingState[host["state"]]
        slam.quality = TrackingQuality[host["quality"]]
        slam.frame_id = host["frame_id"]
        slam.frames_since_kf = host["frames_since_kf"]
        slam.kf_matches = host["kf_matches"]
        slam.lost_frames = host["lost_frames"]
        slam.key = np.asarray(z["key"], np.uint32)
        # the session's own seed, so that it draws on as it would have
        seed = (int(slam.key[0]) << 32) | int(slam.key[1])
        slam._noise = NoiseSource(slam.cfg, seed, dev, slam._noise.provider)
        pose = np.asarray(z["last_pose"], np.float32)
        slam._set_pose(_to_tensor(pose, torch.float32, dev), pose.copy())
        slam.xi_model = _to_tensor(z["xi_model"], torch.float32, dev)
        if "last_match_idx" in z.files:
            slam.last_match_idx = _to_tensor(z["last_match_idx"],
                                             torch.int64, dev)
            slam.last_match_ok = _to_tensor(z["last_match_ok"], torch.bool,
                                            dev)
        levels = sum(1 for k in z.files if k.startswith("last_pyr."))
        if levels:
            slam.last_pyr = tuple(
                _to_tensor(z[f"last_pyr.{i}"], torch.float32, dev)
                for i in range(levels))
        if "traj_ids" in z.files:
            slam.trajectory = [
                (int(i), np.asarray(p, np.float32))
                for i, p in zip(z["traj_ids"], z["traj_poses"])]
        n_first = sum(1 for k in z.files if k.startswith("first_pyr."))
        if n_first:
            pyr1 = tuple(_to_tensor(z[f"first_pyr.{i}"], torch.float32, dev)
                         for i in range(n_first))
            corners1 = Corners(**{
                f: _to_tensor(z[f"first_corners.{f}"], _CORNER_DTYPES[f],
                              dev)
                for f in Corners._fields})
            slam._first_fs = (pyr1, corners1)
        elif slam.state == TrackingState.SECOND_FRAME:
            # saved mid-bootstrap without the first frame: restart cleanly
            slam.state = TrackingState.FIRST_FRAME
    return slam


def save_trajectory_tum(slam, path: str, timestamps=None) -> None:
    """Write an ``SDVL`` session's trajectory in TUM format."""
    from .dataset import save_tum_trajectory

    ids = [i for i, _ in slam.trajectory]
    poses = np.stack([p for _, p in slam.trajectory])
    stamps = [timestamps[i] if timestamps is not None else float(i)
              for i in ids]
    save_tum_trajectory(path, stamps, poses)
