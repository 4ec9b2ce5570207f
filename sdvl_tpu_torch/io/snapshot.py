"""Saving and loading a stream's state, in the JAX package's snapshot format.

Counterpart of the stream half of ``sdvl_tpu/io/snapshot.py``. A stream
snapshot (``FORMAT_VERSION 1``) is one ``.npz`` whose keys are
``map.<field>``, ``map.kf_pyr.<i>``, ``carry.<field>``, ``carry.pyr1.<i>``
and ``carry.last_pyr.<i>``; counters added after snapshots existed
(``n_evicted``, ``n_pruned``) load as 0 when missing.

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


def _tree_to_arrays(prefix: str, tree) -> dict:
    out = {}
    for name, val in tree._asdict().items():
        leaves = val if isinstance(val, tuple) else (val,)
        arrays = []
        for leaf in leaves:
            a = leaf.detach().cpu().numpy()
            dt = _saved_dtype(name, leaf)
            arrays.append(a if dt is None else a.astype(dt))
        if isinstance(val, tuple):
            for i, a in enumerate(arrays):
                out[f"{prefix}.{name}.{i}"] = a
        else:
            out[f"{prefix}.{name}"] = arrays[0]
    return out


def save_stream_snapshot(stream, path: str) -> None:
    """Checkpoint a stream's MapState and SlamCarry to ``path``, atomically
    (a temporary file in the same directory, then a rename). One
    device->host copy of every field: checkpoint at sequence boundaries,
    not inside the per-frame loop."""
    arrays = _tree_to_arrays("map", stream.m)
    arrays.update(_tree_to_arrays("carry", stream.carry))
    arrays["host_json"] = np.frombuffer(
        json.dumps({"format_version": FORMAT_VERSION,
                    "kind": "stream"}).encode(), dtype=np.uint8)
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
