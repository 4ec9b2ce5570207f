"""Device meshes over ``torch.distributed``.

Counterpart of ``sdvl_tpu/dist/mesh.py``. The JAX package names two scaling
axes of a ``jax.sharding.Mesh``; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names, one
process per device:

  * ``point`` -- map points of a bundle-adjustment problem sharded over the
    ranks (``dist/ba_sharded.py``): every sum over points is all-reduced;
  * ``stream`` -- independent camera streams split over the ranks
    (``dist/multi_stream.py``).

The default process group must be up first (``dist/multihost.py``'s
:func:`~sdvl_tpu_torch.dist.multihost.initialize`, or
``torch.distributed.init_process_group`` with an address, a world size and
a rank). A sharded array is a rank's slice of rows of the whole array
(:func:`shard_rows`); a replicated one is the whole array on every rank.
``mesh=None`` everywhere means one process, no collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = "point",
              device_type: Optional[str] = None):
    """1-D mesh named ``axis`` over ranks ``0 .. n_devices - 1`` of the
    default group (all of them by default). Every rank of the group calls
    it. ``device_type`` defaults to ``cuda`` under nccl, else ``cpu``."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(_device_type(device_type), list(range(n)),
                      mesh_dim_names=(axis,))


def make_mesh_2d(n_point: int, n_stream: int,
                 device_type: Optional[str] = None,
                 names=("stream", "point")):
    """(stream, point) mesh over ranks ``0 .. n_point * n_stream - 1``:
    streams outermost, so a stream's point-sharded solves stay among
    neighbouring ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(n_point * n_stream).reshape(n_stream, n_point)
    return DeviceMesh(_device_type(device_type), ranks,
                      mesh_dim_names=tuple(names))


def axis_size(mesh: Optional["DeviceMesh"], axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional["DeviceMesh"], axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(mesh_dim=axis)


def axis_group(mesh: Optional["DeviceMesh"], axis: str):
    """The process group of this rank along ``axis`` (None without a
    mesh). An axis of one rank keeps its group: its collectives run and
    change nothing."""
    return None if mesh is None else mesh.get_group(mesh_dim=axis)


def shard_rows(n: int, mesh: Optional["DeviceMesh"], axis: str) -> slice:
    """This rank's rows of an ``n``-row array sharded over ``axis``: equal
    contiguous blocks, rank order. ``n`` must divide evenly."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows not divisible by mesh axis {axis}={size}")
    step = n // size
    r = axis_rank(mesh, axis)
    return slice(r * step, (r + 1) * step)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of ``group`` concatenated in rank order (each
    rank holds as many), or ``x`` where ``group`` is None. Bool tensors go
    over the wire as uint8 (gloo has no bool), and every tensor contiguous
    (nccl takes no other)."""
    if group is None:
        return x
    wire = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out
