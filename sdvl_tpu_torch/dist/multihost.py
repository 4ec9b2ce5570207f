"""Multi-process execution: ``torch.distributed`` bring-up and meshes.

Counterpart of ``sdvl_tpu/dist/multihost.py``. One process per device:

  * every process calls :func:`initialize` first -- ``init_process_group``
    with nccl on the card (gloo on the CPU where the caller asks for it),
    a TCP rendezvous at the
    coordinator's address, the world size and the process's rank (nothing
    on the machine announces a cluster);
  * meshes are built over every rank (:func:`global_mesh`,
    :func:`global_mesh_2d`), so ``dist.ba_sharded.solve_sharded`` and
    ``dist.multi_stream.MultiStream`` run unchanged;
  * inputs are whole on every process (each builds them from a seed, or
    loads the same file): :func:`put_replicated` puts them on the process's
    device, :func:`put_sharded` keeps the process's rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_mod


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, timeout_s: float = 120.0) -> str:
    """Join the process group: ``coordinator_address`` is ``host:port``
    (rank 0 listens there). ``backend`` defaults to nccl (the process then
    uses card ``process_id`` modulo the cards it sees), which raises where
    there is no card; gloo, on the CPU, only when asked for. Returns the
    backend."""
    import datetime

    from .. import require_device

    if backend is None:
        backend = "nccl"
    if backend == "nccl":
        require_device("cuda")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def local_device() -> torch.device:
    """This process's device: its card under nccl, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(axis: str = "point"):
    """1-D mesh over every rank."""
    return mesh_mod.make_mesh(axis=axis)


def global_mesh_2d(n_stream: int, axis_stream: str = "stream",
                   axis_point: str = "point"):
    """(stream, point) mesh over every rank; ``n_stream`` must divide the
    world size. Streams are the outer axis, so a stream's point-sharded
    solves stay among neighbouring ranks."""
    world = dist.get_world_size()
    if world % n_stream:
        raise ValueError(f"{n_stream} streams do not divide {world} ranks")
    return mesh_mod.make_mesh_2d(world // n_stream, n_stream,
                                 names=(axis_stream, axis_point))


def put_replicated(x, mesh=None) -> torch.Tensor:
    """``x`` whole on this process's device."""
    return torch.as_tensor(np.asarray(x)).to(local_device())


def put_sharded(x, mesh, axis: str) -> torch.Tensor:
    """This process's rows of ``x`` (sharded on dim 0 over ``axis``) on its
    device."""
    x = np.asarray(x)
    return torch.as_tensor(x[mesh_mod.shard_rows(len(x), mesh, axis)]).to(
        local_device())


def process_count() -> int:
    return dist.get_world_size()


def demo_ba_problem(seed: int = 11, K: int = 4, P: int = 256,
                    noise: float = 0.05 / 420.0, perturb: float = 0.05,
                    device=None):
    """Deterministic synthetic BA problem: every process builds the SAME
    problem from the seed (no broadcast needed). K cameras on a line looking
    at P points, noisy unit-plane observations (about 15 % missing), the
    first two cameras fixed, the points perturbed. On ``device``, by default
    this process's (:func:`local_device`)."""
    from ..core import se3
    from ..solvers import ba

    if device is None:
        device = local_device()
    rs = np.random.default_rng(seed)
    pts = rs.uniform([-3, -3, 4], [3, 3, 12], size=(P, 3)).astype(np.float32)
    xi = torch.tensor([[0.4 * k / K, 0, 0, 0, 0.01 * k, 0] for k in range(K)],
                      dtype=torch.float32)
    poses = se3.exp(xi)
    p_cam = se3.transform(poses[None], torch.from_numpy(pts)[:, None])
    uv = (p_cam[..., :2] / p_cam[..., 2:3]).numpy()
    uv = uv + rs.normal(0, noise, uv.shape).astype(np.float32)
    mask = rs.random((P, K)) > 0.15
    points = pts + rs.normal(0, perturb, pts.shape).astype(np.float32)
    return ba.BAProblem(
        poses=poses.to(device),
        fixed=torch.tensor([True, True] + [False] * (K - 2), device=device),
        points=torch.from_numpy(points).to(device),
        obs_uv=torch.from_numpy(uv.astype(np.float32)).to(device),
        obs_mask=torch.from_numpy(mask).to(device),
    )
