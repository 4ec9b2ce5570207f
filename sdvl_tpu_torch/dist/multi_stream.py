"""Multi-stream serving: N camera streams, one SLAM session each.

Counterpart of ``sdvl_tpu/dist/multi_stream.py``. The JAX package runs the
sessions as one ``shard_map``-ped launch per frame batch; inside a shard a
host-unrolled loop steps the device's own streams one after the other. On
one device that loop is the whole program, and so it is here: one step per
stream per frame (``device_fsm.StepRunner``), each stream with its own carry
and its own random draws. On the card every stream has a CUDA graph of its
own, captured at its first tracking frame, so a frame batch of tracking
streams is N replays with no host read (``graphs=False``: eager steps).
Streams never communicate.

Two modes, as in the reference:

  * per-stream maps (``frozen_map=None``): stream ``i`` starts from
    ``init_state(config, seed + i)`` and builds its own map in full SLAM
    mode;
  * a frozen shared map (``frozen_map``: a stream snapshot path or a live
    ``(MapState, SlamCarry)`` tuple): ONE map, adopted by reference and
    never written or copied, served read-only to every stream (every
    stream's graph reads the one map); its
    capacities must equal the config's. ``localize_only`` is forced on.
    Stream ``i``'s carry is ``init_carry(config, seed + i)`` in LOST with
    ``lost_frames = 3`` and the snapshot's pose (not the snapshot's whole
    carry, as ``SdvlStream.localizer`` keeps).

The multi-stream step never undistorts (its runners step with
``undistort=False``, as the reference's ``make_step``): frames of a
distorted config are used as given.

Over a mesh with a ``stream`` axis of R ranks, rank r runs streams
``r * N/R .. (r + 1) * N/R - 1`` of the batch every rank is fed;
:meth:`MultiStream.result` is collective and gives every rank all streams'
results.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import require_device
from ..pipeline.config import Config
from ..pipeline.device_fsm import (STATE_LOST, FrameInfo, StepRunner,
                                   cropped_shape, init_carry, init_state,
                                   unpack_info)
from ..pipeline.stream import (HostUploads, NoiseSource, SlamResult,
                               unpack_infos)
from . import mesh as mesh_mod


class MultiStream:
    """N independent SLAM sessions on one device (or split over the ranks
    of a mesh's ``axis``).

    ``gumbel_providers``: one random-draw provider per stream (as
    ``SdvlStream``'s ``gumbel_provider``), indexed by the global stream
    number; by default stream ``i`` draws from ``NoiseSource(seed + i)``.

    ``graphs`` (default: on for a CUDA device): each local stream replays
    its own CUDA graph on tracking frames.

    ``m`` is the shared map (frozen mode) or the local streams' maps (a
    list), ``carries`` the local streams' carries.
    """

    def __init__(self, config: Config, n_streams: int, seed: int = 0,
                 frozen_map=None, device="cuda", mesh=None,
                 axis: str = "stream",
                 gumbel_providers: Optional[Sequence] = None,
                 graphs: Optional[bool] = None):
        self.frozen = frozen_map is not None
        if self.frozen and not config.sdvl.localize_only:
            config = dataclasses.replace(
                config,
                sdvl=dataclasses.replace(config.sdvl, localize_only=True),
            )
        if gumbel_providers is not None and len(gumbel_providers) != n_streams:
            raise ValueError(f"{len(gumbel_providers)} providers for "
                             f"{n_streams} streams")
        self.cfg = config
        self.n = n_streams
        self.device = require_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.crop_h, self.crop_w = cropped_shape(config)
        self._group = mesh_mod.axis_group(mesh, axis)
        self.local = range(n_streams)[mesh_mod.shard_rows(n_streams, mesh,
                                                          axis)]
        dev = self.device
        s = config.sdvl

        if self.frozen:
            from ..io.snapshot import load_stream_arrays

            # a live tuple is adopted by reference: the step never writes
            # the map, and nothing here copies it
            m0, c_snap = (frozen_map if isinstance(frozen_map, tuple)
                          else load_stream_arrays(frozen_map, device=dev))
            caps = (s.max_keyframes, s.max_points, s.max_candidates)
            if m0.capacities != caps:
                raise ValueError(
                    f"snapshot capacities {m0.capacities} != config {caps}")
            self._shared = m0
            states = [
                (m0, init_carry(config, seed + i, device=dev)._replace(
                    state=torch.tensor(STATE_LOST, dtype=torch.int32,
                                       device=dev),
                    lost_frames=torch.tensor(3, dtype=torch.int32,
                                             device=dev),
                    pose=c_snap.pose.to(dev).clone(),
                ))
                for i in self.local
            ]
        else:
            states = [init_state(config, seed + i, device=dev)
                      for i in self.local]
        self._runners = [
            StepRunner(config, False, m, carry, graphs=graphs,
                       frozen_map=self.frozen)
            for m, carry in states
        ]
        self._noise = [
            NoiseSource(config, seed + i, dev,
                        None if gumbel_providers is None
                        else gumbel_providers[i])
            for i in self.local
        ]
        self._uploads = HostUploads(dev)
        self._n_fed = 0
        # the packed FrameInfos of every feed, (T, local streams, 21) each
        self._rows: List[torch.Tensor] = []

    @property
    def m(self):
        if self.frozen:
            return self._shared
        return [r.st.m for r in self._runners]

    @property
    def carries(self):
        return [r.st.carry for r in self._runners]

    @property
    def runners(self) -> List[StepRunner]:
        """The local streams' step runners (their graphs and counts)."""
        return self._runners

    def _upload(self, imgs: np.ndarray) -> torch.Tensor:
        """The local streams' frames, cropped, in one host->device copy;
        ``imgs`` has the stream axis at dim -3."""
        imgs = np.asarray(imgs)[..., self.local.start:self.local.stop,
                                : self.crop_h, : self.crop_w]
        return self._uploads.upload(imgs)

    def _run(self, frames: torch.Tensor) -> FrameInfo:
        """Step every local stream over ``frames`` (T, local, H, W), frame
        by frame; the frames' infos with leaves (T, local, ...)."""
        T = frames.shape[0]
        noise = [src.pose(self._n_fed, T) for src in self._noise]
        rows = torch.stack([r.step(frames[t, j], noise[j][t],
                                   self._noise[j].boot)[0]
                            for t in range(T)
                            for j, r in enumerate(self._runners)])
        rows = rows.view(T, len(self._runners), -1)
        self._rows.append(rows)
        self._n_fed += T
        return unpack_info(rows)

    def feed(self, imgs: np.ndarray, block: bool = False) -> FrameInfo:
        """One frame per stream: ``imgs`` is (N, H, W). Returns the local
        streams' FrameInfo of device tensors with leading axis N (over a
        mesh, this rank's streams), as the reference's step does."""
        info = self._run(self._upload(imgs)[None])
        if block:
            self.block()
        return FrameInfo(*(x[0] for x in info))

    def feed_chunk(self, imgs: np.ndarray, block: bool = False) -> FrameInfo:
        """T frames per stream in one host->device copy: ``imgs`` is
        (T, N, H, W). Returns the local streams' FrameInfo of device
        tensors with leading axes (T, N), as the reference's scan does."""
        info = self._run(self._upload(imgs))
        if block:
            self.block()
        return info

    def block(self):
        """Wait for all dispatched work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def result(self, stream: Optional[int] = None):
        """Every stream's ``SlamResult`` (a list), or stream ``stream``'s:
        the local streams' infos packed on the device, gathered over the
        mesh's ranks, then ONE device->host copy. Collective over a mesh:
        every rank calls it."""
        if not self._n_fed:
            raise ValueError("no frames fed")
        packed = torch.cat(self._rows).transpose(0, 1)   # (local, T, 21)
        packed = mesh_mod.gather_rows(packed, self._group).cpu().numpy()
        results = [SlamResult(unpack_infos(p)) for p in packed]
        return results if stream is None else results[stream]
