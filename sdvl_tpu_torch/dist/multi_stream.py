"""Multi-stream serving: N camera streams, one SLAM session each.

Counterpart of ``sdvl_tpu/dist/multi_stream.py``. The JAX package runs the
sessions as one ``shard_map``-ped launch per frame batch: inside a shard a
host-unrolled loop steps the device's own streams one after the other
(``frozen_step``, ``sharded_step``), and ``feed_chunk`` is one ``lax.scan``
of that loop over T frames (``frozen_chunk``, ``sharded_chunk``). So it is
here. :meth:`MultiStream.batch_frame` steps the local streams one after the
other, each through the step ``SdvlStream`` runs
(``device_fsm.make_frame``) with its own carry and its own random draws;
:meth:`MultiStream.batch_chunk` is ``device_fsm.device_fori`` over T frames
with ``batch_frame`` as its body. On the card (``graphs``, on by default) a
frame batch is one replay of a CUDA graph of ``batch_frame`` over all
local streams, captured at the first ``feed``, and a chunk of T frames one
replay of a graph of ``batch_chunk`` (a WHILE node over the batch),
captured at the first chunk of T frames; the graphs share one memory pool
(they never run at once) and read nothing back. With ``graphs=False``, and
always on the CPU, ``feed`` and ``feed_chunk`` run the same two functions
eagerly. Streams never communicate, and they run one after another on the
device, as in the reference.

Two modes, as in the reference:

  * per-stream maps (``frozen_map=None``): stream ``i`` starts from
    ``init_state(config, seed + i)`` and builds its own map in full SLAM
    mode;
  * a frozen shared map (``frozen_map``: a stream snapshot path or a live
    ``(MapState, SlamCarry)`` tuple): ONE map, adopted by reference and
    never written or copied, served read-only to every stream (the batch
    graphs read the one map); its
    capacities must equal the config's. ``localize_only`` is forced on.
    Stream ``i``'s carry is ``init_carry(config, seed + i)`` in LOST with
    ``lost_frames = 3`` and the snapshot's pose (not the snapshot's whole
    carry, as ``SdvlStream.localizer`` keeps).

The multi-stream step never undistorts (``make_frame(config, False)``, as
the reference's ``make_step``): frames of a distorted config are used as
given.

Over a mesh with a ``stream`` axis of R ranks, rank r runs streams
``r * N/R .. (r + 1) * N/R - 1`` of the batch every rank is fed (its
graphs hold those streams); :meth:`MultiStream.result` is collective and
gives every rank all streams' results.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import require_device
from ..pipeline.config import Config
from ..pipeline.device_fsm import (INFO_WIDTH, STATE_LOST, FrameInfo,
                                   StageGraph, StepState, cropped_shape,
                                   device_fori, init_carry, init_state,
                                   make_frame, unpack_info)
from ..pipeline.stream import (HostUploads, NoiseSource, SlamResult,
                               unpack_infos)
from . import mesh as mesh_mod


class MultiStream:
    """N independent SLAM sessions on one device (or split over the ranks
    of a mesh's ``axis``).

    ``gumbel_providers``: one random-draw provider per stream (as
    ``SdvlStream``'s ``gumbel_provider``), indexed by the global stream
    number; by default stream ``i`` draws from ``NoiseSource(seed + i)``.

    ``graphs`` (default: on for a CUDA device): a frame batch is one replay
    of the batch graph over all local streams, a chunk of T frames one
    replay of the chunk graph of T (see the module note), held by name in
    ``batch_graphs``. ``graphs=False``: the same batch functions,
    eagerly.

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
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device")
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
        self._states = tuple(
            StepState(m, carry, inplace=True, frozen_map=self.frozen)
            for m, carry in states)
        self._noise = [
            NoiseSource(config, seed + i, dev,
                        None if gumbel_providers is None
                        else gumbel_providers[i])
            for i in self.local
        ]
        self._boots = tuple(src.boot for src in self._noise)
        self._frame = make_frame(config, False)
        # whether each stream is known to track: its frames then build the
        # tracking branch alone (eagerly updated from each frame, as
        # StepRunner does; serving streams track from the start)
        self._tracking = [s.localize_only] * len(self._states)
        self.graphs = graphs
        # the batch graphs by name, "batch_frame" and "batch_chunk_<T>",
        # sharing one pool: they never run at once
        self.batch_graphs: Dict[str, StageGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._uploads = HostUploads(dev)
        self._n_fed = 0
        # the packed FrameInfos of every feed, (T, local streams, 21) each
        self._rows: List[torch.Tensor] = []

    @property
    def m(self):
        if self.frozen:
            return self._shared
        return [st.m for st in self._states]

    @property
    def carries(self):
        return [st.carry for st in self._states]

    @property
    def replays(self) -> Dict[str, int]:
        """Each batch graph's replays."""
        return {k: g.replays for k, g in self.batch_graphs.items()}

    @property
    def pool_bytes(self) -> Dict[str, int]:
        """The device memory each batch graph's capture added to the shared
        pool (their sum is the pool's)."""
        return {k: g.pool_bytes for k, g in self.batch_graphs.items()}

    @property
    def capture_s(self) -> Dict[str, float]:
        """Host seconds of each batch graph's warm-up and capture."""
        return {k: g.capture_s for k, g in self.batch_graphs.items()}

    def batch_frame(self, states, imgs: torch.Tensor, gumbels: torch.Tensor,
                    boots) -> torch.Tensor:
        """One frame of every stream of ``states`` (a :class:`StepState`
        each), stream 0 first: ``imgs`` (L, H, W), ``gumbels``
        (L, n_hyp, S) pose noise, ``boots`` a ``BootNoise`` (or None) per
        stream. Returns the frames' packed infos (L, ``INFO_WIDTH``): the
        reference's ``frozen_step`` / ``sharded_step``."""
        rows = []
        for j, st in enumerate(states):
            row, _, tracks = self._frame(st, imgs[j], None, gumbels[j],
                                         boots[j], self._tracking[j])
            if not self.graphs:
                self._tracking[j] = tracks
            rows.append(row)
        return torch.stack(rows)

    def batch_chunk(self, states, imgs: torch.Tensor, gumbels: torch.Tensor,
                    boots) -> torch.Tensor:
        """T frames of every stream: ``device_fori`` over ``imgs``
        (T, L, H, W) and ``gumbels`` (T, L, n_hyp, S) with
        :meth:`batch_frame` as its body; the packed infos
        (T, L, ``INFO_WIDTH``). The reference's ``frozen_chunk`` /
        ``sharded_chunk``."""
        T, L = imgs.shape[:2]
        rows = torch.zeros((T, L, INFO_WIDTH), dtype=torch.float32,
                           device=imgs.device)

        def body(i, rows):
            at = i.long().reshape(1)
            row = self.batch_frame(states, imgs.index_select(0, at)[0],
                                   gumbels.index_select(0, at)[0], boots)
            return rows.index_copy(0, at, row[None])

        return device_fori(T, body, rows)

    def _upload(self, imgs: np.ndarray) -> torch.Tensor:
        """The local streams' frames, cropped, in one host->device copy;
        ``imgs`` has the stream axis at dim -3."""
        imgs = np.asarray(imgs)[..., self.local.start:self.local.stop,
                                : self.crop_h, : self.crop_w]
        return self._uploads.upload(imgs)

    def _gumbels(self, T: int) -> torch.Tensor:
        """The local streams' pose noise of the next ``T`` frames,
        (T, L, n_hyp, S), each from its own source; zeros where a source has
        none (a FIRST or SECOND frame's)."""
        per = [src.pose(self._n_fed, T) for src in self._noise]
        src = self._noise[0]
        zero = torch.zeros((src.n_hyp, src.n_lanes), dtype=torch.float32,
                           device=self.device)
        return torch.stack([
            torch.stack([zero if p[t] is None else p[t] for p in per])
            for t in range(T)])

    def _run(self, frames: torch.Tensor, chunk: bool) -> FrameInfo:
        """Step every local stream over ``frames`` (T, local, H, W): one
        batch (T = 1, not ``chunk``) or one chunk; the frames' infos with
        leaves (T, local, ...)."""
        T = frames.shape[0]
        gumbels = self._gumbels(T)
        if chunk:
            name, fn, inputs = f"batch_chunk_{T}", self.batch_chunk, (
                frames, gumbels, self._boots)
        else:
            name, fn, inputs = "batch_frame", self.batch_frame, (
                frames[0], gumbels[0], self._boots)
        if not self.graphs:
            rows = fn(self._states, *inputs)
        else:
            graph = self.batch_graphs.get(name)
            if graph is None:
                graph = self.batch_graphs[name] = StageGraph(
                    name, fn, self._states, inputs,
                    shared_map=self.cfg.sdvl.localize_only, pool=self._pool)
            rows = graph(*inputs).clone()
        rows = rows.view(T, len(self._states), INFO_WIDTH)
        self._rows.append(rows)
        self._n_fed += T
        return unpack_info(rows)

    def feed(self, imgs: np.ndarray, block: bool = False) -> FrameInfo:
        """One frame per stream: ``imgs`` is (N, H, W). Returns the local
        streams' FrameInfo of device tensors with leading axis N (over a
        mesh, this rank's streams), as the reference's step does."""
        info = self._run(self._upload(imgs)[None], chunk=False)
        if block:
            self.block()
        return FrameInfo(*(x[0] for x in info))

    def feed_chunk(self, imgs: np.ndarray, block: bool = False) -> FrameInfo:
        """T frames per stream in one host->device copy, then one
        :meth:`batch_chunk` (on the card one replay of its graph for T):
        ``imgs`` is (T, N, H, W). Returns the local streams' FrameInfo of
        device tensors with leading axes (T, N), as the reference's scan
        does."""
        info = self._run(self._upload(imgs), chunk=True)
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
