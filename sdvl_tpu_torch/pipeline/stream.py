"""Host-side loop of the stream: feed frames, read results once.

Counterpart of ``sdvl_tpu/pipeline/stream.py``. ``SdvlStream(cfg)`` runs
full SLAM mode from an empty map (FIRST -> SECOND -> RUNNING, building the
map as it tracks); :meth:`SdvlStream.localizer` serves against a map
snapshot written by either package, starting LOST. The loop

  * uploads each frame (uint8), or a whole chunk of frames in one copy,
    asynchronously, through a ring of pinned host buffers
    (:class:`HostUploads`);
  * steps the frame (``device_fsm.StepRunner``): on the card every frame,
    FIRST and SECOND included, is one replay of a CUDA graph captured at the
    stream's first frame, which decides its branches (the state, the
    bootstrap's success, and every decision of a tracking frame) on the
    device and reads nothing back; a chunk of T frames is one replay of a
    graph whose WHILE node runs the step T times (``graphs=False``: the
    eager card path, one host read per decision);
  * keeps each frame's ``FrameInfo`` packed in a device tensor of its own,
  * transfers all of them device->host exactly once, in :meth:`result`.

So on the card ``feed(block=False)`` returns before the frame is done, and
nothing synchronises between frames.

Random draws (:class:`NoiseSource`, shared with the host driver
``pipeline/sdvl.py``). The pose RANSAC needs Gumbel noise on every tracking
frame, the bootstrap twice per stream (homography and ground-plane
RANSACs). By default each draw comes from a ``torch.Generator`` seeded from
the session's seed and what it is for (the homography, the ground plane,
or frame ``i``'s pose), as the reference derives each from ``fold_in(key,
...)``: the numbers of a frame do not depend on what was drawn before it,
so both drivers and a resumed session see the same ones. A
``gumbel_provider`` replaces the draws,
which is how a test or a recorded run feeds the port the numbers another
implementation drew: either a callable ``frame index -> (n_hyp, S) array``
(pose noise only), or a :class:`Draws` holding all three.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import require_device
from ..core import se3
from .config import Config
from .device_fsm import (BootNoise, FrameInfo, STATE_LOST, StepRunner,
                         cropped_shape, init_state, lane_counts, unpack_info,
                         undistort_grid)

STATE_NAMES = {0: "FIRST_FRAME", 1: "SECOND_FRAME", 2: "RUNNING", 3: "LOST"}


class SlamResult:
    """Finalized (host-side) outputs of a streamed sequence."""

    def __init__(self, infos: FrameInfo):
        # infos: stacked FrameInfo with leading dim N (numpy)
        self.poses_raw = infos.pose              # (N, 7) as recorded
        self.states = infos.state                # (N,)
        self.quality = infos.quality
        self.n_matches = infos.n_matches
        self.n_attempts = infos.n_attempts
        self.is_keyframe = infos.is_keyframe
        self.n_corners = infos.n_corners
        self.median_shift = infos.median_shift
        self.trajectory = _rebase_trajectory(infos.pose, infos.world_tf)

    @property
    def n_frames(self) -> int:
        return int(self.poses_raw.shape[0])

    def state_name(self, i: int = -1) -> str:
        return STATE_NAMES[int(self.states[i])]


def _rebase_trajectory(poses: np.ndarray, world_tfs: np.ndarray) -> np.ndarray:
    """Express every recorded pose in the FINAL world frame.

    A frame whose ``world_tf`` is not identity re-based the world (the
    ground-plane alignment at bootstrap does, once); poses recorded
    *before* it are composed with the inverse. Walked backwards with a
    cumulative correction.
    """
    n = poses.shape[0]
    out = np.array(poses, copy=True)
    ident = se3.identity().numpy()
    C = torch.from_numpy(ident.copy())
    have_c = False
    for i in range(n - 1, -1, -1):
        if have_c:
            out[i] = se3.compose(torch.from_numpy(poses[i]), C).numpy()
        tf = world_tfs[i]
        if not np.allclose(tf, ident, atol=1e-12):
            C = se3.compose(se3.inverse(torch.from_numpy(tf)), C)
            have_c = True
    return out


class Draws(NamedTuple):
    """Every random draw of a stream, supplied from outside.

    ``pose(i)`` is the (n_hyp, S) pose-RANSAC noise of the stream's frame
    ``i`` (0-based count of frames fed), or None for a frame that draws
    none (FIRST and SECOND frames); ``homography`` (n_hyp_h, N corners) and
    ``plane`` (iters, P points) are the bootstrap's, used on every
    attempt."""

    pose: Callable[[int], Optional[np.ndarray]]
    homography: np.ndarray
    plane: np.ndarray


class HostUploads:
    """Host->device copies through a ring of pinned host buffers.

    A copy from pageable memory makes the CUDA runtime wait for the stream;
    from pinned memory it is asynchronous, so the host buffer must not be
    rewritten before the copy has run. Each slot records an event after its
    copy and is reused only once that event is done; while none is, the
    ring grows by a slot. Nothing waits. On the CPU a copy is a plain
    ``copy_``/``from_numpy``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._slots: List[list] = []    # [pinned uint8 buffer, event]

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` in a new tensor on the device."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return src.to(self.device)
        n = src.numel() * src.element_size()
        for slot in self._slots:
            if slot[0].numel() >= n and slot[1].query():
                break
        else:
            slot = [torch.empty(max(n, 1), dtype=torch.uint8,
                                pin_memory=True), torch.cuda.Event()]
            self._slots.append(slot)
        host = slot[0][:n].view(src.dtype).view(src.shape)
        host.copy_(src)
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        out.copy_(host, non_blocking=True)
        slot[1].record()
        return out


# the reference's fixed hypothesis counts of the two bootstrap RANSACs
HOMOGRAPHY_HYPOTHESES = 128
PLANE_HYPOTHESES = 64


class NoiseSource:
    """The random draws of one session, for either driver.

    ``boot`` is the bootstrap's :class:`BootNoise` (None when serving);
    :meth:`pose` gives the pose-RANSAC noise of frames. Both come from
    ``provider`` where one is given (a callable ``frame index -> (n_hyp, S)
    array`` for pose noise only, or a :class:`Draws`), else each from a
    generator seeded from ``(seed, what it is for)``: ``(seed, 0)`` the
    homography, ``(seed, 1)`` the ground plane, ``(seed, 2, i)`` the pose
    noise of frame ``i``."""

    def __init__(self, config: Config, seed: int, device, provider=None):
        s = config.sdvl
        self.device = device
        self.seed = seed
        self.provider = provider
        self.n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
        self._uploads = HostUploads(torch.device(device))
        n_corners, self.n_lanes = lane_counts(config)
        if isinstance(provider, Draws):
            self._pose_provider = provider.pose
        else:
            self._pose_provider = provider
        self.boot = None
        if not s.localize_only:
            shapes = ((HOMOGRAPHY_HYPOTHESES, n_corners),
                      (PLANE_HYPOTHESES, s.max_points))
            if isinstance(provider, Draws):
                arrays = (provider.homography, provider.plane)
                for a, shape in zip(arrays, shapes):
                    if np.shape(a) != shape:
                        raise ValueError(
                            f"bootstrap noise {np.shape(a)}, expected "
                            f"{shape}")
                self.boot = BootNoise(*(
                    torch.from_numpy(np.array(a, np.float32)).to(device)
                    for a in arrays))
            else:
                self.boot = BootNoise(*(self._draw(shape, tag)
                                        for tag, shape in enumerate(shapes)))

    def _draw(self, shape, *tag) -> torch.Tensor:
        """Standard Gumbel noise of ``shape`` from a generator seeded from
        ``(seed, *tag)``."""
        state = np.random.SeedSequence((self.seed,) + tag).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state))
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(shape, generator=gen, device=self.device)
        return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 1e-7)))

    def pose(self, first: int, count: int) -> List[Optional[torch.Tensor]]:
        """The pose-RANSAC noise of frames ``first .. first + count - 1``:
        the provider's numbers in one host->device copy (None for a frame it
        has none for), or each frame's own draw."""
        shape = (self.n_hyp, self.n_lanes)
        if self._pose_provider is None:
            return [self._draw(shape, 2, first + t) for t in range(count)]
        got = [self._pose_provider(first + t) for t in range(count)]
        have = [g for g in got if g is not None]
        if not have:
            return [None] * count
        g = np.stack([np.asarray(a, np.float32) for a in have])
        if g.shape[1:] != shape:
            raise ValueError(f"gumbel noise {g.shape[1:]}, expected {shape}")
        dev = iter(self._uploads.upload(g).unbind(0))
        return [None if a is None else next(dev) for a in got]


class SdvlStream:
    """Streaming run over the per-frame state machine.

    ``graphs`` (default: on for a CUDA device): every frame replays a CUDA
    graph (see the module note); ``graphs=False`` steps them eagerly. On
    the CPU every frame runs eagerly."""

    def __init__(self, config: Config, seed: int = 0, device="cuda",
                 gumbel_provider=None, graphs: Optional[bool] = None):
        self.cfg = config
        self.device = require_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device")
        self.graphs = graphs
        self.crop_h, self.crop_w = cropped_shape(config)
        self._grid = undistort_grid(config, self.device)
        self._undistort = self._grid is not None
        self._adopt(*init_state(config, seed, device=self.device))
        self._uploads = HostUploads(self.device)
        self._noise = NoiseSource(config, seed, self.device, gumbel_provider)
        self._boot = self._noise.boot
        self._n_fed = 0
        self._rows: List[torch.Tensor] = []   # packed FrameInfo per frame
        self.last_corners = None   # Corners of the newest frame

    def _adopt(self, m, carry) -> None:
        """Make ``(m, carry)`` the stream's state, written in place from
        now on. A captured graph holds the old state's addresses, so the
        stream starts a new runner (on the graph path it captures again at
        the next frame; eagerly it reads the state back until the stream
        tracks, unless it is a localizer's)."""
        self.runner = StepRunner(self.cfg, self._undistort, m, carry,
                                 self._grid, self.graphs)

    @property
    def m(self):
        return self.runner.st.m

    @m.setter
    def m(self, m) -> None:
        self._adopt(m, self.carry)

    @property
    def carry(self):
        return self.runner.st.carry

    @carry.setter
    def carry(self, carry) -> None:
        self._adopt(self.m, carry)

    def write_carry(self, **fields) -> None:
        """Write ``fields`` of the carry (``SlamCarry`` names; numbers or
        arrays) into the stream's storage in place: the graphs captured so
        far replay on, where setting ``carry`` starts a new runner that
        captures again. Numbers are filled on the device, arrays uploaded
        through pinned memory: nothing synchronises."""
        carry = self.carry
        for name, value in fields.items():
            dst = getattr(carry, name)
            if isinstance(value, (int, float, bool)):
                dst.fill_(value)
            else:
                src = torch.as_tensor(np.asarray(value)).to(dst.dtype)
                dst.copy_(self._uploads.upload(src.reshape(dst.shape)
                                               .numpy()))

    # --------------------------------------------------------- serving
    @classmethod
    def localizer(cls, config: Config, snapshot_path: str, seed: int = 0,
                  device="cuda", gumbel_provider=None,
                  graphs: Optional[bool] = None) -> "SdvlStream":
        """Localization-only serving stream against a frozen, prebuilt map.

        Loads a stream snapshot (``io.snapshot``; the JAX package's
        ``save_stream_snapshot`` writes the format) produced by a SLAM
        run with the same capacities, freezes its map and starts in LOST
        so the first frame relocalizes against the loaded keyframes.
        """
        from ..io.snapshot import load_stream_arrays

        if not config.sdvl.localize_only:
            config = dataclasses.replace(
                config,
                sdvl=dataclasses.replace(config.sdvl, localize_only=True),
            )
        stream = cls(config, seed=seed, device=device,
                     gumbel_provider=gumbel_provider, graphs=graphs)
        m, carry = load_stream_arrays(snapshot_path, device=stream.device)
        if m.capacities != stream.m.capacities:
            raise ValueError(
                f"snapshot capacities {m.capacities} != config "
                f"{stream.m.capacities}"
            )
        dev = stream.device
        stream._adopt(m, carry._replace(
            state=torch.tensor(STATE_LOST, dtype=torch.int32, device=dev),
            lost_frames=torch.tensor(3, dtype=torch.int32, device=dev),
            xi_model=torch.zeros(6, dtype=torch.float32, device=dev),
        ))
        return stream

    # ------------------------------------------------------------- feeding
    def _step(self, img: torch.Tensor, gumbel) -> FrameInfo:
        row, self.last_corners = self.runner.step(img, gumbel, self._boot)
        self._n_fed += 1
        self._rows.append(row)
        return unpack_info(row)

    def feed(self, img: np.ndarray, block: bool = False) -> FrameInfo:
        """Process one frame. Returns its FrameInfo as device tensors."""
        img = np.asarray(img)[: self.crop_h, : self.crop_w]
        info = self._step(self._uploads.upload(img),
                          self._noise.pose(self._n_fed, 1)[0])
        if block:
            self.block()
        return info

    def feed_chunk(self, imgs: np.ndarray, block: bool = False
                   ) -> FrameInfo:
        """Process a (T, H, W) stack of frames: ONE host->device copy, then
        on the card ONE replay of the chunk graph of T frames (a WHILE node
        over the step: ``make_chunk_step``'s scan), eagerly one step per
        frame. Returns one FrameInfo of device tensors with leading axis T,
        as the reference's scan does."""
        imgs = np.asarray(imgs)[:, : self.crop_h, : self.crop_w]
        dev_imgs = self._uploads.upload(imgs)
        gumbels = self._noise.pose(self._n_fed, len(imgs))
        rows, self.last_corners = self.runner.chunk(dev_imgs, gumbels,
                                                    self._boot)
        self._n_fed += len(imgs)
        self._rows.extend(rows.unbind(0))
        if block:
            self.block()
        return unpack_info(rows)

    def block(self):
        """Wait for all dispatched work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- results
    def result(self) -> SlamResult:
        """ONE device->host transfer of every recorded frame's packed
        info."""
        if not self._rows:
            raise ValueError("no frames fed")
        return SlamResult(unpack_infos(torch.stack(self._rows).cpu().numpy()))


def unpack_infos(packed: np.ndarray) -> FrameInfo:
    """Frames' packed infos (N, 21) (``device_fsm.pack_info``) on the host:
    a FrameInfo of numpy arrays with leading dim N."""
    return FrameInfo(*(t.numpy() for t in unpack_info(
        torch.from_numpy(packed))))
