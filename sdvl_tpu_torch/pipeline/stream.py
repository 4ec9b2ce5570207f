"""Host-side loop of the stream: feed frames, read results once.

Counterpart of ``sdvl_tpu/pipeline/stream.py``. ``SdvlStream(cfg)`` runs
full SLAM mode from an empty map (FIRST -> SECOND -> RUNNING, building the
map as it tracks); :meth:`SdvlStream.localizer` serves against a map
snapshot written by either package, starting LOST. The loop

  * uploads each frame (uint8), or a whole chunk of frames in one copy,
  * runs one step per frame (a Python loop; the step reads a few scalars
    back per frame to choose its branches, see ``pipeline/device_fsm.py``),
  * accumulates per-frame ``FrameInfo`` as device tensors,
  * transfers all of them device->host exactly once, in :meth:`result`.

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
from .device_fsm import (BootNoise, FrameInfo, STATE_LOST, cropped_shape,
                         init_state, lane_counts, make_chunk_step, make_step,
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
        dev = iter(torch.from_numpy(g).to(self.device).unbind(0))
        return [None if a is None else next(dev) for a in got]


class SdvlStream:
    """Streaming run over the per-frame state machine."""

    def __init__(self, config: Config, seed: int = 0, device="cuda",
                 gumbel_provider=None):
        self.cfg = config
        self.device = require_device(device)
        self.crop_h, self.crop_w = cropped_shape(config)
        self._grid = undistort_grid(config, self.device)
        self._undistort = self._grid is not None
        self._step = make_step(config, self._undistort)
        self._chunk_step = make_chunk_step(config, self._undistort)

        self.m, self.carry = init_state(config, seed, device=self.device)
        self._noise = NoiseSource(config, seed, self.device, gumbel_provider)
        self._boot = self._noise.boot
        self._n_fed = 0
        self._infos: List[FrameInfo] = []
        self.last_corners = None   # Corners of the newest frame

    # --------------------------------------------------------- serving
    @classmethod
    def localizer(cls, config: Config, snapshot_path: str, seed: int = 0,
                  device="cuda", gumbel_provider=None) -> "SdvlStream":
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
                     gumbel_provider=gumbel_provider)
        m, carry = load_stream_arrays(snapshot_path, device=stream.device)
        if m.capacities != stream.m.capacities:
            raise ValueError(
                f"snapshot capacities {m.capacities} != config "
                f"{stream.m.capacities}"
            )
        dev = stream.device
        stream.m = m
        stream.carry = carry._replace(
            state=torch.tensor(STATE_LOST, dtype=torch.int32, device=dev),
            lost_frames=torch.tensor(3, dtype=torch.int32, device=dev),
            xi_model=torch.zeros(6, dtype=torch.float32, device=dev),
        )
        return stream

    # ------------------------------------------------------------- feeding
    def feed(self, img: np.ndarray, block: bool = False) -> FrameInfo:
        """Process one frame. Returns its FrameInfo as device tensors."""
        img = np.ascontiguousarray(
            np.asarray(img)[: self.crop_h, : self.crop_w])
        self.m, self.carry, info, self.last_corners = self._step(
            self.m, self.carry, torch.from_numpy(img).to(self.device),
            self._grid, self._noise.pose(self._n_fed, 1)[0], self._boot)
        self._n_fed += 1
        self._infos.append(info)
        if block:
            self.block()
        return info

    def feed_chunk(self, imgs: np.ndarray, block: bool = False
                   ) -> List[FrameInfo]:
        """Process a (T, H, W) stack of frames: ONE host->device copy, then
        a Python loop over its frames."""
        imgs = np.ascontiguousarray(
            np.asarray(imgs)[:, : self.crop_h, : self.crop_w])
        dev_imgs = torch.from_numpy(imgs).to(self.device)
        gumbels = self._noise.pose(self._n_fed, len(imgs))
        self.m, self.carry, infos, self.last_corners = self._chunk_step(
            self.m, self.carry, dev_imgs, self._grid, gumbels, self._boot)
        self._n_fed += len(imgs)
        self._infos.extend(infos)
        if block:
            self.block()
        return infos

    def block(self):
        """Wait for all dispatched work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- results
    def result(self) -> SlamResult:
        """ONE device->host transfer of every recorded frame's info
        (:func:`pack_infos`)."""
        if not self._infos:
            raise ValueError("no frames fed")
        return SlamResult(unpack_infos(pack_infos(self._infos).cpu().numpy()))


def pack_infos(infos: List[FrameInfo]) -> torch.Tensor:
    """Frames' infos packed on their device into one (N, 21) float32 matrix
    (pose 7 + world_tf 7 + 7 scalar columns; every int fits float32
    exactly), for a single device->host copy."""
    return torch.stack([
        torch.cat([
            info.pose, info.world_tf,
            torch.stack([
                info.state.float(), info.quality.float(),
                info.n_matches.float(), info.n_attempts.float(),
                info.is_keyframe.float(), info.n_corners.float(),
                info.median_shift.float(),
            ]),
        ])
        for info in infos
    ])


def unpack_infos(packed: np.ndarray) -> FrameInfo:
    """Inverse of :func:`pack_infos` on the host: a FrameInfo of numpy
    arrays with leading dim N."""
    return FrameInfo(
        pose=packed[:, 0:7],
        world_tf=packed[:, 7:14],
        state=packed[:, 14].astype(np.int32),
        quality=packed[:, 15].astype(np.int32),
        n_matches=packed[:, 16].astype(np.int32),
        n_attempts=packed[:, 17].astype(np.int32),
        is_keyframe=packed[:, 18] > 0.5,
        n_corners=packed[:, 19].astype(np.int32),
        median_shift=packed[:, 20],
    )
