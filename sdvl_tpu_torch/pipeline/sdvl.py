"""Top-level SLAM orchestrator: the host-side state machine over the port's
per-stage functions.

Counterpart of ``sdvl_tpu/pipeline/sdvl.py``. The per-pixel and per-point
work runs in the port's modules (the same functions the stream's step
calls); the state machine itself -- a dozen scalar decisions per frame --
runs in Python on numbers read from the device once per frame.

State. The map ``m`` and the inter-frame device state (``last_pyr``,
``last_pose``, ``xi_model``, ``last_match_idx``, ``last_match_ok``) are
fixed storage, written in place (a ``device_fsm.StepState``) on every
device, so each stage reads and writes the same tensors on every frame.

Stages. Where the reference jits a stage, the port runs it, on the card, as
the replay of a CUDA graph (``device_fsm.StageGraph``) captured at its first
call: the locked preprocess; predict and track with the point-statistics
fold; relocalize (the nearest ``reloc_max_keyframes``, or after
``reloc_escalate_after`` failed LOST frames every keyframe: each sweep a
graph, captured when first needed), take the winning keyframe as the
reference and track, without the fold; the depth-filter update; the
keyframe stage (insertion, local BA, pruning, then the depth-filter update).
The host picks which tracking graph to replay from the numbers it has
read. The bootstrap frames' stages are graphs too, as the reference jits
them: FIRST's detection and corner count; the two-view bootstrap; the seed
map with the two-view local BA and the ground-plane alignment, which runs
where the bootstrap succeeded (a ``device_if``: an IF node, decided on the
device); the initial match set. ``graphs=False`` runs the same stages
eagerly on the card, as the CPU always does.

Host reads per frame: FIRST frames read the corner count; SECOND frames read
the bootstrap's ``(median_shift, n_inliers, ok_flow)`` in one copy, with the
seed stage's decision, the initial match count, the new pose and the world
transform (eagerly the seed stage's ``device_if`` reads its predicate too);
RUNNING and LOST frames read ``(n_matches, n_attempts)`` together with the
tracked and the predicted pose in one copy (:func:`_host_read`), which
gives the quality decision and the trajectory's host copy at once. Frames
are uploaded through pinned buffers, which does not synchronise.

Random draws come from a :class:`~sdvl_tpu_torch.pipeline.stream.
NoiseSource`, as in the stream: the bootstrap's homography and ground-plane
noise (the same on every attempt) and the pose-RANSAC noise of frame
``frame_id``, drawn when that frame tracks. Each draw is keyed by what it is
for, so with the same seed both drivers and a resumed session see the same
numbers. A provider (``Draws``) feeds both drivers the numbers the JAX
package draws from ``fold_in(key, 0 | 1 | frame_id)``.

Mapping runs inline by default; :class:`~sdvl_tpu_torch.pipeline.runtime.
AsyncMapper` moves it to a thread and a map of its own.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import require_device
from ..core import se3
from ..state.map_state import MapState, empty_map
from ..utils import trace
from . import (bootstrap, device_fsm, mapper, matcher, relocalize, tracker)
from .config import Config, intrinsics
from .stream import HostUploads, NoiseSource


class TrackingState(enum.Enum):
    FIRST_FRAME = 0
    SECOND_FRAME = 1
    RUNNING = 2
    LOST = 3


class TrackingQuality(enum.Enum):
    BAD = 0
    INSUFFICIENT = 1
    GOOD = 2


class HostCarry(NamedTuple):
    """The host driver's inter-frame device state."""

    last_pyr: Tuple[torch.Tensor, ...]   # previous frame's pyramid, f32
    last_pose: torch.Tensor    # (7,) newest world->cam pose
    xi_model: torch.Tensor     # (6,) constant-velocity model
    last_idx: torch.Tensor     # (S,) int64 last good frame's point slots
    last_ok: torch.Tensor      # (S,) its inlier mask


def _host_read(row: torch.Tensor) -> np.ndarray:
    """The one host read of a tracking frame."""
    return row.cpu().numpy()


def _carry_field(name: str, flag: Optional[str] = None, doc: str = ""):
    """A property over the storage of ``HostCarry.<name>``; the setter
    copies into it. With ``flag``, the field reads None until it was first
    written (the attribute ``flag`` records that)."""

    def get(self):
        if flag is not None and not getattr(self, flag):
            return None
        return getattr(self._st.carry, name)

    def set_(self, value):
        self._st.update(carry=self._st.carry._replace(**{name: value}))
        if flag is not None:
            setattr(self, flag, True)

    return property(get, set_, doc=doc)


class SDVL:
    """The system facade: :meth:`handle_frame` per image, :meth:`get_pose`,
    the ``trajectory`` as ``(frame_id, pose (7,))`` host copies, the map
    ``m``. Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``graphs`` (default: on for a CUDA device): tracking frames replay the
    stages' CUDA graphs (see the module note)."""

    def __init__(self, config: Config, seed: int = 0, device="cuda",
                 tracer=None, gumbel_provider=None,
                 graphs: Optional[bool] = None):
        self.device = require_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device")
        self.graphs = graphs
        self.tracer = tracer if tracer is not None else trace.tracer()
        self.cfg = config
        s = config.sdvl
        self.intr = intrinsics(config)
        self.levels = s.pyramid_levels
        self.crop_h, self.crop_w = device_fsm.cropped_shape(config)

        dev = self.device
        m = empty_map(
            n_kf=s.max_keyframes, n_pts=s.max_points,
            n_cand=s.max_candidates, img_shape=(self.crop_h, self.crop_w),
            levels=self.levels, device=dev,
        )
        n_lanes = device_fsm.lane_counts(config)[1]
        carry = HostCarry(
            last_pyr=tuple(
                torch.zeros((self.crop_h >> l, self.crop_w >> l),
                            dtype=torch.float32, device=dev)
                for l in range(self.levels)),
            last_pose=se3.identity(device=dev),
            xi_model=torch.zeros(6, dtype=torch.float32, device=dev),
            last_idx=torch.zeros(n_lanes, dtype=torch.int64, device=dev),
            last_ok=torch.zeros(n_lanes, dtype=torch.bool, device=dev),
        )
        self._st = device_fsm.StepState(m, carry, inplace=True)
        self._have_pyr = self._have_matches = False
        self._graphs = {}          # stage name -> device_fsm.StageGraph
        self._pool = None          # the memory pool they share
        self._undistort_grid = device_fsm.undistort_grid(config, dev)
        self._pre = device_fsm.make_preprocess(
            config, self._undistort_grid is not None)
        self._uploads = HostUploads(dev)
        self._noise = NoiseSource(config, seed, dev, gumbel_provider)

        self.state = TrackingState.FIRST_FRAME
        self.quality = TrackingQuality.GOOD
        self.frame_id = 0
        self.frames_since_kf = 0
        self.kf_matches = 1
        self.lost_frames = 0
        # the reference's PRNG key (uint32 words [seed >> 32, seed]), kept
        # for its snapshots; the draws themselves come from the NoiseSource
        self.key = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)

        self._last_pose_host = se3.identity().numpy()
        self._first_fs = None
        self._async_mapper = None  # set by runtime.AsyncMapper
        self.trajectory = []       # (frame_id, pose (7,)) host copies

    # ------------------------------------------------------------ storage
    @property
    def m(self) -> MapState:
        """The map: fixed storage, written in place. Assigning a map of
        the same capacities copies it in; the stages' graphs stay valid.
        While an async mapper is attached it owns map writes."""
        return self._st.m

    @m.setter
    def m(self, m: MapState) -> None:
        if self._async_mapper is not None:
            raise RuntimeError("the async mapper owns the map's writes: "
                               "stop it before assigning a map")
        self._st.update(m=m)

    last_pyr = _carry_field("last_pyr", "_have_pyr",
                            "The previous frame's pyramid (None before the "
                            "first frame).")
    xi_model = _carry_field("xi_model", doc="The constant-velocity model.")
    last_match_idx = _carry_field(
        "last_idx", "_have_matches",
        "The last good frame's matched point slots (None before the map "
        "exists).")
    last_match_ok = _carry_field("last_ok", "_have_matches",
                                 "Their inlier mask.")

    @property
    def last_pose(self) -> torch.Tensor:
        return self._st.carry.last_pose

    @property
    def pool_bytes(self) -> int:
        """Device memory the stages' graphs took from their pool."""
        return sum(g.pool_bytes for g in self._graphs.values())

    def _set_pose(self, pose: torch.Tensor, host: np.ndarray):
        """The pose of the newest frame, on the device and its host copy."""
        self._st.update(carry=self._st.carry._replace(last_pose=pose))
        self._last_pose_host = host

    def _set_mapper(self, mapper_) -> None:
        """Attach (``None``: detach) an async mapper. The tracking stages'
        graphs were captured for the other owner of the map's writes, so
        they are dropped (their pool with them)."""
        self._async_mapper = mapper_
        self._graphs.clear()
        self._pool = None

    def _stage(self, name: str, fn, *inputs, writes_map: bool = False):
        """``fn(self._st, *inputs)``: eagerly, or with graphs on as a replay
        of the stage's CUDA graph, captured at its first call (while no
        other thread uses the card: an attached mapper is drained first).
        A replay's outputs are the graph's and the next replay of that stage
        overwrites them."""
        if not self.graphs:
            return fn(self._st, *inputs)
        g = self._graphs.get(name)
        if g is None:
            if self._async_mapper is not None:
                self._async_mapper.barrier()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[name] = device_fsm.StageGraph(
                name, fn, self._st, inputs, shared_map=not writes_map,
                pool=self._pool)
        return g(*inputs)

    # ------------------------------------------------------------ stages
    def _preprocess(self, img, lock_xy=None, lock_valid=None):
        return self._pre(img, self._undistort_grid, lock_xy, lock_valid)

    def _preprocess_locked(self, st, img):
        """Steady-state variant: suppress detector cells already holding
        tracked map points, projected at the previous frame's pose."""
        c = st.carry
        lock_xy, lock_valid = device_fsm.lock_points(
            self.intr, st.m, c.last_pose, c.last_idx, c.last_ok)
        return self._preprocess(img, lock_xy, lock_valid)

    def _detect(self, st, img):
        """FIRST's (and SECOND's) stage: the unlocked preprocess and the
        corner count."""
        pyr, corners = self._preprocess(img)
        return pyr, corners, torch.sum(corners.valid).to(torch.int32)

    def _bootstrap(self, st, pyr1, pyr2, corners_xy, corners_valid):
        s = self.cfg.sdvl
        return bootstrap.init_two_view(
            self.intr, pyr1, pyr2, corners_xy, corners_valid,
            self._noise.boot.homography, map_scale=s.map_scale,
            thresh_px=s.inlier_error_threshold,
            min_corners=s.min_init_corners,
        )

    def _seed_map(self, m: MapState, pyr1, pyr2, boot, corners2):
        """Write the two bootstrap keyframes (frame ids 0 and 1) and the
        triangulated points, seed depth-filter candidates."""
        dev = self.device
        ids = (torch.zeros((), dtype=torch.int32, device=dev),
               torch.ones((), dtype=torch.int32, device=dev))
        return device_fsm.seed_map(m, self.cfg, pyr1, pyr2, boot, corners2,
                                   ids)

    def _seed_stage(self, st, pyr1, pyr2, boot, corners2):
        """Where the bootstrap succeeded (a ``device_if``): seed the map,
        the two-view local BA and the ground-plane alignment, written into
        the map. Returns ``(success, pose, T)``: the second camera's pose
        in the new world and the world transform (identity where it
        failed)."""
        s = self.cfg.sdvl
        dev = self.device
        success = (boot.ok_flow & (boot.median_shift >= s.min_avg_shift)
                   & (boot.n_inliers >= s.min_init_corners))

        def seeded():
            m = self._seed_map(st.m, pyr1, pyr2, boot, corners2)
            m = self._local_ba(m, torch.ones((), dtype=torch.int32,
                                             device=dev), window=1)
            pose = m.kf_pose[1]
            T = se3.identity(device=dev)
            if s.align_ground_plane:
                # z=0-align the initial map
                m, T = mapper.transform_initial_map(m,
                                                    self._noise.boot.plane)
                pose = se3.compose(pose, se3.inverse(T))
            st.update(m=m)
            return pose.clone(), T

        def failed():
            return se3.identity(device=dev), se3.identity(device=dev)

        pose, T = device_fsm.device_if(success, seeded, failed)
        return success, pose, T

    def _match_stage(self, st, pyr, pose):
        """The initial match set (the seeded points' observations in the
        second keyframe) and its size."""
        mr = self._match_initial(st.m, pyr, pose)
        return mr, torch.sum(mr.ok).to(torch.int32)

    def _track(self, st, pyr, gumbel, sweep: Optional[int] = None):
        """Predict from the motion model (``sweep`` None) or relocalize
        over ``sweep`` keyframes and take the winner as the reference, then
        track; the point-statistics fold where the driver writes its own
        map, counting nothing while relocalizing (a LOST stretch must not
        decay the map the relocalizer depends on). Returns the track
        result, the motion model the frame would give, and the row the host
        reads: ``(n_matches, n_attempts, tracked pose, predicted pose)``."""
        s = self.cfg.sdvl
        c = st.carry
        if sweep is None:
            pose_pred = se3.compose(se3.exp(c.xi_model), c.last_pose)
            ref = (c.last_pyr, c.last_idx, c.last_ok, c.last_pose)
        else:
            rl = relocalize.relocalize(st.m, self.intr, pyr, c.last_pose,
                                       max_kf=sweep)
            pose_pred = rl.pose
            ref = device_fsm.reloc_reference(st.m, rl.kf,
                                             c.last_idx.shape[0])
        tr = tracker.track_frame(
            st.m, self.intr, *ref, pyr, pose_pred,
            cell=s.cell_size, align_max_level=s.max_align_level,
            align_min_level=s.min_align_level,
            align_iters=s.max_img_align_its // 3,
            pose_iters=s.max_optim_pose_its,
            inlier_thresh_px=s.inlier_error_threshold,
            use_orb=s.use_orb,
            ransac_gumbel=gumbel,
            ransac_points=s.max_ransac_points,
            patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
            search_px=float(s.search_size), max_matches=s.max_matches,
            align_patch_half=s.align_patch_size // 2,
            orb_radius=s.orb_size // 2,
            affine_illum=s.use_affine_illum,
        )
        if self._async_mapper is None:
            # else the mapper thread owns map writes and replays the fold
            st.update(m=self._update_stats(st.m, tr, sweep is None))
        xi, _ = tracker.motion_model_update(c.xi_model, tr.pose, c.last_pose)
        row = torch.cat([tr.n_matches.float().reshape(1),
                         tr.n_attempts.float().reshape(1),
                         tr.pose, pose_pred])
        return tr, xi, row

    def _update_stats(self, m, tr, enabled):
        """The point-statistics fold; the async mapper replays it, so both
        drivers decay points identically."""
        return tracker.update_point_stats(m, tr,
                                          max_failed=self.cfg.sdvl.max_failed,
                                          enabled=enabled)

    def _update_map(self, m, cur_pyr, pose):
        s = self.cfg.sdvl
        return mapper.update_map(
            m, self.intr, cur_pyr, pose,
            n_samples=s.epipolar_samples,
            threshold_converged=s.threshold_converged,
            max_failed=s.max_failed, use_orb=s.use_orb,
            patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
            orb_radius=s.orb_size // 2,
            stale_kf_window=2 * s.max_search_keyframes,
            map_scale=s.map_scale, scale_min_dist=s.scale_min_dist,
            corner_gate=s.epipolar_corner_gate,
            corner_thresh=s.min_feature_score,
        )

    def _add_keyframe(self, m, pyr, pose, frame_id, match_idx, match_px,
                      match_ok, match_level, corners_xy, corners_level,
                      corners_valid):
        s = self.cfg.sdvl
        return mapper.add_keyframe(
            m, self.intr, pyr, pose, frame_id, match_idx, match_px,
            match_ok, match_level, corners_xy, corners_level, corners_valid,
            s.cell_size,
            n_search_kf=s.max_search_keyframes, max_reobs=s.max_reobs,
            scale_min_dist=s.scale_min_dist, map_scale=s.map_scale,
            use_orb=s.use_orb, epipolar_samples=s.epipolar_samples,
            patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
            orb_radius=s.orb_size // 2,
        )

    def _local_ba(self, m, center, window: int = 10, max_points: int = 512):
        return mapper.local_ba(m, self.intr, center, window=window,
                               max_points=max_points)

    def _prune(self, m):
        # redundant-keyframe pruning runs in _update_map (every frame);
        # here only the weak-point cleanup after BA
        return mapper.prune_weak_points(m)

    def _mapping(self, m, keyframe: bool, stats_on, tr, pyr, pose,
                 frame_id=None, corners=None):
        """The mapping work of a good frame on the map ``m``: the
        point-statistics fold where ``stats_on`` (a () bool tensor) is not
        None (the async mapper replays it; inline, tracking folded it),
        with ``keyframe`` the insertion, local BA and pruning, then the
        depth-filter update. Returns the new map."""
        if stats_on is not None:
            m = self._update_stats(m, tr, stats_on)
        if keyframe:
            m, slot = self._add_keyframe(
                m, pyr, pose, frame_id, tr.match_pt_idx, tr.match_px,
                tr.match_ok, tr.match_level,
                corners.xy, corners.level, corners.valid)
            m = self._local_ba(m, slot)
            m = self._prune(m)
        return self._update_map(m, pyr, pose)

    def _map_stage(self, st, *inputs, keyframe: bool):
        st.update(m=self._mapping(st.m, keyframe, None, *inputs))

    def _match_initial(self, m, pyr, pose):
        s = self.cfg.sdvl
        return matcher.match_map_points(
            m, self.intr, pyr, pose, cell=s.cell_size, use_orb=s.use_orb,
            half=s.patch_size // 2, lk_iters=s.max_align_its,
            reproj_px=float(s.search_size), max_matches=s.max_matches,
            orb_radius=s.orb_size // 2,
        )

    # ----------------------------------------------------------------- util
    def _upload(self, img: np.ndarray) -> torch.Tensor:
        """The cropped frame on the device as float32 (pinned and
        asynchronous on the card)."""
        img = np.asarray(img)[: self.crop_h, : self.crop_w]
        return self._uploads.upload(img).float()

    def get_pose(self) -> np.ndarray:
        """Current world->cam pose (7,)."""
        return self._last_pose_host.copy()

    # ------------------------------------------------------------ main loop
    def handle_frame(self, img: np.ndarray) -> dict:
        """Process one grayscale frame ((H, W), uint8 or float); returns a
        status dict. ``state`` is the state the frame was processed in."""
        s = self.cfg.sdvl
        if self._async_mapper is not None:
            self._async_mapper.publish()   # between frames: a whole map
        with self.tracer.span("preprocess"):
            img = self._upload(img)
            if self._have_matches:
                pyr, corners = self._stage("preprocess",
                                           self._preprocess_locked, img)
            else:
                pyr, corners, n_corners = self._stage("detect",
                                                      self._detect, img)
        info = {"frame_id": self.frame_id, "state": self.state.name,
                "n_matches": 0, "n_attempts": 0, "keyframe": False}

        if self.state == TrackingState.FIRST_FRAME:
            n_corners = int(n_corners)      # the frame's one read
            if n_corners >= s.min_init_corners:
                # copies: the stage's next replay overwrites its outputs
                self._first_fs = device_fsm._clone((pyr, corners))
                self.state = TrackingState.SECOND_FRAME
            info["n_corners"] = n_corners

        elif self.state == TrackingState.SECOND_FRAME:
            self._second_frame(pyr, corners, info)

        else:
            self._running(pyr, corners, info)

        self.last_pyr = pyr
        self.trajectory.append((self.frame_id, self._last_pose_host))
        self.frame_id += 1
        info["pose"] = self._last_pose_host.copy()
        return info

    def _second_frame(self, pyr, corners, info: dict):
        """The bootstrap, the seed map (where it succeeded, decided on the
        device) and the initial match set, as three stages, then the
        frame's one read: ``(median_shift, n_inliers, ok_flow)`` with the
        decision, the match count, the pose and the world transform."""
        s = self.cfg.sdvl
        pyr1, corners1 = self._first_fs
        boot = self._stage("bootstrap", self._bootstrap, pyr1, pyr,
                           corners1.xy, corners1.valid)
        success, pose, T = self._stage("seed", self._seed_stage, pyr1, pyr,
                                       boot, corners, writes_map=True)
        mr, n_ok = self._stage("match_initial", self._match_stage, pyr,
                               pose)
        host = torch.cat([torch.stack([
            boot.median_shift.float(), boot.n_inliers.float(),
            boot.ok_flow.float(), success.float(), n_ok.float()]),
            pose, T]).cpu()
        med_shift, n_inl, ok_flow, seeded, n_ok = host[:5].tolist()
        n_inl = int(n_inl)
        info.update(median_shift=med_shift, n_inliers=n_inl)
        if not ok_flow:
            # flow collapsed: restart from scratch
            self.state = TrackingState.FIRST_FRAME
            self._first_fs = None
            return
        if not seeded:
            return      # wait for more parallax (stay in SECOND_FRAME)
        self._set_pose(pose, host[5:12].numpy())
        if s.align_ground_plane:
            T_inv = se3.inverse(host[12:19])
            self.trajectory = [
                (fid, se3.compose(torch.from_numpy(p), T_inv).numpy())
                for fid, p in self.trajectory
            ]
        self.last_match_idx = mr.pt_idx
        self.last_match_ok = mr.ok
        self.kf_matches = max(int(n_ok), 1)
        self.state = TrackingState.RUNNING
        self.frames_since_kf = 0
        info["keyframe"] = True

    def _running(self, pyr, corners, info: dict):
        s = self.cfg.sdvl
        was_lost = self.state == TrackingState.LOST
        gumbel = self._noise.pose(self.frame_id, 1)[0]
        if gumbel is None:
            raise ValueError(
                f"frame {self.frame_id} tracks but no pose-RANSAC noise was "
                "provided for it")
        sweep = None
        if was_lost:
            # the escalation rule of the stream's step
            escalate = (
                s.reloc_escalate_after >= 0
                and s.max_keyframes > s.reloc_max_keyframes
                and self.lost_frames >= 3 + s.reloc_escalate_after
            )
            sweep = s.max_keyframes if escalate else s.reloc_max_keyframes
        with self.tracer.span("relocalize" if was_lost else "track"):
            tr, xi, row = self._stage(
                "track" if sweep is None else f"relocalize_{sweep}",
                functools.partial(self._track, sweep=sweep), pyr, gumbel,
                writes_map=self._async_mapper is None)
            # the one batched read: both counts and both candidate poses
            host = _host_read(row)
        n_matches, n_attempts = int(host[0]), int(host[1])
        info.update(n_matches=n_matches, n_attempts=n_attempts,
                    match_px=tr.match_px.clone(),
                    match_ok=tr.match_ok.clone(),
                    match_attempted=tr.match_attempted.clone())

        ratio = n_matches / max(n_attempts, 1)
        if n_matches < s.min_matches:
            self.quality = TrackingQuality.BAD
        elif ratio < 0.2:
            self.quality = TrackingQuality.INSUFFICIENT
        else:
            self.quality = TrackingQuality.GOOD

        if self.quality == TrackingQuality.BAD:
            self.lost_frames += 1
            if self.lost_frames >= 3:
                self.state = TrackingState.LOST
            # pose not trusted; keep the motion-model prediction
            self._set_pose(row[9:16], host[9:16])
            return

        self.lost_frames = 0
        # recovering from LOST the previous pose was a relocalization
        # guess, the velocity estimate is meaningless: coast from rest
        self.xi_model = torch.zeros_like(xi) if was_lost else xi
        self._set_pose(tr.pose, host[2:9])
        self.last_match_idx = tr.match_pt_idx
        self.last_match_ok = tr.match_ok
        self.state = TrackingState.RUNNING

        self.frames_since_kf += 1
        # the stream's keyframe rule on host numbers (float64, as the
        # reference's host driver computes it)
        is_kf = mapper.need_keyframe(n_matches, self.kf_matches,
                                     self.frames_since_kf,
                                     min_keyframe_its=s.min_keyframe_its)
        if is_kf:
            self.kf_matches = max(n_matches, 1)
            self.frames_since_kf = 0
            info["keyframe"] = True
        else:
            # high-water mark of the match count since the last keyframe
            self.kf_matches = max(self.kf_matches, n_matches)

        frame_id = torch.full((), self.frame_id, dtype=torch.int32,
                              device=self.device)
        if self._async_mapper is not None:
            # hand the mapping work to the mapper thread
            if is_kf:
                self._async_mapper.submit_keyframe(
                    tr, pyr, tr.pose, frame_id, corners,
                    stats_enabled=not was_lost)
            else:
                self._async_mapper.submit_frame(
                    tr, pyr, self.last_pose, stats_enabled=not was_lost)
        elif is_kf:
            with self.tracer.span("keyframe"):
                self._stage("keyframe", functools.partial(
                    self._map_stage, keyframe=True), tr, pyr, tr.pose,
                    frame_id, corners, writes_map=True)
        else:
            with self.tracer.span("map_update"):
                self._stage("map_update", functools.partial(
                    self._map_stage, keyframe=False), tr, pyr, tr.pose,
                    writes_map=True)
