"""Top-level SLAM orchestrator: the host-side state machine over the port's
per-stage functions.

Counterpart of ``sdvl_tpu/pipeline/sdvl.py``. The per-pixel and per-point
work runs in the port's modules (the same functions the stream's step
calls); the state machine itself -- a dozen scalar decisions per frame --
runs in Python on scalars read from the device. Where the reference jits a
closure, the port calls the function: there is nothing to compile.

Host reads per frame: FIRST frames read the corner count; SECOND frames read
the bootstrap's ``(median_shift, n_inliers, ok_flow)`` in one copy (and on
success the initial match count with the new pose and world transform);
RUNNING and LOST frames read ``(n_matches, n_attempts)`` together with the
tracked and the predicted pose in one copy, which gives the quality
decision and the trajectory's host copy at once.

Random draws come from a :class:`~sdvl_tpu_torch.pipeline.stream.
NoiseSource`, as in the stream: the bootstrap's homography and ground-plane
noise (the same on every attempt) and the pose-RANSAC noise of frame
``frame_id``, drawn when that frame tracks. Each draw is keyed by what it is
for, so with the same seed both drivers and a resumed session see the same
numbers. A provider (``Draws``) feeds both drivers the numbers the JAX
package draws from ``fold_in(key, 0 | 1 | frame_id)``.

Mapping runs inline by default; :class:`~sdvl_tpu_torch.pipeline.runtime.
AsyncMapper` moves it to a thread of its own.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .. import require_device
from ..core import se3
from ..state.map_state import MapState, empty_map
from ..utils.trace import Tracer
from . import (bootstrap, device_fsm, mapper, matcher, relocalize, tracker)
from .config import Config, intrinsics
from .stream import NoiseSource


class TrackingState(enum.Enum):
    FIRST_FRAME = 0
    SECOND_FRAME = 1
    RUNNING = 2
    LOST = 3


class TrackingQuality(enum.Enum):
    BAD = 0
    INSUFFICIENT = 1
    GOOD = 2


class SDVL:
    """The system facade: :meth:`handle_frame` per image, :meth:`get_pose`,
    the ``trajectory`` as ``(frame_id, pose (7,))`` host copies, the map
    ``m``. Runs on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: Config, seed: int = 0, device="cuda",
                 tracer=None, gumbel_provider=None):
        self.device = require_device(device)
        self.tracer = (tracer if tracer is not None
                       else Tracer(enabled=False, device=self.device))
        self.cfg = config
        s = config.sdvl
        self.intr = intrinsics(config)
        self.levels = s.pyramid_levels
        self.crop_h, self.crop_w = device_fsm.cropped_shape(config)

        self.m: MapState = empty_map(
            n_kf=s.max_keyframes, n_pts=s.max_points,
            n_cand=s.max_candidates, img_shape=(self.crop_h, self.crop_w),
            levels=self.levels, device=self.device,
        )
        self._undistort_grid = device_fsm.undistort_grid(config, self.device)
        self._pre = device_fsm.make_preprocess(
            config, self._undistort_grid is not None)
        self._noise = NoiseSource(config, seed, self.device, gumbel_provider)

        self.state = TrackingState.FIRST_FRAME
        self.quality = TrackingQuality.GOOD
        self.frame_id = 0
        self.frames_since_kf = 0
        self.kf_matches = 1
        self.lost_frames = 0
        # the reference's PRNG key (uint32 words [seed >> 32, seed]), kept
        # for its snapshots; the draws themselves come from the NoiseSource
        self.key = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)

        # device-side inter-frame state
        self.last_pyr = None
        self.last_pose = se3.identity(device=self.device)
        self._last_pose_host = se3.identity().numpy()
        self.xi_model = torch.zeros(6, dtype=torch.float32,
                                    device=self.device)
        self.last_match_idx = None
        self.last_match_ok = None
        self._first_fs = None
        self._async_mapper = None  # set by runtime.AsyncMapper
        self.trajectory = []       # (frame_id, pose (7,)) host copies

    # ------------------------------------------------------------ stages
    def _preprocess(self, img, lock_xy=None, lock_valid=None):
        return self._pre(img, self._undistort_grid, lock_xy, lock_valid)

    def _preprocess_locked(self, img, m: MapState, idx, ok, pose):
        """Steady-state variant: suppress detector cells already holding
        tracked map points, projected at the previous frame's pose."""
        lock_xy, lock_valid = device_fsm.lock_points(self.intr, m, pose,
                                                     idx, ok)
        return self._preprocess(img, lock_xy, lock_valid)

    def _bootstrap(self, pyr1, pyr2, corners_xy, corners_valid):
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

    def _track(self, m, last_pyr, last_idx, last_ok, pose_last, cur_pyr,
               pose_pred, gumbel, stats_enabled: bool):
        s = self.cfg.sdvl
        tr = tracker.track_frame(
            m, self.intr, last_pyr, last_idx, last_ok, pose_last,
            cur_pyr, pose_pred,
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
        # no failure counting while relocalizing: a LOST stretch must not
        # decay the map the relocalizer depends on
        m = self._update_stats(m, tr, stats_enabled)
        return m, tr

    def _update_stats(self, m, tr, enabled: bool):
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

    def _match_initial(self, m, pyr, pose):
        s = self.cfg.sdvl
        return matcher.match_map_points(
            m, self.intr, pyr, pose, cell=s.cell_size, use_orb=s.use_orb,
            half=s.patch_size // 2, lk_iters=s.max_align_its,
            reproj_px=float(s.search_size), max_matches=s.max_matches,
            orb_radius=s.orb_size // 2,
        )

    def _set_pose(self, pose: torch.Tensor, host: np.ndarray):
        """The pose of the newest frame, on the device and its host copy."""
        self.last_pose = pose
        self._last_pose_host = host

    # ----------------------------------------------------------------- util
    def _crop(self, img: np.ndarray) -> torch.Tensor:
        img = np.ascontiguousarray(np.asarray(img)[: self.crop_h,
                                                    : self.crop_w])
        return torch.from_numpy(img).to(self.device)

    def get_pose(self) -> np.ndarray:
        """Current world->cam pose (7,)."""
        return self._last_pose_host.copy()

    # ------------------------------------------------------------ main loop
    def handle_frame(self, img: np.ndarray) -> dict:
        """Process one grayscale frame ((H, W), uint8 or float); returns a
        status dict. ``state`` is the state the frame was processed in."""
        s = self.cfg.sdvl
        with self.tracer.span("preprocess"):
            if self.last_match_idx is not None:
                m_now = self.m   # ONE read: the async mapper publishes by a
                                 # single attribute store; two reads could
                                 # mix fields of different map versions
                pyr, corners = self._preprocess_locked(
                    self._crop(img), m_now, self.last_match_idx,
                    self.last_match_ok, self.last_pose)
            else:
                pyr, corners = self._preprocess(self._crop(img))
        info = {"frame_id": self.frame_id, "state": self.state.name,
                "n_matches": 0, "n_attempts": 0, "keyframe": False}

        if self.state == TrackingState.FIRST_FRAME:
            n_corners = int(corners.valid.sum())
            if n_corners >= s.min_init_corners:
                self._first_fs = (pyr, corners)
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
        s = self.cfg.sdvl
        pyr1, corners1 = self._first_fs
        boot = self._bootstrap(pyr1, pyr, corners1.xy, corners1.valid)
        med_shift, n_inl, ok_flow = torch.stack([
            boot.median_shift.float(), boot.n_inliers.float(),
            boot.ok_flow.float()]).tolist()
        n_inl = int(n_inl)
        info.update(median_shift=med_shift, n_inliers=n_inl)
        if not ok_flow:
            # flow collapsed: restart from scratch
            self.state = TrackingState.FIRST_FRAME
            self._first_fs = None
            return
        if med_shift < s.min_avg_shift or n_inl < s.min_init_corners:
            return      # wait for more parallax (stay in SECOND_FRAME)
        m = self._seed_map(self.m, pyr1, pyr, boot, corners)
        m = self._local_ba(m, torch.ones((), dtype=torch.int32,
                                         device=self.device), window=1)
        pose = m.kf_pose[1]
        T = se3.identity(device=self.device)
        if s.align_ground_plane:
            # z=0-align the initial map
            m, T = mapper.transform_initial_map(m, self._noise.boot.plane)
            pose = se3.compose(pose, se3.inverse(T))
        self.m = m
        # initial match set = the seeded points' observations in KF1
        mr = self._match_initial(m, pyr, pose)
        host = torch.cat([torch.sum(mr.ok).float().reshape(1), pose,
                          T]).cpu()
        self._set_pose(pose, host[1:8].numpy())
        if s.align_ground_plane:
            T_inv = se3.inverse(host[8:15])
            self.trajectory = [
                (fid, se3.compose(torch.from_numpy(p), T_inv).numpy())
                for fid, p in self.trajectory
            ]
        self.last_match_idx = mr.pt_idx
        self.last_match_ok = mr.ok
        self.kf_matches = max(int(host[0]), 1)
        self.state = TrackingState.RUNNING
        self.frames_since_kf = 0
        info["keyframe"] = True

    def _running(self, pyr, corners, info: dict):
        s = self.cfg.sdvl
        was_lost = self.state == TrackingState.LOST
        if was_lost:
            with self.tracer.span("relocalize"):
                # the escalation rule of the stream's step
                escalate = (
                    s.reloc_escalate_after >= 0
                    and s.max_keyframes > s.reloc_max_keyframes
                    and self.lost_frames >= 3 + s.reloc_escalate_after
                )
                rl = relocalize.relocalize(
                    self.m, self.intr, pyr, self.last_pose,
                    max_kf=s.max_keyframes if escalate
                    else s.reloc_max_keyframes)
                pose_pred = rl.pose
                ref_pyr, ref_idx, ref_ok, pose_ref = \
                    device_fsm.reloc_reference(
                        self.m, rl.kf, self.last_match_idx.shape[0])
        else:
            pose_pred = se3.compose(se3.exp(self.xi_model), self.last_pose)
            ref_pyr, ref_idx, ref_ok, pose_ref = (
                self.last_pyr, self.last_match_idx, self.last_match_ok,
                self.last_pose)

        with self.tracer.span("track"):
            gumbel = self._noise.pose(self.frame_id, 1)[0]
            if gumbel is None:
                raise ValueError(
                    f"frame {self.frame_id} tracks but no pose-RANSAC noise "
                    "was provided for it")
            m_tracked, tr = self._track(
                self.m, ref_pyr, ref_idx, ref_ok, pose_ref, pyr, pose_pred,
                gumbel, not was_lost)
            if self._async_mapper is None:
                self.m = m_tracked
            # else: the mapper thread owns map writes and replays the stat
            # fold itself; m_tracked is discarded (runtime.py)
            # one batched read: both counts and both candidate poses
            host = torch.cat([tr.n_matches.float().reshape(1),
                              tr.n_attempts.float().reshape(1),
                              tr.pose, pose_pred]).cpu().numpy()
        n_matches, n_attempts = int(host[0]), int(host[1])
        info.update(n_matches=n_matches, n_attempts=n_attempts,
                    match_px=tr.match_px, match_ok=tr.match_ok,
                    match_attempted=tr.match_attempted)

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
            self._set_pose(pose_pred, host[9:16])
            return

        self.lost_frames = 0
        if was_lost:
            # recovering: the previous pose was a relocalization guess, the
            # velocity estimate is meaningless -- coast from rest
            self.xi_model = torch.zeros_like(self.xi_model)
        else:
            self.xi_model, _ = tracker.motion_model_update(
                self.xi_model, tr.pose, self.last_pose)
        self._set_pose(tr.pose, host[2:9])
        self.state = TrackingState.RUNNING

        self.frames_since_kf += 1
        # the stream's keyframe rule on host numbers (float64, as the
        # reference's host driver computes it)
        is_kf = bool(mapper.need_keyframe(
            torch.tensor(float(n_matches), dtype=torch.float64),
            torch.tensor(self.kf_matches),
            torch.tensor(self.frames_since_kf),
            min_keyframe_its=s.min_keyframe_its))
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
        else:
            if is_kf:
                with self.tracer.span("keyframe"):
                    self.m, slot = self._add_keyframe(
                        self.m, pyr, tr.pose, frame_id,
                        tr.match_pt_idx, tr.match_px, tr.match_ok,
                        tr.match_level,
                        corners.xy, corners.level, corners.valid)
                    with self.tracer.span("ba"):
                        self.m = self._local_ba(self.m, slot)
                    self.m = self._prune(self.m)
            with self.tracer.span("map_update"):
                self.m = self._update_map(self.m, pyr, self.last_pose)
        self.last_match_idx = tr.match_pt_idx
        self.last_match_ok = tr.match_ok
