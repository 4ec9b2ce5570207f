"""The per-frame state machine of the stream: full SLAM mode and serving.

Counterpart of ``sdvl_tpu/pipeline/device_fsm.py``. States: 0 FIRST_FRAME,
1 SECOND_FRAME, 2 RUNNING, 3 LOST. In full SLAM mode a stream starts in
FIRST, keeps a first frame with enough corners, bootstraps from two views in
SECOND (homography, triangulation, two-view BA, ground-plane alignment),
then tracks and maintains the map in RUNNING (point statistics, keyframe
insertion with local BA and pruning, the depth-filter update). With
``localize_only`` a stream starts LOST against a loaded, frozen map and only
tracks; no bootstrap and no mapping stage run.

Branches. The reference compiles every decision into one device program
(``lax.switch``/``lax.cond``). Eager torch has no such thing, and the
branches not taken must not run, so the step reads small scalars back to
the host and takes Python branches:

* every frame: ``(state, lost_frames)``, one 2-element read;
* SECOND frames: ``success`` of the bootstrap (seed the map or not);
* RUNNING/LOST frames in full SLAM mode: ``(good, is_kf)`` after tracking
  (run the keyframe stage, and the map update, only where they are kept).

FIRST's decisions, and the good/bad path of serving, are ``where`` selects.

Random draws come in as arguments: the pose RANSAC's Gumbel noise per
tracking frame, and the bootstrap's two (the homography and ground-plane
RANSACs, the same on every attempt, as the reference derives them from a
key that does not change).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import const
from ..core import camera as cam
from ..core import se3
from ..ops import fast as fast_ops
from ..ops import interp, orb, pyramid
from ..state.map_state import (MapState, alloc_slots, empty_map, scatter,
                               set_row, store_pyramid)
from . import bootstrap, depth_filter, mapper, matcher, relocalize, tracker
from .config import Config, intrinsics

STATE_FIRST = 0
STATE_SECOND = 1
STATE_RUNNING = 2
STATE_LOST = 3

QUALITY_BAD = 0
QUALITY_INSUFFICIENT = 1
QUALITY_GOOD = 2


class SlamCarry(NamedTuple):
    """Inter-frame device state."""

    state: torch.Tensor        # () int32, STATE_*
    key: torch.Tensor          # (2,) int64: the reference's uint32 PRNG key
                               #   (its draws derive from it); the port
                               #   takes its draws as inputs
    frame_id: torch.Tensor     # () int32
    pose: torch.Tensor         # (7,) last world->cam pose
    xi_model: torch.Tensor     # (6,) constant-velocity model
    frames_since_kf: torch.Tensor  # () int32
    kf_matches: torch.Tensor   # () int32 matches high-water mark
    lost_frames: torch.Tensor  # () int32 consecutive bad frames
    # first-frame snapshot for the two-view bootstrap
    pyr1: Tuple[torch.Tensor, ...]
    c1_xy: torch.Tensor        # (N, 2)
    c1_valid: torch.Tensor     # (N,)
    # previous frame (alignment reference)
    last_pyr: Tuple[torch.Tensor, ...]
    last_idx: torch.Tensor     # (S,) int64 last frame's matched point slots
    last_ok: torch.Tensor      # (S,)


class FrameInfo(NamedTuple):
    """Per-frame outputs (device tensors until the host finalizes)."""

    pose: torch.Tensor         # (7,) world->cam after this frame
    world_tf: torch.Tensor     # (7,) world rebasing applied THIS frame
    state: torch.Tensor        # () int32 state AFTER the frame
    quality: torch.Tensor      # () int32 QUALITY_*
    n_matches: torch.Tensor    # () int32
    n_attempts: torch.Tensor   # () int32
    is_keyframe: torch.Tensor  # () bool
    n_corners: torch.Tensor    # () int32
    median_shift: torch.Tensor # () f32 (bootstrap diagnostics)


def cropped_shape(cfg: Config) -> Tuple[int, int]:
    """Frame size cropped to a multiple of ``2**(levels-1)``."""
    div = 1 << (cfg.sdvl.pyramid_levels - 1)
    return ((cfg.camera.height // div) * div,
            (cfg.camera.width // div) * div)


def lane_counts(cfg: Config) -> Tuple[int, int]:
    """(corner capacity, match-lane capacity) for a config: the detector's
    output length (cells over the FAST levels, capped by ``num_features``)
    and the per-cell winners capped by ``max_matches``."""
    s = cfg.sdvl
    ch, cw = cropped_shape(cfg)
    cells = sum(((ch >> l) // s.cell_size) * ((cw >> l) // s.cell_size)
                for l in range(s.max_fast_levels))
    n_corners = min(cells, s.num_features)
    n_lanes = min((cw // s.cell_size) * (ch // s.cell_size), s.max_matches)
    return n_corners, n_lanes


def undistort_grid(cfg: Config, device):
    """The cropped undistort map of a config with lens distortion, else
    None."""
    if not any(abs(d) > 1e-12 for d in cfg.camera.dist):
        return None
    ch, cw = cropped_shape(cfg)
    grid = cam.undistort_map(intrinsics(cfg), device=device)
    return grid[:ch, :cw].contiguous()


def init_state(cfg: Config, seed: int = 0, device="cuda"):
    """Fresh (MapState, SlamCarry) sized by the config capacities."""
    s = cfg.sdvl
    m = empty_map(n_kf=s.max_keyframes, n_pts=s.max_points,
                  n_cand=s.max_candidates, img_shape=cropped_shape(cfg),
                  levels=s.pyramid_levels, device=device)
    return m, init_carry(cfg, seed, device=device)


def init_carry(cfg: Config, seed: int = 0, device="cuda") -> SlamCarry:
    """Fresh per-stream SlamCarry (no MapState allocated)."""
    s = cfg.sdvl
    ch, cw = cropped_shape(cfg)
    n_corners, n_lanes = lane_counts(cfg)

    def fresh_pyr():
        return tuple(
            torch.zeros((ch >> l, cw >> l), dtype=torch.float32,
                        device=device)
            for l in range(s.pyramid_levels)
        )

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return SlamCarry(
        state=scalar(STATE_FIRST),
        key=torch.tensor([0, seed], dtype=torch.int64, device=device),
        frame_id=scalar(0),
        pose=se3.identity(device=device),
        xi_model=torch.zeros(6, dtype=torch.float32, device=device),
        frames_since_kf=scalar(0),
        kf_matches=scalar(1),
        lost_frames=scalar(0),
        pyr1=fresh_pyr(),
        c1_xy=torch.zeros((n_corners, 2), dtype=torch.float32, device=device),
        c1_valid=torch.zeros(n_corners, dtype=torch.bool, device=device),
        last_pyr=fresh_pyr(),
        last_idx=torch.zeros(n_lanes, dtype=torch.int64, device=device),
        last_ok=torch.zeros(n_lanes, dtype=torch.bool, device=device),
    )


class BootNoise(NamedTuple):
    """The bootstrap's Gumbel noise, drawn once per stream."""

    homography: torch.Tensor   # (n_hyp, N corners) homography RANSAC
    plane: torch.Tensor        # (iters, P points) ground-plane RANSAC


def make_preprocess(cfg: Config, undistort: bool):
    """``preprocess(img, grid, lock_xy, lock_valid) -> (pyr, corners)``:
    undistort remap (where ``undistort``), pyramid, detection with cell
    locking."""
    s = cfg.sdvl

    def preprocess(img, grid, lock_xy=None, lock_valid=None):
        img = img.float()
        if undistort:
            img = interp.remap(img, grid)
        pyr = tuple(pyramid.build_pyramid(img, s.pyramid_levels))
        corners = fast_ops.detect_pyramid(
            pyr, levels=s.max_fast_levels, cell=s.cell_size,
            fast_threshold=s.fast_threshold,
            st_threshold=s.min_feature_score,
            max_features=s.num_features,
            lock_xy=lock_xy, lock_valid=lock_valid,
            border="pallas" if s.use_pallas_detect else "plain",
        )
        return pyr, corners

    return preprocess


def lock_points(intr, m: MapState, pose, last_idx, last_ok):
    """Steady-state cell locking: the previous frame's tracked map points
    projected at its pose, ``(lock_xy, lock_valid)``; detector cells that
    hold one are suppressed. A stale match index is clamped, as the
    reference's gather does."""
    P = m.pt_valid.shape[0]
    last_idx = last_idx.clamp(0, P - 1)
    pts_cam = se3.transform(pose, m.pt_pos[last_idx])
    lock_xy = cam.project(intr, pts_cam)
    lock_valid = (last_ok & m.pt_valid[last_idx] & (pts_cam[:, 2] > 0.0)
                  & cam.in_bounds(intr, lock_xy, margin=0))
    return lock_xy, lock_valid


def reloc_reference(m: MapState, kf, n_ref: int):
    """Tracking reference of a relocalized frame: keyframe ``kf``'s pyramid
    (float), its ``n_ref`` first observed points in slot order (stable) with
    their mask, and its pose."""
    ref_pyr = tuple(interp.take_row(p, kf).float() for p in m.kf_pyr)
    obs = interp.take_row(m.obs_mask, kf) & m.pt_valid
    order = torch.sort((~obs).to(torch.uint8), stable=True)[1][:n_ref]
    return ref_pyr, order, obs[order], interp.take_row(m.kf_pose, kf)


def seed_map(m: MapState, cfg: Config, pyr1, pyr2, boot, corners2,
             kf_frame_ids) -> MapState:
    """Write the two bootstrap keyframes (slots 0 and 1, frame ids
    ``kf_frame_ids``: a pair of () int32 tensors), the triangulated inliers
    as map points, and depth-filter seeds from the second frame's
    corners."""
    s = cfg.sdvl
    intr = intrinsics(cfg)
    dev = boot.pose2.device
    zero, one = const(0, torch.int32, dev), const(1, torch.int32, dev)
    kf_pyr = tuple(
        set_row(set_row(lvl, zero, i1), one, i2)
        for lvl, i1, i2 in zip(m.kf_pyr, store_pyramid(pyr1),
                               store_pyramid(pyr2)))
    kf_pose = set_row(m.kf_pose, zero, se3.identity(device=dev))
    m = m._replace(
        kf_pose=set_row(kf_pose, one, boot.pose2),
        kf_valid=set_row(set_row(m.kf_valid, zero, True), one, True),
        kf_frame_id=set_row(set_row(m.kf_frame_id, zero, kf_frame_ids[0]),
                            one, kf_frame_ids[1]),
        kf_pyr=kf_pyr,
        n_keyframes=const(2, torch.int32, dev),
    )
    slots, _ok = alloc_slots(~m.pt_valid, boot.inlier)
    desc1 = orb.descriptors(pyr1[0], boot.px1, radius=s.orb_size // 2)
    m = m._replace(
        pt_pos=scatter(m.pt_pos, slots, boot.pts_w),
        pt_desc=scatter(m.pt_desc, slots, desc1),
        pt_valid=scatter(m.pt_valid, slots, True),
        pt_anchor_kf=scatter(m.pt_anchor_kf, slots, 0),
        pt_found=scatter(m.pt_found, slots, 2),
        pt_fail=scatter(m.pt_fail, slots, 0),
        obs_mask=scatter(scatter(m.obs_mask, (zero, slots), True),
                         (one, slots), True),
        obs_px=scatter(scatter(m.obs_px, (zero, slots), boot.px1),
                       (one, slots), boot.px2),
    )
    depth_med = torch.full((), s.map_scale, dtype=torch.float32, device=dev)
    m, _ = depth_filter.seed_candidates(
        m, intr, pyr2, (corners2.xy, corners2.level, corners2.valid), one,
        depth_med, s.cell_size, orb_radius=s.orb_size // 2)
    return m


def make_step(cfg: Config, undistort: bool):
    """Build ``step(m, carry, img, grid, gumbel, boot) ->
    (m, carry, FrameInfo, Corners)``.

    ``img`` is the raw (cropped) frame on the device, any integer/float
    dtype (uint8 recommended). ``grid`` is the undistort map (ignored when
    ``undistort`` is False). ``gumbel`` is the (n_hyp, S) Gumbel noise of
    this frame's pose RANSAC, or None where the caller has none (a frame
    that tracks then raises). ``boot`` is the :class:`BootNoise` of the
    stream (unused while serving). The frame's detected corners are
    returned beside the FrameInfo.
    """
    s = cfg.sdvl
    intr = intrinsics(cfg)
    levels = s.pyramid_levels
    escalates = (s.reloc_escalate_after >= 0
                 and s.max_keyframes > s.reloc_max_keyframes)
    orb_radius = s.orb_size // 2

    preprocess = make_preprocess(cfg, undistort)

    def _info(carry, **kw):
        dev = carry.pose.device
        base = FrameInfo(
            pose=carry.pose,
            world_tf=se3.identity(device=dev),
            state=carry.state,
            quality=const(QUALITY_GOOD, torch.int32, dev),
            n_matches=const(0, torch.int32, dev),
            n_attempts=const(0, torch.int32, dev),
            is_keyframe=const(False, torch.bool, dev),
            n_corners=const(0, torch.int32, dev),
            median_shift=const(0.0, torch.float32, dev),
        )
        return base._replace(**kw)

    def i32(v, dev):
        return const(v, torch.int32, dev)

    # ------------------------------------------------------------ FIRST
    def first_frame(m, carry, pyr, corners):
        """Keep the frame if it has enough corners, else try again next
        frame (where selects: nothing is read back)."""
        dev = carry.pose.device
        n = torch.sum(corners.valid).to(torch.int32)
        ok = n >= s.min_init_corners
        carry = carry._replace(
            state=torch.where(ok, i32(STATE_SECOND, dev),
                              i32(STATE_FIRST, dev)),
            pyr1=tuple(torch.where(ok, a, b)
                       for a, b in zip(pyr, carry.pyr1)),
            c1_xy=torch.where(ok, corners.xy, carry.c1_xy),
            c1_valid=torch.where(ok, corners.valid, carry.c1_valid),
        )
        return m, carry, _info(carry, n_corners=n)

    # ------------------------------------------------------------ SECOND
    def bootstrap_map(m, carry, pyr, corners, boot, noise: BootNoise):
        """Seed the map from the two views, two-view BA, ground-plane
        alignment, then match the map into the frame to start tracking."""
        dev = carry.pose.device
        m = seed_map(m, cfg, carry.pyr1, pyr, boot, corners,
                     (carry.frame_id - 1, carry.frame_id))
        one = i32(1, dev)
        # two-view BA over the seed map
        m = mapper.local_ba(m, intr, one, window=1,
                            max_points=min(s.max_points, 512))
        pose = m.kf_pose[1]
        T = se3.identity(device=dev)
        if s.align_ground_plane:
            m, T = mapper.transform_initial_map(m, noise.plane)
            pose = se3.compose(pose, se3.inverse(T))
        mr = matcher.match_map_points(m, intr, pyr, pose, cell=s.cell_size,
                                      use_orb=s.use_orb,
                                      half=s.patch_size // 2,
                                      lk_iters=s.max_align_its,
                                      reproj_px=float(s.search_size),
                                      max_matches=s.max_matches,
                                      orb_radius=orb_radius)
        n_match = torch.sum(mr.ok).clamp_min(1).to(torch.int32)
        carry = carry._replace(
            state=i32(STATE_RUNNING, dev),
            pose=pose,
            last_idx=mr.pt_idx,
            last_ok=mr.ok,
            kf_matches=n_match,
            frames_since_kf=i32(0, dev),
            xi_model=torch.zeros(6, dtype=torch.float32, device=dev),
        )
        return m, carry, T

    def second_frame(m, carry, pyr, corners, noise: BootNoise):
        """Flow + homography: restart on flow collapse, wait on low
        parallax, seed the map on success (one host read: ``success``)."""
        dev = carry.pose.device
        boot = bootstrap.init_two_view(
            intr, carry.pyr1, pyr, carry.c1_xy, carry.c1_valid,
            noise.homography, map_scale=s.map_scale,
            thresh_px=s.inlier_error_threshold,
            min_corners=s.min_init_corners,
        )
        success = (boot.ok_flow & (boot.median_shift >= s.min_avg_shift)
                   & (boot.n_inliers >= s.min_init_corners))
        if bool(success):
            m, carry, T = bootstrap_map(m, carry, pyr, corners, boot,
                                        noise)
        else:
            carry = carry._replace(state=torch.where(
                boot.ok_flow, i32(STATE_SECOND, dev), i32(STATE_FIRST, dev)))
            T = se3.identity(device=dev)
        info = _info(carry, world_tf=T, is_keyframe=success,
                     n_matches=boot.n_inliers,
                     median_shift=boot.median_shift)
        return m, carry, info

    # ----------------------------------------------------------- RUNNING
    def do_reloc(m, carry, pyr, lost_frames: int):
        """Relocalize: the alignment reference becomes the best-matching
        KEYFRAME (its pyramid, pose and observed points), not the previous
        -- possibly garbage -- frame. After ``reloc_escalate_after`` failed
        LOST frames (LOST begins at lost_frames == 3) every keyframe is
        tried instead of the nearest ``reloc_max_keyframes``."""
        S = carry.last_idx.shape[0]
        lvl = min(4, levels - 1)
        sweep_all = escalates and lost_frames >= 3 + s.reloc_escalate_after
        rl = relocalize.relocalize(
            m, intr, pyr, carry.pose, level=lvl,
            max_kf=s.max_keyframes if sweep_all else s.reloc_max_keyframes)
        return reloc_reference(m, rl.kf, S) + (rl.pose,)

    def do_predict(carry):
        pred = se3.compose(se3.exp(carry.xi_model), carry.pose)
        return (carry.last_pyr, carry.last_idx, carry.last_ok,
                carry.pose, pred)

    def with_kf(m, carry, pyr, corners, tr):
        """The keyframe stage: insert, local BA around the new keyframe,
        drop points whose support collapsed."""
        m, slot = mapper.add_keyframe(
            m, intr, pyr, tr.pose, carry.frame_id,
            tr.match_pt_idx, tr.match_px, tr.match_ok, tr.match_level,
            corners.xy, corners.level, corners.valid, s.cell_size,
            n_search_kf=s.max_search_keyframes,
            max_reobs=s.max_reobs,
            scale_min_dist=s.scale_min_dist, map_scale=s.map_scale,
            use_orb=s.use_orb, epipolar_samples=s.epipolar_samples,
            patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
            orb_radius=orb_radius,
            corner_gate=s.epipolar_corner_gate,
            corner_thresh=s.min_feature_score,
        )
        m = mapper.local_ba(m, intr, slot,
                            window=min(10, s.max_keyframes - 1),
                            max_points=min(s.max_points, 512))
        # redundant-keyframe pruning runs in update_map, every frame
        return mapper.prune_weak_points(m)

    def running(m, carry, pyr, corners, is_lost: bool, lost_frames: int,
                gumbel):
        """One steady-state tracking step (RUNNING or LOST), then, in full
        SLAM mode on a good frame, the mapping stage."""
        dev = carry.pose.device
        if gumbel is None:
            raise ValueError(
                f"frame {int(carry.frame_id)} tracks but no pose-RANSAC "
                "noise was provided for it")
        if is_lost:
            ref = do_reloc(m, carry, pyr, lost_frames)
        else:
            ref = do_predict(carry)
        ref_pyr, ref_idx, ref_ok, pose_ref, pose_pred = ref

        tr = tracker.track_frame(
            m, intr, ref_pyr, ref_idx, ref_ok,
            pose_ref, pyr, pose_pred,
            cell=s.cell_size, align_max_level=s.max_align_level,
            align_min_level=s.min_align_level,
            align_iters=max(s.max_img_align_its // 3, 1),
            pose_iters=s.max_optim_pose_its,
            inlier_thresh_px=s.inlier_error_threshold,
            use_orb=s.use_orb,
            ransac_gumbel=gumbel,
            ransac_points=s.max_ransac_points,
            patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
            search_px=float(s.search_size), max_matches=s.max_matches,
            align_patch_half=s.align_patch_size // 2,
            orb_radius=orb_radius,
            affine_illum=s.use_affine_illum,
        )
        if not s.localize_only:
            # a frozen map counts nothing, and NO frame counts while
            # relocalizing (else a LOST stretch deletes the map)
            m = tracker.update_point_stats(m, tr, max_failed=s.max_failed,
                                           enabled=not is_lost)

        ratio = tr.n_matches / tr.n_attempts.clamp_min(1)
        quality = torch.where(
            tr.n_matches < s.min_matches, i32(QUALITY_BAD, dev),
            torch.where(ratio < 0.2, i32(QUALITY_INSUFFICIENT, dev),
                        i32(QUALITY_GOOD, dev)),
        )
        good = quality != QUALITY_BAD

        # good path: accept the pose, refresh the motion model and the match
        # set. Recovering from LOST the previous pose was a relocalization
        # guess, so the velocity estimate is meaningless: coast from rest.
        xi_model, _ = tracker.motion_model_update(
            carry.xi_model, tr.pose, carry.pose)
        if is_lost:
            xi_model = torch.zeros_like(xi_model)
        frames_since_kf = carry.frames_since_kf + 1
        if s.localize_only:
            is_kf = const(False, torch.bool, dev)
        else:
            is_kf = mapper.need_keyframe(tr.n_matches, carry.kf_matches,
                                         frames_since_kf, s.min_keyframe_its)
            # the second host read of the frame: which stages to run
            good_h, is_kf_h = torch.stack([good, is_kf]).tolist()
            if good_h:
                if is_kf_h:
                    m = with_kf(m, carry, pyr, corners, tr)
                m = mapper.update_map(
                    m, intr, pyr, tr.pose, n_samples=s.epipolar_samples,
                    threshold_converged=s.threshold_converged,
                    max_failed=s.max_failed, use_orb=s.use_orb,
                    patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
                    orb_radius=orb_radius,
                    stale_kf_window=2 * s.max_search_keyframes,
                    map_scale=s.map_scale, scale_min_dist=s.scale_min_dist,
                    corner_gate=s.epipolar_corner_gate,
                    corner_thresh=s.min_feature_score,
                )
        # bad path: coast on the prediction, count the failure, go LOST at 3
        lost_bad = carry.lost_frames + 1
        state_bad = torch.where(lost_bad >= 3, i32(STATE_LOST, dev),
                                i32(STATE_RUNNING, dev))
        is_kf = good & is_kf

        carry = carry._replace(
            pose=torch.where(good, tr.pose, pose_pred),
            xi_model=torch.where(good, xi_model, carry.xi_model),
            lost_frames=torch.where(good, i32(0, dev), lost_bad),
            state=torch.where(good, i32(STATE_RUNNING, dev), state_bad),
            frames_since_kf=torch.where(
                good, torch.where(is_kf, i32(0, dev), frames_since_kf),
                carry.frames_since_kf),
            # HIGH-WATER mark of the match count since the last keyframe
            kf_matches=torch.where(
                is_kf, tr.n_matches.clamp_min(1),
                torch.where(good,
                            torch.maximum(carry.kf_matches, tr.n_matches),
                            carry.kf_matches)),
            last_idx=torch.where(good, tr.match_pt_idx, carry.last_idx),
            last_ok=torch.where(good, tr.match_ok, carry.last_ok),
        )
        info = _info(carry, quality=quality, n_matches=tr.n_matches,
                     n_attempts=tr.n_attempts, is_keyframe=is_kf)
        return m, carry, info

    # -------------------------------------------------------------- step
    def step(m: MapState, carry: SlamCarry, img, grid, gumbel,
             boot: BootNoise = None):
        # steady-state cell locking: suppress detector cells that already
        # hold tracked map points, projected at the previous frame's pose.
        # A stale match index is clamped, as the reference's gather does.
        # In FIRST/SECOND, last_ok is all-False: no lock.
        lock_xy, lock_valid = lock_points(intr, m, carry.pose,
                                          carry.last_idx, carry.last_ok)
        pyr, corners = preprocess(img, grid, lock_xy, lock_valid)

        # the first host read of the frame: which branch to take
        state, lost_frames = torch.stack(
            [carry.state, carry.lost_frames]).tolist()
        state = min(max(state, 0), 3)
        if not s.localize_only and state == STATE_FIRST:
            m, carry, info = first_frame(m, carry, pyr, corners)
        elif not s.localize_only and state == STATE_SECOND:
            m, carry, info = second_frame(m, carry, pyr, corners, boot)
        else:
            # serving starts LOST against a loaded map: all states track
            m, carry, info = running(m, carry, pyr, corners,
                                     state == STATE_LOST, lost_frames,
                                     gumbel)
        carry = carry._replace(last_pyr=pyr, frame_id=carry.frame_id + 1)
        return m, carry, info, corners

    return step


def make_chunk_step(cfg: Config, undistort: bool):
    """``chunk_step(m, carry, imgs (T,H,W), grid, gumbels, boot)``: a Python
    loop of :func:`make_step` over a stack of frames that is already on the
    device (one host->device copy per chunk). ``gumbels`` is a sequence of
    T per-frame pose-RANSAC noise tensors (or None). Returns the list of
    FrameInfo and the last frame's corners."""
    step = make_step(cfg, undistort)

    def chunk_step(m, carry, imgs, grid, gumbels, boot=None):
        infos, corners = [], None
        for img, g in zip(imgs, gumbels):
            m, carry, info, corners = step(m, carry, img, grid, g, boot)
            infos.append(info)
        return m, carry, infos, corners

    return chunk_step
