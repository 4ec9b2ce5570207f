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
(``lax.switch``/``lax.cond``). Here each decision is a :func:`device_if` on
a () bool tensor:

* the state: FIRST, SECOND or tracking (RUNNING or LOST), two nested IFs;
* SECOND seeds the map where the bootstrap succeeded;
* LOST relocalizes, RUNNING predicts from the motion model; after
  ``reloc_escalate_after`` failed LOST frames the relocalizer tries every
  keyframe (a nested IF: the two sweeps differ in shape);
* in full SLAM mode a good frame runs the map update, a good keyframe frame
  the keyframe stage before it.

Eagerly (the CPU, or the card with graphs off) :func:`device_if` reads its
predicate and runs one Python branch. While a CUDA graph captures, it adds
an IF node per branch (``ops/cuda/graph_if.py``; a branch with an else is
an if/else pair set by one condition kernel), so that a replayed frame
decides on the device and reads nothing back. Point statistics and the
motion model select with ``where``. A stream never goes back from
RUNNING/LOST to FIRST/SECOND (as in the reference), so once it tracks (or a
localizer started LOST) the eager step builds the tracking branch alone and
reads no state.

Loops. The reference's ``while_loop``/``fori_loop``/``scan`` are
:func:`device_while` and :func:`device_fori`: Python loops eagerly, WHILE
nodes under capture (a counted one for :func:`device_fori`, whose index
lives in its condition kernel). Local BA's LM steps are one, and a chunk of
frames (:meth:`StepRunner.chunk`) is a WHILE node over the whole step.

State. A step reads and writes a :class:`StepState`. Functionally it rebinds
its fields as ``_replace`` does (:func:`make_step`); in place it copies
each leaf a branch changed into the storage it was made with, so every
leaf keeps its address from frame to frame (the counterpart of the
reference stream's buffer donation). :class:`StepRunner` steps one stream in
place and, on the card, captures its first frame into a CUDA graph that
every frame replays: one launch, no host read.

Random draws come in as arguments: the pose RANSAC's Gumbel noise per
tracking frame, and the bootstrap's two (the homography and ground-plane
RANSACs, the same on every attempt, as the reference derives them from a
key that does not change).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional, Tuple

import torch

from .. import const
from ..core import camera as cam
from ..core import se3
from ..ops import fast as fast_ops
from ..ops import interp, orb, pyramid
from ..ops.cuda import graph_if
from ..solvers import ba
from ..state.map_state import (MapState, alloc_slots, empty_map, scatter,
                               set_row, store_pyramid)
from ..utils import trace
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


# the packed layout of one frame's FrameInfo (pack_info): pose 7, world_tf
# 7, then the scalars in this order
INFO_WIDTH = 21


def pack_info(info: FrameInfo) -> torch.Tensor:
    """One frame's FrameInfo as a (21,) float32 tensor on its device (every
    int fits float32 exactly): what a recorded frame keeps, and what the
    stream copies to the host once, in its ``result``."""
    return torch.cat([
        info.pose, info.world_tf,
        torch.stack([
            info.state.float(), info.quality.float(),
            info.n_matches.float(), info.n_attempts.float(),
            info.is_keyframe.float(), info.n_corners.float(),
            info.median_shift.float(),
        ]),
    ])


def unpack_info(row: torch.Tensor) -> FrameInfo:
    """Inverse of :func:`pack_info` on the tensor's device, for packed rows
    with any leading axes (``(..., 21)`` -> leaves ``(..., 7)`` and
    ``(...)``), in the reference's dtypes: float32 poses, int32 counts and
    states, a bool ``is_keyframe``. Reads nothing back."""
    return FrameInfo(
        pose=row[..., 0:7], world_tf=row[..., 7:14],
        state=row[..., 14].to(torch.int32),
        quality=row[..., 15].to(torch.int32),
        n_matches=row[..., 16].to(torch.int32),
        n_attempts=row[..., 17].to(torch.int32),
        is_keyframe=row[..., 18] > 0.5,
        n_corners=row[..., 19].to(torch.int32), median_shift=row[..., 20],
    )


# ------------------------------------------------------------ branches
_warming = threading.local()


def _host_read(pred: torch.Tensor) -> bool:
    """The one host read of an eager :func:`device_if`."""
    return bool(pred)


@contextlib.contextmanager
def warming():
    """Within the block every :func:`device_if` of this thread runs both of
    its branches, each on the stream its IF node would capture it on: the
    eager pass before a capture, which loads every kernel and library
    handle the graph will hold."""
    was = getattr(_warming, "on", False)
    _warming.on = True
    try:
        yield
    finally:
        _warming.on = was


def _copy_into(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same structure of
    tuples, a None leaf in both), leaving alone a leaf that is its own
    destination."""
    if dst is None and src is None:
        return
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"cannot write {tuple(src.shape)} "
                                 f"{src.dtype} into {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src)
        return
    for d, x in zip(dst, src, strict=True):
        _copy_into(d, x)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def device_if(pred: torch.Tensor, body, orelse=None):
    """``body()`` where the () bool tensor ``pred`` is true, else
    ``orelse()`` where one is given; returns what the branch returned (a
    tensor, a tuple of them, or None).

    Eagerly: one host read of ``pred``, then one Python branch. While a CUDA
    graph captures: an IF node on ``pred`` around ``body``, and with an
    ``orelse`` a second IF node around it that the same condition kernel
    sets to ``not pred`` (an if/else pair: one launch), which copies its
    outputs into ``body``'s there, so that the code after reads the same
    tensors whichever branch ran (as ``torch.cond``'s graph form does). A
    branch that changes the step's state writes it through
    :class:`StepState`.
    """
    if _capturing(pred):
        if orelse is None:
            with graph_if.if_node(pred):
                return body()
        return graph_if.if_else(pred, body,
                                lambda out: _copy_into(out, orelse()))
    if getattr(_warming, "on", False):
        with graph_if.warm_body(pred.device):
            out = body()
        if orelse is not None:
            with graph_if.warm_body(pred.device):
                _copy_into(out, orelse())
        return out
    if _host_read(pred):
        return body()
    return None if orelse is None else orelse()


def _first_leaf(tree) -> torch.Tensor:
    return tree if isinstance(tree, torch.Tensor) else _first_leaf(tree[0])


def _while_node(cond, body, carry):
    """The captured form of :func:`device_while`: the carry in buffers
    allocated before the node (clones of ``carry``), a WHILE node whose
    body runs ``body`` on them and copies its results back into them. The
    condition kernels read ``cond``'s output where it lies: before the
    node ``cond`` of the buffers, at the end of the body ``cond`` of the
    new carry."""
    bufs = _clone(carry)
    with graph_if.while_node(cond(bufs)) as loop:
        _copy_into(bufs, body(bufs))
        loop.pred = cond(bufs)
    return bufs


def device_while(cond, body, carry, *, max_iters: int, check_every: int = 1):
    """``lax.while_loop(cond, body, carry)``: ``carry`` is a tensor or a
    tuple (NamedTuples included) of them, ``cond(carry)`` a () bool tensor,
    ``body(carry)`` the next carry, of the same structure, shapes and
    dtypes. Returns the final carry.

    Eagerly: a Python loop of at most ``max_iters`` iterations that reads
    the predicate on the host before every ``check_every``-th one (the
    first included) and stops where it is false; so ``body`` must leave the
    carry unchanged where ``cond`` is false (a frozen lane), and the result
    does not depend on ``check_every``. Within :func:`warming`: ``body``
    runs once on the stream a WHILE node would capture it on, and nothing
    is read back. While a CUDA graph captures: one WHILE node
    (:func:`_while_node`), which reads nothing back either; its iterations
    are bounded by ``cond`` alone.
    """
    if _capturing(_first_leaf(carry)):
        return _while_node(cond, body, carry)
    if getattr(_warming, "on", False):
        with graph_if.warm_body(_first_leaf(carry).device):
            out = body(carry)
            cond(out)
        return out
    for i in range(max_iters):
        if i % check_every == 0 and not _host_read(cond(carry)):
            break
        carry = body(carry)
    return carry


def device_fori(n: int, body, carry):
    """``lax.fori_loop(0, n, body, carry)`` with ``body(i, carry)``, ``i``
    a () int32 tensor on the carry's device. Eagerly a Python loop that
    reads nothing back; within :func:`warming` ``body`` runs once (``i``
    0); while a CUDA graph captures, one counted WHILE node
    (``graph_if.fori_node``): the carry in buffers made before the node, as
    :func:`_while_node`'s, and ``i`` the node's index buffer, which its
    condition kernels set and count (no kernel of the loop's own)."""
    first = _first_leaf(carry)
    if _capturing(first):
        bufs = _clone(carry)
        i = torch.empty((), dtype=torch.int32, device=first.device)
        with graph_if.fori_node(i, n):
            _copy_into(bufs, body(i, bufs))
        return bufs
    i0 = torch.zeros((), dtype=torch.int32, device=first.device)
    if getattr(_warming, "on", False):
        with graph_if.warm_body(first.device):
            return body(i0, carry)
    for k in range(n):
        carry = body(i0 + k, carry)
    return carry


class StepState:
    """The ``(MapState, SlamCarry)`` a step reads and writes.

    Functional (``inplace=False``): :meth:`update` rebinds ``m`` and
    ``carry``, as ``_replace`` does, and never writes a tensor. In place:
    :meth:`update` copies each leaf that changed into the storage the state
    was made with (a leaf that is its own storage is left alone), so ``m``
    and ``carry`` hold the same tensors on every frame: what a replayed CUDA
    graph reads and writes. ``frozen_map``: the map is shared and must never
    be written.
    """

    def __init__(self, m: MapState, carry: SlamCarry, inplace: bool,
                 frozen_map: bool = False):
        self.m, self.carry = m, carry
        self.inplace, self.frozen_map = inplace, frozen_map

    def update(self, m: Optional[MapState] = None,
               carry: Optional[SlamCarry] = None) -> None:
        if m is not None:
            if self.frozen_map:
                raise RuntimeError("a step wrote the frozen shared map")
            if self.inplace:
                _copy_into(self.m, m)
            else:
                self.m = m
        if carry is not None:
            if self.inplace:
                _copy_into(self.carry, carry)
            else:
                self.carry = carry


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


def make_frame(cfg: Config, undistort: bool):
    """Build ``frame(st, img, grid, gumbel, boot, tracking) ->
    (row, Corners, tracking)``: one frame of the state machine on the
    :class:`StepState` ``st``.

    ``img`` is the raw (cropped) frame on the device, any integer/float
    dtype (uint8 recommended). ``grid`` is the undistort map (ignored when
    ``undistort`` is False). ``gumbel`` is the (n_hyp, S) Gumbel noise of
    this frame's pose RANSAC, or None where the caller has none (a frame
    that tracks eagerly then raises). ``boot`` is the :class:`BootNoise` of
    the stream (unused while serving). ``tracking``: the caller knows the
    state is RUNNING or LOST, so only the tracking branch is built; else
    the state picks FIRST, SECOND or tracking through nested
    :func:`device_if`s. Returns the frame's packed info (:func:`pack_info`,
    a tensor of its own), its detected corners, and, eagerly, whether the
    stream is tracking after the frame.
    """
    s = cfg.sdvl
    intr = intrinsics(cfg)
    levels = s.pyramid_levels
    escalates = (s.reloc_escalate_after >= 0
                 and s.max_keyframes > s.reloc_max_keyframes)
    orb_radius = s.orb_size // 2
    ba_window = min(10, s.max_keyframes - 1)
    # local BA must take the dense Cholesky solve: PCG reads back to stop
    assert ba_window + 1 <= ba.CG_KF_THRESHOLD

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
    def first_frame(st, pyr, corners):
        """Keep the frame if it has enough corners, else try again next
        frame (where selects: nothing is read back)."""
        carry = st.carry
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
        st.update(carry=carry)
        return _info(carry, n_corners=n)

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

    def second_frame(st, pyr, corners, noise: BootNoise, tracks: list):
        """Flow + homography: restart on flow collapse, wait on low
        parallax, seed the map on success (a :func:`device_if` on
        ``success``; eagerly, ``tracks[0]`` is set where it ran). Returns
        the packed info."""
        carry = st.carry
        dev = carry.pose.device
        boot = bootstrap.init_two_view(
            intr, carry.pyr1, pyr, carry.c1_xy, carry.c1_valid,
            noise.homography, map_scale=s.map_scale,
            thresh_px=s.inlier_error_threshold,
            min_corners=s.min_init_corners,
        )
        success = (boot.ok_flow & (boot.median_shift >= s.min_avg_shift)
                   & (boot.n_inliers >= s.min_init_corners))

        def seeded():
            m, c, T = bootstrap_map(st.m, carry, pyr, corners, boot, noise)
            st.update(m=m, carry=c)
            tracks[0] = True
            return T

        def waiting():
            st.update(carry=carry._replace(state=torch.where(
                boot.ok_flow, i32(STATE_SECOND, dev),
                i32(STATE_FIRST, dev))))
            return se3.identity(device=dev)

        T = device_if(success, seeded, waiting)
        return pack_info(_info(st.carry, world_tf=T, is_keyframe=success,
                               n_matches=boot.n_inliers,
                               median_shift=boot.median_shift))

    # ----------------------------------------------------------- RUNNING
    def do_reloc(m, carry, pyr):
        """Relocalize: the alignment reference becomes the best-matching
        KEYFRAME (its pyramid, pose and observed points), not the previous
        -- possibly garbage -- frame. After ``reloc_escalate_after`` failed
        LOST frames (LOST begins at lost_frames == 3) every keyframe is
        tried instead of the nearest ``reloc_max_keyframes``."""
        S = carry.last_idx.shape[0]
        lvl = min(4, levels - 1)

        def sweep(max_kf):
            rl = relocalize.relocalize(m, intr, pyr, carry.pose, level=lvl,
                                       max_kf=max_kf)
            return reloc_reference(m, rl.kf, S) + (rl.pose,)

        if not escalates:
            return sweep(s.reloc_max_keyframes)
        sweep_all = carry.lost_frames >= 3 + s.reloc_escalate_after
        return device_if(sweep_all, lambda: sweep(s.max_keyframes),
                         lambda: sweep(s.reloc_max_keyframes))

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
        m = mapper.local_ba(m, intr, slot, window=ba_window,
                            max_points=min(s.max_points, 512))
        # redundant-keyframe pruning runs in update_map, every frame
        return mapper.prune_weak_points(m)

    def update_map(m, pyr, pose):
        return mapper.update_map(
            m, intr, pyr, pose, n_samples=s.epipolar_samples,
            threshold_converged=s.threshold_converged,
            max_failed=s.max_failed, use_orb=s.use_orb,
            patch_half=s.patch_size // 2, lk_iters=s.max_align_its,
            orb_radius=orb_radius,
            stale_kf_window=2 * s.max_search_keyframes,
            map_scale=s.map_scale, scale_min_dist=s.scale_min_dist,
            corner_gate=s.epipolar_corner_gate,
            corner_thresh=s.min_feature_score,
        )

    def running(st, pyr, corners, gumbel):
        """One steady-state tracking step (RUNNING or LOST), then, in full
        SLAM mode on a good frame, the mapping stage. Every decision is a
        device predicate."""
        carry = st.carry
        dev = carry.pose.device
        if gumbel is None:
            raise ValueError(
                f"frame {int(carry.frame_id)} tracks but no pose-RANSAC "
                "noise was provided for it")
        is_lost = carry.state == STATE_LOST
        ref = device_if(is_lost, lambda: do_reloc(st.m, carry, pyr),
                        lambda: do_predict(carry))
        ref_pyr, ref_idx, ref_ok, pose_ref, pose_pred = ref

        tr = tracker.track_frame(
            st.m, intr, ref_pyr, ref_idx, ref_ok,
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
            st.update(m=tracker.update_point_stats(
                st.m, tr, max_failed=s.max_failed,
                enabled=torch.logical_not(is_lost)))

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
        xi_model = torch.where(is_lost, torch.zeros_like(xi_model),
                               xi_model)
        frames_since_kf = carry.frames_since_kf + 1
        if s.localize_only:
            is_kf = const(False, torch.bool, dev)
        else:
            is_kf = good & mapper.need_keyframe(
                tr.n_matches, carry.kf_matches, frames_since_kf,
                s.min_keyframe_its)

            def mapping():
                device_if(is_kf, lambda: st.update(
                    m=with_kf(st.m, carry, pyr, corners, tr)))
                st.update(m=update_map(st.m, pyr, tr.pose))

            device_if(good, mapping)
        # bad path: coast on the prediction, count the failure, go LOST at 3
        lost_bad = carry.lost_frames + 1
        state_bad = torch.where(lost_bad >= 3, i32(STATE_LOST, dev),
                                i32(STATE_RUNNING, dev))

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
        st.update(carry=carry)
        return _info(carry, quality=quality, n_matches=tr.n_matches,
                     n_attempts=tr.n_attempts, is_keyframe=is_kf)

    # -------------------------------------------------------------- frame
    def frame(st: StepState, img, grid, gumbel, boot: BootNoise = None,
              tracking: bool = False):
        carry = st.carry
        # steady-state cell locking: suppress detector cells that already
        # hold tracked map points, projected at the previous frame's pose.
        # A stale match index is clamped, as the reference's gather does.
        # In FIRST/SECOND, last_ok is all-False: no lock.
        lock_xy, lock_valid = lock_points(intr, st.m, carry.pose,
                                          carry.last_idx, carry.last_ok)
        pyr, corners = preprocess(img, grid, lock_xy, lock_valid)

        def track():
            return pack_info(running(st, pyr, corners, gumbel))

        # serving starts LOST against a loaded map: all its frames track
        if s.localize_only or tracking:
            row, tracking = track(), True
        else:
            # the reference's lax.switch on the state: FIRST, SECOND or
            # tracking (RUNNING / LOST), as nested device_ifs
            tracks = [False]

            def bootstrapping():
                first = carry.state <= STATE_FIRST
                return device_if(
                    first, lambda: pack_info(first_frame(st, pyr, corners)),
                    lambda: second_frame(st, pyr, corners, boot, tracks))

            def tracked():
                tracks[0] = True
                return track()

            row = device_if(carry.state >= STATE_RUNNING, tracked,
                            bootstrapping)
            tracking = tracks[0]
        st.update(carry=st.carry._replace(
            last_pyr=pyr, frame_id=st.carry.frame_id + 1))
        return row, corners, tracking

    return frame


def make_step(cfg: Config, undistort: bool):
    """Build the functional ``step(m, carry, img, grid, gumbel, boot) ->
    (m, carry, FrameInfo, Corners)`` (arguments as :func:`make_frame`'s):
    nothing it is given is written, the state is read back on every frame,
    and every branch is an eager :func:`device_if`."""
    frame = make_frame(cfg, undistort)

    def step(m: MapState, carry: SlamCarry, img, grid, gumbel,
             boot: BootNoise = None):
        st = StepState(m, carry, inplace=False)
        row, corners, _ = frame(st, img, grid, gumbel, boot)
        return st.m, st.carry, unpack_info(row), corners

    return step


def _clone(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*map(_clone, tree)) if hasattr(tree, "_fields") \
        else tuple(map(_clone, tree))


# the eager passes through every branch before a capture (each runs the
# stage once: a frame's preprocessing, its detection launch included)
CAPTURE_PASSES = 2


class StageGraph:
    """A stage function captured into a CUDA graph over fixed storage.

    ``fn(st, *inputs)`` reads and writes the in-place :class:`StepState`
    ``st`` (or a tuple of them, one per stream a batch steps) and returns
    its outputs (tensors, or tuples and NamedTuples of them). The capture:
    :data:`CAPTURE_PASSES` eager passes through both branches of every
    :func:`device_if` on a copy of each state (its carry, and its map
    unless ``shared_map``: the stage only reads it), the last under
    ``set_sync_debug_mode("error")``; then ``fn`` captured over input
    buffers of its own (clones of ``inputs``), its allocations from the
    graph memory pool ``pool`` where one is given (graphs that never run at
    the same time may share one), else from a new pool. A capture that
    fails raises; nothing falls back to eager.

    The sync-debug mode of the checked pass and the capture's error mode are
    the process's: no other thread may use the card meanwhile.

    Calling the graph copies ``inputs`` into its buffers and replays it; it
    returns the graph's own output tensors, which the next replay
    overwrites. ``name`` says which stage it is.

    Spans of the process tracer (``utils/trace.py``, recorded while it is
    active), under whatever span is open: ``graph.warmup``, one per eager
    pass, and ``graph.capture`` (the wait for the passes' work, the input
    buffers, the capture), which together take ``capture_s``;
    ``graph.replay`` per call (the input copy and the replay's launch).
    With ``marks``, a graph captured while the tracer is active owns
    ``stages`` (a ``trace.Stages``, else None), which the stage marks that
    ``fn`` makes (``trace.mark``) time on each replay.
    """

    def __init__(self, name: str, fn, st, inputs: tuple,
                 shared_map: bool = False, pool=None, marks: bool = False):
        t0 = time.perf_counter()
        self.name = name
        tracer = trace.tracer()

        def scratch(s: StepState) -> StepState:
            return StepState(s.m if shared_map else _clone(s.m),
                             _clone(s.carry), inplace=True,
                             frozen_map=s.frozen_map)

        for i in range(CAPTURE_PASSES):
            with tracer.span("graph.warmup"):
                copy = (tuple(map(scratch, st)) if isinstance(st, tuple)
                        else scratch(st))
                with warming(), (_sync_errors() if i == CAPTURE_PASSES - 1
                                 else contextlib.nullcontext()):
                    fn(copy, *inputs)
                del copy
        with tracer.span("graph.capture"):
            torch.cuda.synchronize()
            self.inputs = _clone(tuple(inputs))
            self.stages = (trace.Stages(torch.cuda.current_device())
                           if marks and tracer.active else None)
            self.graph = torch.cuda.CUDAGraph()
            with graph_if.capture(self.graph, pool) as cap, \
                    trace.marking(self.stages):
                self.outputs = fn(st, *self.inputs)
            self.pool_bytes = cap.pool_bytes  # what the capture added to it
            torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0   # warm-up and capture
        self.replays = 0

    def __call__(self, *inputs):
        with trace.tracer().span("graph.replay"):
            _copy_into(self.inputs, inputs)
            self.graph.replay()
        self.replays += 1
        return self.outputs


class StepRunner:
    """One stream's step over fixed storage.

    ``m`` and ``carry`` become the storage (they are written in place, the
    map never where ``frozen_map``). Eagerly (no ``graphs``) each frame
    reads back its state until the stream tracks. With ``graphs`` (CUDA
    only) the stream's first frame is captured into a :class:`StageGraph`
    holding every branch of the state machine (FIRST, SECOND and tracking;
    tracking only where the stream is known to track), and that frame and
    every later one is an upload into the graph's input buffers and one
    replay that reads nothing back. A chunk of T frames (:meth:`chunk`) is
    one replay of a graph of its own per T, whose WHILE node runs the step
    once per frame.

    :meth:`step` returns the frame's packed info (:func:`pack_info`, a
    tensor of its own) and its corners.
    """

    def __init__(self, cfg: Config, undistort: bool, m: MapState,
                 carry: SlamCarry, grid=None, graphs: bool = False,
                 tracking: bool = False, frozen_map: bool = False):
        if graphs and carry.pose.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.cfg = cfg
        self.st = StepState(m, carry, inplace=True, frozen_map=frozen_map)
        self.grid = grid
        self.graphs = graphs
        self.tracking = tracking or cfg.sdvl.localize_only
        self._frame = make_frame(cfg, undistort)
        self.graph: Optional[StageGraph] = None
        self.chunk_graphs = {}     # T -> StageGraph of a chunk of T frames
        n_hyp = min(cfg.sdvl.ransac_hypotheses, cfg.sdvl.max_ransac_its)
        self._no_gumbel = (n_hyp, lane_counts(cfg)[1])

    def _all_graphs(self):
        return [g for g in [self.graph, *self.chunk_graphs.values()]
                if g is not None]

    @property
    def replays(self) -> int:
        """Replays of the per-frame graph and of the chunk graphs."""
        return sum(g.replays for g in self._all_graphs())

    @property
    def pool_bytes(self):
        """Device memory of the graphs' pools (None before a capture)."""
        graphs = self._all_graphs()
        return sum(g.pool_bytes for g in graphs) if graphs else None

    @property
    def capture_s(self):
        """Host seconds of the graphs' warm-ups and captures (None before a
        capture)."""
        graphs = self._all_graphs()
        return sum(g.capture_s for g in graphs) if graphs else None

    def _shared_map(self) -> bool:
        return self.st.frozen_map or self.cfg.sdvl.localize_only

    def _gumbel(self, gumbel, dev):
        """A graph's pose-RANSAC noise input: zeros where the caller has
        none (a FIRST or SECOND frame's; a frame that tracks on the graph
        path needs its own)."""
        if gumbel is not None:
            return gumbel
        return torch.zeros(self._no_gumbel, dtype=torch.float32, device=dev)

    def _graph_frame(self, st, img, gumbel, boot):
        row, corners, _ = self._frame(st, img, self.grid, gumbel, boot,
                                      self.tracking)
        return row, corners

    def step(self, img: torch.Tensor, gumbel: Optional[torch.Tensor],
             boot: Optional[BootNoise] = None):
        if not self.graphs:
            row, corners, self.tracking = self._frame(
                self.st, img, self.grid, gumbel, boot, self.tracking)
            return row, corners
        gumbel = self._gumbel(gumbel, img.device)
        if self.graph is None:
            self.graph = StageGraph("step", self._graph_frame, self.st,
                                    (img, gumbel, boot),
                                    shared_map=self._shared_map())
        return _clone(self.graph(img, gumbel, boot))

    def _chunk(self, st, imgs, gumbels, boot):
        """``imgs.shape[0]`` frames of the state machine, frame ``i``'s info
        in row ``i`` of the result: ``make_chunk_step``'s scan."""
        T = imgs.shape[0]
        dev = imgs.device
        rows = torch.zeros((T, INFO_WIDTH), dtype=torch.float32, device=dev)

        def body(i, carry):
            rows, _corners = carry
            at = i.long().reshape(1)
            row, corners = self._graph_frame(
                st, imgs.index_select(0, at)[0],
                gumbels.index_select(0, at)[0], boot)
            return rows.index_copy(0, at, row[None]), corners

        # the loop's carry holds the newest frame's corners too
        return device_fori(T, body, (rows, _corners_like(self.cfg, dev)))

    def chunk(self, imgs: torch.Tensor, gumbels, boot=None):
        """Step ``imgs`` (T, H, W) with ``gumbels`` (a list of T noise
        tensors or Nones). Eagerly one frame after another; with graphs
        one replay of the chunk graph of T frames (captured at the first
        chunk of T frames). Returns the (T, INFO_WIDTH) packed infos and
        the last frame's corners."""
        if not self.graphs:
            rows, corners = [], None
            for img, g in zip(imgs, gumbels):
                row, corners = self.step(img, g, boot)
                rows.append(row)
            return torch.stack(rows), corners
        dev = imgs.device
        g = torch.stack([self._gumbel(x, dev) for x in gumbels])
        T = imgs.shape[0]
        graph = self.chunk_graphs.get(T)
        if graph is None:
            graph = self.chunk_graphs[T] = StageGraph(
                f"chunk_{T}", self._chunk, self.st, (imgs, g, boot),
                shared_map=self._shared_map())
        return _clone(graph(imgs, g, boot))


def _corners_like(cfg: Config, dev):
    """A zero Corners of the detector's capacity for ``cfg``: the initial
    value of a chunk loop's corners."""
    n = lane_counts(cfg)[0]
    return fast_ops.Corners(
        xy=torch.zeros((n, 2), dtype=torch.float32, device=dev),
        score=torch.zeros(n, dtype=torch.float32, device=dev),
        level=torch.zeros(n, dtype=torch.int32, device=dev),
        valid=torch.zeros(n, dtype=torch.bool, device=dev))


@contextlib.contextmanager
def _sync_errors():
    """Raise on any synchronising CUDA call within the block."""
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(was)
