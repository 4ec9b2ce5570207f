"""World-model state: keyframes, points, observations, candidates.

Counterpart of ``sdvl_tpu/state/map_state.py``: the whole map is one
fixed-capacity structure of tensors with the reference's field names and
shapes, so that a snapshot written by the JAX package loads into it
(``io/snapshot.py``). Two families of fields change dtype, because of what
torch indexes and shifts with:

* index-valued fields (``pt_anchor_kf``, ``obs_level``, ``cand_kf``,
  ``cand_level``) are int64, the type torch gathers with;
* ORB descriptors (``pt_desc``, ``cand_desc``) are int64 holding the
  reference's uint32 words in their low 32 bits: torch's uint32 has no shifts
  or products, and ``>>`` on int32 is arithmetic.

Slot allocation is a rank-based scatter (the reference's allocation of a
new point is "take the next free slot"); rejected items get the index one
past the end, which :func:`scatter` drops, as the reference's
``mode="drop"`` scatters do.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import se3


class FrameState(NamedTuple):
    """One processed camera frame."""

    pyr: Tuple[torch.Tensor, ...]  # L levels, (H/2^l, W/2^l) f32
    pose: torch.Tensor             # (7,) world->cam
    corner_xy: torch.Tensor        # (C2, 2) detected corners, level-0 px
    corner_level: torch.Tensor     # (C2,) int32
    corner_score: torch.Tensor     # (C2,)
    corner_valid: torch.Tensor     # (C2,) bool
    frame_id: torch.Tensor         # () int32


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor          # (K, 7)
    kf_valid: torch.Tensor         # (K,) bool
    kf_frame_id: torch.Tensor      # (K,) int32 (age/order; -1 empty)
    kf_pyr: Tuple[torch.Tensor, ...]  # per level (K, H/2^l, W/2^l) uint8;
                                   #   samplers convert after the gather

    # --- dense observation structure ---
    obs_mask: torch.Tensor         # (K, P) bool
    obs_px: torch.Tensor           # (K, P, 2) pixel position of observation
    obs_level: torch.Tensor        # (K, P) int64 pyramid level

    # --- world points ---
    pt_pos: torch.Tensor           # (P, 3) world xyz
    pt_valid: torch.Tensor         # (P,) bool
    pt_anchor_kf: torch.Tensor     # (P,) int64 keyframe slot of anchor obs
    pt_fail: torch.Tensor          # (P,) int32 consecutive failed projections
    pt_found: torch.Tensor         # (P,) int32 total successful observations
    pt_desc: torch.Tensor          # (P, 8) int64 anchor ORB descriptor words

    # --- depth-filter candidates ---
    cand_valid: torch.Tensor       # (C,) bool
    cand_kf: torch.Tensor          # (C,) int64 anchor keyframe slot
    cand_px: torch.Tensor          # (C, 2) anchor pixel
    cand_level: torch.Tensor       # (C,) int64
    cand_bearing: torch.Tensor     # (C, 3) unit bearing in anchor cam
    cand_rho: torch.Tensor         # (C,) inverse-depth mean
    cand_sigma2: torch.Tensor      # (C,) inverse-depth variance
    cand_a: torch.Tensor           # (C,) Beta inlier count
    cand_b: torch.Tensor           # (C,) Beta outlier count
    cand_fail: torch.Tensor        # (C,) int32 consecutive failed searches
    cand_desc: torch.Tensor        # (C, 8) int64 anchor ORB descriptor words

    # --- counters ---
    n_keyframes: torch.Tensor      # () int32 total ever added
    n_evicted: torch.Tensor        # () int32 keyframes removed by the cap
    n_pruned: torch.Tensor         # () int32 keyframes removed as redundant

    @property
    def capacities(self):
        K, P = self.obs_mask.shape
        C = self.cand_valid.shape[0]
        return K, P, C


# dtype of every MapState field as the port holds it (kf_pyr: per level)
FIELD_DTYPES = dict(
    kf_pose=torch.float32, kf_valid=torch.bool, kf_frame_id=torch.int32,
    kf_pyr=torch.uint8,
    obs_mask=torch.bool, obs_px=torch.float32, obs_level=torch.int64,
    pt_pos=torch.float32, pt_valid=torch.bool, pt_anchor_kf=torch.int64,
    pt_fail=torch.int32, pt_found=torch.int32, pt_desc=torch.int64,
    cand_valid=torch.bool, cand_kf=torch.int64, cand_px=torch.float32,
    cand_level=torch.int64, cand_bearing=torch.float32,
    cand_rho=torch.float32, cand_sigma2=torch.float32,
    cand_a=torch.float32, cand_b=torch.float32, cand_fail=torch.int32,
    cand_desc=torch.int64,
    n_keyframes=torch.int32, n_evicted=torch.int32, n_pruned=torch.int32,
)


def store_pyramid(pyr):
    """Quantize a float pyramid for the keyframe store (uint8, rounding)."""
    return tuple(
        torch.round(p).clamp(0.0, 255.0).to(torch.uint8) for p in pyr
    )


def empty_map(n_kf: int, n_pts: int, n_cand: int, img_shape: Tuple[int, int],
              levels: int, device="cuda") -> MapState:
    H, W = img_shape
    shapes = dict(
        kf_pose=(n_kf, 7), kf_valid=(n_kf,), kf_frame_id=(n_kf,),
        obs_mask=(n_kf, n_pts), obs_px=(n_kf, n_pts, 2),
        obs_level=(n_kf, n_pts),
        pt_pos=(n_pts, 3), pt_valid=(n_pts,), pt_anchor_kf=(n_pts,),
        pt_fail=(n_pts,), pt_found=(n_pts,), pt_desc=(n_pts, 8),
        cand_valid=(n_cand,), cand_kf=(n_cand,), cand_px=(n_cand, 2),
        cand_level=(n_cand,), cand_bearing=(n_cand, 3), cand_rho=(n_cand,),
        cand_sigma2=(n_cand,), cand_a=(n_cand,), cand_b=(n_cand,),
        cand_fail=(n_cand,), cand_desc=(n_cand, 8),
        n_keyframes=(), n_evicted=(), n_pruned=(),
    )
    kw = {
        name: torch.zeros(shape, dtype=FIELD_DTYPES[name], device=device)
        for name, shape in shapes.items()
    }
    kw["kf_pose"] = se3.identity((n_kf,), device=device)
    kw["kf_frame_id"] = torch.full((n_kf,), -1, dtype=torch.int32,
                                   device=device)
    kw["kf_pyr"] = tuple(
        torch.zeros((n_kf, H >> l, W >> l), dtype=torch.uint8, device=device)
        for l in range(levels)
    )
    return MapState(**kw)


def scatter(t: torch.Tensor, index, values, accumulate: bool = False
            ) -> torch.Tensor:
    """``t.at[index].set(values, mode="drop")`` (``.add`` with
    ``accumulate``), out of place.

    ``index`` is a tuple of integer tensors, one per leading dimension of
    ``t`` (broadcast against each other); an element whose index is out of
    range in any dimension (the reference's "drop" slot: the size of that
    dimension) writes into a dump row that is cut off. With ``accumulate``
    repeated indices add up, as ``.at[].add`` does; without it the caller
    makes sure that kept indices do not repeat.
    """
    if not isinstance(index, tuple):
        index = (index,)
    lead = t.shape[:len(index)]
    rest = t.shape[len(index):]
    n = 1
    for d in lead:
        n *= d
    index = torch.broadcast_tensors(*[i.long() for i in index])
    flat = torch.zeros_like(index[0])
    drop = torch.zeros_like(index[0], dtype=torch.bool)
    for i, d in zip(index, lead):
        flat = flat * d + i.clamp(0, d - 1)
        drop = drop | (i < 0) | (i >= d)
    flat = torch.where(drop, torch.full_like(flat, n), flat)
    out = torch.cat([t.reshape((n,) + rest),
                     t.new_zeros((1,) + rest)])
    shape = flat.shape + rest
    if isinstance(values, torch.Tensor):
        values = values.to(t.dtype).expand(shape)
    else:   # a fill, not a host->device copy
        values = t.new_full(shape, values)
    out.index_put_((flat,), values, accumulate=accumulate)
    return out[:n].reshape(t.shape)


def set_row(t: torch.Tensor, row: torch.Tensor, value) -> torch.Tensor:
    """``t.at[row].set(value)``, out of place, for a 0-d in-range row index
    tensor (no read of the index back to the host)."""
    if not isinstance(value, torch.Tensor):
        value = t.new_full(t.shape[1:], value)
    return t.index_copy(0, row.reshape(1).long(),
                        value.to(t.dtype).reshape((1,) + t.shape[1:]))


def alloc_slots(free: torch.Tensor, incoming_valid: torch.Tensor):
    """Assign each valid incoming item a free slot index: the i-th valid
    incoming item takes the i-th free slot (free slots in index order, a
    stable sort). Returns ``(slots (M,) int64, ok (M,))``; rejected items
    (invalid, or no free slot left) get ``slots == N``."""
    N = free.shape[0]
    order = torch.sort((~free).to(torch.uint8), stable=True)[1]
    n_free = torch.sum(free)
    rank = torch.cumsum(incoming_valid.long(), 0) - 1
    ok = incoming_valid & (rank < n_free) & (rank >= 0)
    slots = torch.where(ok, order[rank.clamp(0, N - 1)],
                        torch.full_like(rank, N))
    return slots, ok


def covisibility(m: MapState) -> torch.Tensor:
    """(K, K) shared-point counts between valid keyframes (diagonal 0)."""
    obs = m.obs_mask.float()
    covis = obs @ obs.T
    v = m.kf_valid.float()
    covis = covis * v[:, None] * v[None, :]
    return covis - torch.diag(torch.diag(covis))


def covisibility_row(m: MapState, kf: torch.Tensor) -> torch.Tensor:
    """Row ``kf`` of :func:`covisibility` (float32 counts), without the
    (K, K) product."""
    row_obs = m.obs_mask.index_select(0, kf.reshape(1).long())   # (1, P)
    counts = torch.sum(m.obs_mask & row_obs, dim=1).float()
    kf_valid_row = m.kf_valid.index_select(0, kf.reshape(1).long())
    counts = counts * m.kf_valid.float() * kf_valid_row.float()
    self_ = torch.arange(m.kf_valid.shape[0], device=counts.device) \
        == kf.reshape(1)
    return torch.where(self_, torch.zeros_like(counts), counts)


def best_connections(m: MapState, kf: torch.Tensor, n: int):
    """Top-n covisible keyframe slots of ``kf``; equal counts keep slot
    order (a stable sort, as the reference's ``top_k``). Returns
    ``(idx (n,) int64, counts (n,) float32)``."""
    row = covisibility_row(m, kf)
    counts, idx = torch.sort(row, descending=True, stable=True)
    return idx[:n], counts[:n]


def kf_slot_to_evict(m: MapState, cur_pos: torch.Tensor) -> torch.Tensor:
    """Furthest valid keyframe from the current camera position (the
    first one on a tie)."""
    centers = se3.translation(se3.inverse(m.kf_pose))
    d = torch.sqrt(torch.sum((centers - cur_pos) ** 2, dim=-1))
    d = torch.where(m.kf_valid, d, torch.full_like(d, float("-inf")))
    return torch.argmax(d)
