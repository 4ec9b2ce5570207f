"""The system under test, and the only module of the benchmark that imports
it: the PyTorch and CUDA port ``sdvl_tpu_torch``. Everything the benchmark
asks of the program goes through these functions, so a test can put a
program of its own (a broken one, say) in their place."""

from __future__ import annotations

import os
import tempfile

import torch


def load_config(cfg: dict):
    """The port's ``Config`` of a configuration file's ``cfg`` (the
    reference-format keys of a ``configs/*.cfg``), read by the port's own
    ``load_cfg``."""
    from sdvl_tpu_torch.pipeline.config import load_cfg

    text = "".join(f"{k}: {v}\n" for k, v in cfg.items())
    fd, path = tempfile.mkstemp(suffix=".cfg")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        return load_cfg(path)
    finally:
        os.unlink(path)


def open_stream(config, seed: int, device):
    """A full-SLAM ``SdvlStream`` (on the card: one graph replay a frame)."""
    from sdvl_tpu_torch.pipeline.stream import SdvlStream

    return SdvlStream(config, seed=seed, device=device)


def fill_map(config, kf_poses, imgs, pts, obs_mask, obs_px):
    """A map of ``config``'s capacities on the device of ``imgs`` whose
    first slots hold the keyframes (poses (Kn, 7), their (Kn, H, W) views
    as the store's uint8 pyramids) and whose points are ``pts`` (P, 3),
    all valid, anchored at slot 0 and found 3 times, observed at
    ``obs_px`` where ``obs_mask``: the port's ``tools/zurich_scale_smoke.
    fill_map`` with the observations given."""
    from sdvl_tpu_torch.ops import pyramid
    from sdvl_tpu_torch.state.map_state import empty_map, store_pyramid

    s = config.sdvl
    Kn, H, W = imgs.shape
    dev = imgs.device
    m = empty_map(n_kf=s.max_keyframes, n_pts=s.max_points,
                  n_cand=s.max_candidates, img_shape=(H, W),
                  levels=s.pyramid_levels, device=dev)
    pyrs = store_pyramid(pyramid.build_pyramid(imgs.float(),
                                               s.pyramid_levels))

    def head(t, v):
        return torch.cat([v.to(t.dtype), t[Kn:]])

    P = pts.shape[0]
    return m._replace(
        kf_pose=head(m.kf_pose, kf_poses),
        kf_valid=head(m.kf_valid, torch.ones(Kn, dtype=torch.bool,
                                             device=dev)),
        kf_frame_id=head(m.kf_frame_id, torch.arange(Kn, device=dev)),
        kf_pyr=tuple(torch.cat([p, lvl[Kn:]])
                     for lvl, p in zip(m.kf_pyr, pyrs)),
        n_keyframes=torch.tensor(Kn, dtype=torch.int32, device=dev),
        pt_pos=pts.clone(),
        pt_valid=torch.ones(P, dtype=torch.bool, device=dev),
        pt_found=torch.full((P,), 3, dtype=torch.int32, device=dev),
        obs_mask=head(m.obs_mask, obs_mask),
        obs_px=head(m.obs_px, obs_px),
    )


def with_geometry(m, kf_poses, pts):
    """``m`` with the first keyframe poses and the points replaced."""
    Kn = kf_poses.shape[0]
    return m._replace(kf_pose=torch.cat([kf_poses.to(m.kf_pose.dtype),
                                         m.kf_pose[Kn:]]),
                      pt_pos=pts.to(m.pt_pos.dtype))


def intrinsics(config):
    from sdvl_tpu_torch.pipeline.config import intrinsics as intr

    return intr(config)


def global_ba(m, intr, stats: dict):
    """``mapper.global_ba(m, intr)`` as ``cli/run.py --global-ba`` calls
    it (its default ``stage_iters``; on the card one graph replay)."""
    from sdvl_tpu_torch.pipeline import mapper

    return mapper.global_ba(m, intr, stats=stats)


def counters(obj) -> dict:
    """The program's own counters of a stream: graph replays, capture
    seconds and pool bytes (summed over its graphs), and the detection
    kernel's device launch count."""
    runner = getattr(obj, "runner", obj)

    def total(v):
        if isinstance(v, dict):
            return sum(v.values()) if v else None
        return v

    out = dict(replays=total(runner.replays),
               capture_s=total(runner.capture_s),
               pool_bytes=total(runner.pool_bytes))
    if torch.cuda.is_available():
        from sdvl_tpu_torch.ops.cuda import detect

        out["detect_launches"] = int(detect.launches())
    return out


def map_snapshot(stream) -> dict:
    """The stream's map as the window left it, on the host: the valid
    keyframes' poses and frame numbers (frames counted from the first fed,
    from 0), the valid points' positions and the frame number of each
    point's anchor keyframe."""
    m = stream.m
    kf = m.kf_valid.cpu().numpy()
    frame = m.kf_frame_id.cpu().numpy()
    pt = m.pt_valid.cpu().numpy() & kf[m.pt_anchor_kf.cpu().numpy()]
    return dict(kf_pose=m.kf_pose.double().cpu().numpy()[kf],
                kf_frame=frame[kf].astype("int64"),
                pt_pos=m.pt_pos.double().cpu().numpy()[pt],
                pt_frame=frame[m.pt_anchor_kf.cpu().numpy()[pt]].astype(
                    "int64"))


def pack(info) -> torch.Tensor:
    """A step's ``FrameInfo`` (leaves with any leading axes) as one float32
    tensor (..., 10) on its device: pose 7, state, is_keyframe,
    n_matches."""
    return torch.cat([info.pose.float(), info.state.float()[..., None],
                      info.is_keyframe.float()[..., None],
                      info.n_matches.float()[..., None]], -1)


def free_device_state() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
