"""Shared helpers of the ``test_torch_*`` files: data crossing between JAX
and the PyTorch port as numpy arrays, seeded test images, and the small
``PlaneScene`` mapping run both slice-level test files start from."""

from __future__ import annotations

import numpy as np
import torch

from make_torch_fixtures import (homography_gumbel, plane_gumbel,  # noqa: F401
                                 ransac_gumbel)  # (re-exported)


def T(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (uint32 widened to int64)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t if dtype is None else t.to(dtype)


def N(x) -> np.ndarray:
    """torch tensor (or tuple of them) -> numpy."""
    if isinstance(x, (tuple, list)):
        return [N(v) for v in x]
    return x.detach().cpu().numpy()


def blocky_image(seed=0, shape=(120, 160)) -> np.ndarray:
    """Noise plus bright rectangles: real corners on every pyramid level."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 50, shape).astype(np.float32)
    for _ in range(40):
        y = rng.integers(10, shape[0] - 20)
        x = rng.integers(10, shape[1] - 20)
        img[y:y + rng.integers(4, 12), x:x + rng.integers(4, 12)] += \
            rng.uniform(60, 150)
    return np.clip(img, 0, 255)


def smooth_image(seed=0, shape=(120, 160)) -> np.ndarray:
    """Band-limited texture with gradients everywhere (for the aligners)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.full(shape, 120.0, np.float32)
    for _ in range(12):
        fx, fy = rng.uniform(0.02, 0.25, 2)
        ph = rng.uniform(0, 2 * np.pi)
        img += rng.uniform(8, 25) * np.sin(xx * fx + yy * fy + ph)
    return np.clip(img, 0, 255).astype(np.float32)


def tree_to_numpy(tree) -> dict:
    """A JAX NamedTuple of arrays (MapState, SlamCarry) as a dict of numpy
    arrays; tuple fields stay tuples."""
    out = {}
    for name, val in tree._asdict().items():
        if isinstance(val, (tuple, list)):
            out[name] = tuple(np.asarray(v) for v in val)
        else:
            out[name] = np.asarray(val)
    return out


def small_scene(n=30):
    """The 320x240 PlaneScene set-up of the JAX localizer tests: configs
    for both packages (same numbers), the rendered frames, their poses."""
    from sdvl_tpu.io.synthetic import PlaneScene
    from sdvl_tpu.pipeline import config as jcfg
    from sdvl_tpu_torch.pipeline import config as tcfg

    scene = PlaneScene(fx=210.0, fy=210.0, cx=159.5, cy=119.5,
                       width=320, height=240, plane_z=4.0)
    cam = dict(width=320, height=240, fx=210.0, fy=210.0, u0=159.5,
               v0=119.5, dist=(0, 0, 0, 0, 0))
    sdvl = dict(cell_size=32, min_avg_shift=5.0, max_keyframes=10,
                min_keyframe_its=5, min_init_corners=30, max_points=512,
                max_candidates=256, min_matches=15, map_scale=4.0)
    cfg_j = jcfg.Config(camera=jcfg.CameraConfig(**cam),
                        sdvl=jcfg.SdvlConfig(**sdvl))
    cfg_t = tcfg.Config(camera=tcfg.CameraConfig(**cam),
                        sdvl=tcfg.SdvlConfig(**sdvl))
    poses_gt = scene.trajectory(n)
    frames = [scene.render(p) for p in poses_gt]
    return cfg_j, cfg_t, frames, poses_gt


def mapped_stream(n=30, extra=0):
    """Run the JAX SLAM stream over the first ``n`` frames of the small
    scene (``extra`` more are rendered but not fed). Returns
    (cfg_j, cfg_t, frames, poses_gt, slam) with ``slam`` the finished JAX
    ``SdvlStream`` (its ``m`` / ``carry`` are the map to hand over)."""
    from sdvl_tpu.pipeline.stream import SdvlStream

    cfg_j, cfg_t, frames, poses_gt = small_scene(n + extra)
    slam = SdvlStream(cfg_j, seed=0, donate=False)
    for f in frames[:n]:
        slam.feed(f)
    return cfg_j, cfg_t, frames, poses_gt, slam


def with_knobs(cfg, **knobs):
    """``cfg`` with ``knobs`` set on its ``sdvl`` section."""
    import dataclasses

    return dataclasses.replace(cfg, sdvl=dataclasses.replace(cfg.sdvl,
                                                             **knobs))


def jax_draws(cfg_t, key):
    """A port ``Draws`` holding the numbers a JAX stream whose carry holds
    ``key`` draws: pose-RANSAC noise of frame ``i`` of a fresh stream, and
    the bootstrap's homography and ground-plane noise."""
    import functools

    from sdvl_tpu_torch.pipeline.device_fsm import lane_counts
    from sdvl_tpu_torch.pipeline.stream import Draws

    s = cfg_t.sdvl
    n_corners, n_lanes = lane_counts(cfg_t)
    n_hyp = min(s.ransac_hypotheses, s.max_ransac_its)
    pose = functools.lru_cache(maxsize=None)(
        lambda i: ransac_gumbel(key, i, n_hyp, n_lanes))
    return Draws(pose=pose, homography=homography_gumbel(key, n_corners),
                 plane=plane_gumbel(key, s.max_points))


def slam_pair(cfg_j, cfg_t, frames, seed=0):
    """The JAX SLAM stream and the port's (CPU, fed the JAX draws) over the
    same frames, frame by frame. Returns (jax stream, jax result, port
    stream, port result)."""
    from sdvl_tpu.pipeline.stream import SdvlStream as JStream
    from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream

    js = JStream(cfg_j, seed=seed, donate=False)
    for f in frames:
        js.feed(f)
    rj = js.result()
    ts = TStream(cfg_t, seed=seed, device="cpu",
                 gumbel_provider=jax_draws(cfg_t, js.carry.key))
    for f in frames:
        ts.feed(f)
    return js, rj, ts, ts.result()
