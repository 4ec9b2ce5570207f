"""Shared helpers of the ``test_torch_*`` files: data crossing between JAX
and the PyTorch port as numpy arrays, seeded test images, and the small
``PlaneScene`` mapping run both slice-level test files start from."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest
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


def assert_info_like(info_t, info_j) -> None:
    """The port's ``FrameInfo`` (torch) has the reference's (JAX or numpy)
    leaves: the same fields, each of the same shape and dtype."""
    assert info_t._fields == info_j._fields
    for name, t, j in zip(info_t._fields, info_t, info_j):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, (name, tuple(t.shape), j.shape)
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, (
            name, t.dtype, j.dtype)


def assert_info_is_result(info, result, frames) -> None:
    """A returned ``FrameInfo`` (leading axis: frames) holds exactly the
    numbers ``result()`` reports for ``frames`` (a slice)."""
    got = {k: N(v) for k, v in info._asdict().items()}
    np.testing.assert_array_equal(got["pose"], result.poses_raw[frames])
    np.testing.assert_array_equal(got["state"], result.states[frames])
    for k in ("quality", "n_matches", "n_attempts", "is_keyframe",
              "n_corners", "median_shift"):
        np.testing.assert_array_equal(got[k], getattr(result, k)[frames])


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


def lane_counts_of(cfg_t):
    """(pose-RANSAC hypotheses, match lanes) of a port config: the shape of
    one frame's pose noise."""
    from sdvl_tpu_torch.pipeline.device_fsm import lane_counts

    s = cfg_t.sdvl
    return min(s.ransac_hypotheses, s.max_ransac_its), lane_counts(cfg_t)[1]


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


@contextlib.contextmanager
def detect_route(route: str):
    """The detection both packages take inside the block, for configs whose
    ``use_pallas_detect`` is set as :func:`with_route` sets it.

    ``"pallas"``: the JAX package's Pallas kernel in interpret mode (its own
    tests' CPU route) against the port's Pallas border rule (the kernel's
    plain version on CPU tensors). ``"plain"``: the JAX package's plain route
    against the port's plain border rule; nothing is patched."""
    import sdvl_tpu.ops.pallas.detect as pallas_detect

    mp = pytest.MonkeyPatch()
    try:
        if route == "pallas":
            mp.setattr(pallas_detect, "fast_shi_tomasi_map",
                       functools.partial(pallas_detect.fast_shi_tomasi_map,
                                         interpret=True))
        yield
    finally:
        mp.undo()


def with_route(cfg, route: str):
    """``cfg`` (either package's) with ``use_pallas_detect`` set for the
    detection ``route`` (``"pallas"`` or ``"plain"``)."""
    return with_knobs(cfg, use_pallas_detect=route == "pallas")


def slam_pair(cfg_j, cfg_t, frames, seed=0, route="pallas"):
    """The JAX SLAM stream and the port's (CPU, fed the JAX draws) over the
    same frames, frame by frame, both configs set to the detection
    ``route`` (:func:`with_route`, :func:`detect_route`). Returns (jax
    stream, jax result, port stream, port result)."""
    from sdvl_tpu.pipeline.stream import SdvlStream as JStream
    from sdvl_tpu_torch.pipeline.stream import SdvlStream as TStream

    cfg_j, cfg_t = with_route(cfg_j, route), with_route(cfg_t, route)
    with detect_route(route):
        js = JStream(cfg_j, seed=seed, donate=False)
        for f in frames:
            js.feed(f)
        rj = js.result()
        ts = TStream(cfg_t, seed=seed, device="cpu",
                     gumbel_provider=jax_draws(cfg_t, js.carry.key))
        for f in frames:
            ts.feed(f)
        return js, rj, ts, ts.result()


def synthetic_ba_problem(K, P, seed=0, noise=0.02, span=None):
    """The seeded BA problem of ``tests/test_scale.py``, as numpy arrays:
    exact unit-plane projections of P points from K cameras on a line, the
    first two cameras fixed, the other poses and the points perturbed.
    ``span`` (default K) scales the camera line to that many of the
    reference's steps: at K = 256 the reference's own line runs 20 units
    sideways and turns 0.5 rad, points come within 1e-4 of the camera
    planes, and the float32 solve becomes chaotic (the JAX package's own
    eager and jitted runs then end 0.07 apart). Returns (poses_init, fixed,
    points_init, obs_uv, obs_mask, poses_gt)."""
    import jax.numpy as jnp

    from sdvl_tpu.core import se3 as jse3

    rs = np.random.default_rng(seed)
    pts = rs.uniform([-3, -3, 4], [3, 3, 10], (P, 3)).astype(np.float32)
    step = (K if span is None else span) / K
    poses = np.stack([
        np.asarray(jse3.exp(jnp.asarray(
            [0.08 * k * step, 0.01 * k * step, 0.0, 0.0, 0.002 * k * step,
             0.0], jnp.float32)))
        for k in range(K)
    ])
    p_cam = np.asarray(jse3.transform(jnp.asarray(poses)[None, :],
                                      jnp.asarray(pts)[:, None]))
    uv = (p_cam[..., :2] / p_cam[..., 2:3]).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    poses_init = poses.copy()
    poses_init[~fixed, 4:] += rs.normal(0, noise, (K - 2, 3)).astype(
        np.float32)
    pts_init = pts + rs.normal(0, noise, (P, 3)).astype(np.float32)
    return (poses_init, fixed, pts_init, uv, np.ones((P, K), bool), poses)


GRAPH_STEP_SHAPE = (128, 160)


def graph_step_scene(n_scene=30, n_blank=6, **knobs):
    """The small full-SLAM sequence of the device-resident step's tests
    (port only, no JAX): a 128x160 ``PlaneScene`` whose stream bootstraps
    and inserts tracked keyframes, then ``n_blank`` featureless frames after
    frame 22 that send it LOST long enough for the relocalizer to sweep
    every keyframe. Returns (config, uint8 frames)."""
    from sdvl_tpu_torch.io.synthetic import PlaneScene
    from sdvl_tpu_torch.pipeline import config as tcfg

    H, W = GRAPH_STEP_SHAPE
    cam = dict(width=W, height=H, fx=105.0, fy=105.0, u0=79.5, v0=63.5,
               dist=(0, 0, 0, 0, 0))
    sdvl = dict(cell_size=16, min_avg_shift=3.0, max_keyframes=8,
                min_keyframe_its=4, min_init_corners=20, max_points=256,
                max_candidates=128, min_matches=10, map_scale=4.0,
                # two relocalization lanes, every keyframe after one more
                # failed LOST frame
                reloc_max_keyframes=2, reloc_escalate_after=1)
    sdvl.update(knobs)
    cfg = tcfg.Config(camera=tcfg.CameraConfig(**cam),
                      sdvl=tcfg.SdvlConfig(**sdvl))
    scene = PlaneScene(fx=105.0, fy=105.0, cx=79.5, cy=63.5, width=W,
                       height=H, plane_z=4.0)
    seq = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
           for p in scene.trajectory(n_scene, translation_amp=1.0)]
    blank = [np.full((H, W), 40 + 10 * i, np.uint8) for i in range(n_blank)]
    return cfg, seq[:22] + blank + seq[22:]


def jax_config(cfg_t):
    """The JAX package's ``Config`` with the numbers of the port's
    ``cfg_t``."""
    import dataclasses

    from sdvl_tpu.pipeline import config as jcfg

    return jcfg.Config(
        camera=jcfg.CameraConfig(**dataclasses.asdict(cfg_t.camera)),
        sdvl=jcfg.SdvlConfig(**dataclasses.asdict(cfg_t.sdvl)))


def jacobi_eigh_model(A, rounds, max_sweeps: int = 30):
    """float64 numpy model of ``csrc/small_eig.cu``'s ``eigh_kernel`` on
    (..., n, n) ``A`` (its lower triangle, mirrored) with the pairing
    schedule ``rounds`` (``small_eig.jacobi_rounds(n)``): in each round
    every pair's rotation from the round's A, the same skip test, then the
    row pass ``A <- J^T A`` of all rotated pairs, then the column pass
    ``A <- A J``, ``V <- V J`` with ``a_pq = a_qp = 0``; a matrix stops
    after a sweep in which no pair rotated, at most ``max_sweeps``. Every
    operation is one IEEE float64 operation, as the kernel's (built without
    multiply-add contraction). Returns (w, V, sweeps): w (batch, n)
    ascending with ties in index order, V (batch, n, n) its columns, and
    per matrix the sweeps run (-1 where ``max_sweeps`` did not suffice)."""
    A = np.asarray(A)
    n = A.shape[-1]
    flat = A.reshape(-1, n, n).astype(np.float64)
    a = np.tril(flat) + np.swapaxes(np.tril(flat, -1), 1, 2)
    v = np.broadcast_to(np.eye(n), a.shape).copy()
    sweeps = np.full(len(a), -1)
    for sweep in range(max_sweeps):
        rotated = np.zeros(len(a), bool)
        for pairs in np.asarray(rounds):
            rots = []
            for p, q in pairs:
                if q >= n:                  # the padding index
                    continue
                apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
                rot = ~((apq == 0.0)
                        | (np.abs(apq) <= 1e-15 * (np.abs(app) + np.abs(aqq))))
                with np.errstate(divide="ignore", invalid="ignore"):
                    theta = (aqq - app) / (2.0 * apq)
                    t = np.where(theta >= 0.0, 1.0, -1.0) / (
                        np.abs(theta) + np.sqrt(theta * theta + 1.0))
                    c = 1.0 / np.sqrt(t * t + 1.0)
                    s = t * c
                rots.append((p, q, rot[:, None], c[:, None], s[:, None]))
                rotated |= rot
            for p, q, rot, c, s in rots:    # row pass
                ap, aq = a[:, p, :].copy(), a[:, q, :].copy()
                a[:, p, :] = np.where(rot, c * ap - s * aq, ap)
                a[:, q, :] = np.where(rot, s * ap + c * aq, aq)
            for p, q, rot, c, s in rots:    # column pass
                for m in (a, v):
                    xp, xq = m[:, :, p].copy(), m[:, :, q].copy()
                    m[:, :, p] = np.where(rot, c * xp - s * xq, xp)
                    m[:, :, q] = np.where(rot, s * xp + c * xq, xq)
                r = rot[:, 0]
                a[r, p, q] = a[r, q, p] = 0.0
        sweeps[(sweeps < 0) & ~rotated] = sweep + 1
        if not rotated.any():
            break
    w = np.diagonal(a, axis1=1, axis2=2)
    order = np.argsort(w, axis=1, kind="stable")
    return (np.take_along_axis(w, order, 1),
            np.take_along_axis(v, order[:, None, :], 2), sweeps)


def jacobi_svd3_model(A, max_sweeps: int = 30):
    """float64 numpy model of ``csrc/small_eig.cu``'s ``svd3_kernel`` on
    (..., 3, 3) ``A``: one-sided Jacobi on the columns of B = A V, each
    sweep the pairs (0, 1), (0, 2), (1, 2) in turn with the kernel's
    rotation and skip test, until a sweep rotates none (at most
    ``max_sweeps``); the values B's column norms, ordered by the kernel's
    network of three exchanges (descending, ties in index order); U's
    columns B's normalised, or where a value is below ``1e-30 + 1e-13``
    of the largest the kernel's completion (e_0 for A = 0, a unit normal of
    u0 and its least axis for rank 1, u0 x u1 for rank 2). Every operation
    is one IEEE float64 operation, as the kernel's (built without
    multiply-add contraction). Returns (U, S, Vh, sweeps), U (batch, 3, 3),
    S (batch, 3), Vh (batch, 3, 3), and per matrix the sweeps run (-1
    where ``max_sweeps`` did not suffice)."""

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    flat = np.asarray(A).reshape(-1, 3, 3).astype(np.float64)
    n = len(flat)
    b = [flat[:, :, j].copy() for j in range(3)]
    v = [np.repeat(np.eye(3)[None, j], n, 0) for j in range(3)]
    sweeps = np.full(n, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        for sweep in range(max_sweeps):
            rotated = np.zeros(n, bool)
            for p, q in ((0, 1), (0, 2), (1, 2)):
                alpha, beta = dot(b[p], b[p]), dot(b[q], b[q])
                gamma = dot(b[p], b[q])
                rot = ~((gamma == 0.0)
                        | (gamma * gamma <= 1e-30 * (alpha * beta)))
                d = beta - alpha
                t = np.where(d >= 0.0, 2.0 * gamma, -2.0 * gamma) / (
                    np.abs(d) + np.sqrt(d * d + 4.0 * (gamma * gamma)))
                c = (1.0 / np.sqrt(1.0 + t * t))[:, None]
                s = c * t[:, None]
                for cols in (b, v):
                    xp, xq = cols[p], cols[q]
                    cols[p] = np.where(rot[:, None], c * xp - s * xq, xp)
                    cols[q] = np.where(rot[:, None], s * xp + c * xq, xq)
                rotated |= rot
            # a matrix whose sweep rotated nothing is left as it is
            sweeps[(sweeps < 0) & ~rotated] = sweep + 1
            if not rotated.any():
                break
        x = [[np.sqrt(dot(b[j], b[j])), b[j], v[j]] for j in range(3)]
        for hi, lo in ((0, 1), (1, 2), (0, 1)):
            swap = x[lo][0] > x[hi][0]
            for k in range(3):
                sw = swap if k == 0 else swap[:, None]
                x[hi][k], x[lo][k] = (np.where(sw, x[lo][k], x[hi][k]),
                                      np.where(sw, x[hi][k], x[lo][k]))
        (s0, b0, v0), (s1, b1, v1), (s2, b2, v2) = x
        tiny = 1e-30 + 1e-13 * s0
        u0 = np.where((s0 > tiny)[:, None], b0 / s0[:, None],
                      np.array([1.0, 0.0, 0.0]))
        a = np.abs(u0)
        least = np.where(a[:, 2] < np.where(a[:, 1] < a[:, 0], a[:, 1],
                                            a[:, 0]), 2,
                         np.where(a[:, 1] < a[:, 0], 1, 0))
        w = cross(u0, np.eye(3)[least])
        u1 = np.where((s1 > tiny)[:, None], b1 / s1[:, None],
                      w / np.sqrt(dot(w, w))[:, None])
        u2 = np.where((s2 > tiny)[:, None], b2 / s2[:, None], cross(u0, u1))
    return (np.stack([u0, u1, u2], 2), np.stack([s0, s1, s2], 1),
            np.stack([v0, v1, v2], 1), sweeps)


def svd3_cases(seed: int = 0) -> dict:
    """name -> (..., 3, 3) float32 numpy matrices for ``svd3``: Euclidean
    homographies of a plane (R + t n^T / d, what the bootstrap
    decomposes), ``chip_smoke.py``'s random homography, exact ties (values
    1, 1, 2 on the diagonal), ranks 0, 1 and 2, a near-degenerate matrix
    (values 1, 1 + 1e-7, 2) and 1000 random matrices."""
    rs = np.random.default_rng(seed)

    def rotation(w):
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        k = k / max(th, 1e-30)
        return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k

    homographies = []
    for _ in range(64):
        n = np.array([0.0, 0.0, -1.0]) + rs.normal(0, 0.1, 3)
        homographies.append(rotation(rs.normal(0, 0.05, 3))
                            + np.outer(rs.normal(0, 0.3, 3),
                                       n / np.linalg.norm(n)) / 4.0)
    q1, q2 = (np.linalg.qr(rs.normal(0, 1, (3, 3)))[0] for _ in range(2))
    cases = dict(
        homographies=np.stack(homographies),
        homography=np.eye(3) + np.random.default_rng(1).normal(0, 0.2,
                                                               (3, 3)),
        ties=np.diag([1.0, 1.0, 2.0]),
        rank_0=np.zeros((3, 3)),
        rank_1=np.outer(rs.normal(0, 1, 3), rs.normal(0, 1, 3)),
        rank_2=np.diag([2.0, 1.0, 0.0]) @ q1,
        near_degenerate=q1 @ np.diag([1.0, 1.0 + 1e-7, 2.0]) @ q2,
        batch_1000=rs.normal(0, 1, (1000, 3, 3)),
    )
    return {k: np.asarray(v, np.float32) for k, v in cases.items()}
