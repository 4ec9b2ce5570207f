"""The plain reference that decides ``correct``: plain torch and numpy, and
nothing of the program.

* A pose's error is read in pixels: the mean distance, at the focal length,
  between where a grid of points on the plane projects under the pose and
  under the pose the frame was rendered from (:func:`pose_px`).
* A monocular map lives in a world of its own; :func:`align` finds the
  similarity that carries the truth into it, block by block of frames, so
  the slow drift of a long run does not read as an error of each frame.
* :func:`align_images` is the reference in the tracker's place: each
  frame's pose by Gauss-Newton on the photometric error between the frame
  and the textured plane rendered at the pose, from the previous frame's.
  :func:`bundle_adjust` is the reference in global BA's place: two-stage
  Levenberg-Marquardt with Huber weights, the gate between the stages and
  the gauge of two fixed keyframes, reduced to the cameras by the Schur
  complement and solved densely.

Both run in float64 as the reference. As the control, global BA runs at
the precision below the program's (float32 with TF32 off): float32 with
every matrix product's operands rounded to TF32's 10 mantissa bits. The
image alignment reads no worse in TF32 than the program does, so its
control breaks the guarantee that the map-building configuration states
instead: it answers each frame with the pose of the frame before
(``slam_bench/control.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .scene import matrix_to_quat as _quat


# ---------------------------------------------------------------- precision
def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to ``bits`` stored mantissa bits, to nearest
    even: 10 for TF32, 7 for bfloat16."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    r = (i + (1 << (drop - 1)) - 1 + ((i >> drop) & 1)) & ~((1 << drop) - 1)
    return r.view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    return round_mantissa(x, 10)


class Arith:
    """The precision of a reference run: ``"float64"``, ``"float32"``, or
    float32 storage with every matrix product's operands rounded to
    ``"tf32"`` (10 mantissa bits) or ``"bfloat16"`` (7), accumulated in
    float32, as the tensor cores compute them."""

    BITS = {"tf32": 10, "bfloat16": 7}

    def __init__(self, name: str):
        if name not in ("float64", "float32") and name not in self.BITS:
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name in self.BITS:
            bits = self.BITS[self.name]
            return round_mantissa(a, bits) @ round_mantissa(b, bits)
        return a @ b

    def t(self, x, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 3, 3) by Rodrigues."""
    th = w.norm(dim=-1, keepdim=True)[..., None]
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 2] = -w[..., 0]
    K = K - K.transpose(-1, -2)
    small = th < 1e-10
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(ths)) / (ths * ths))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


# ------------------------------------------------------------ pose in px
def in_view(truth, pts, cam) -> tuple:
    """Normalized projections (n, m, 2) of ``pts`` under ``truth`` and
    which of them the true camera sees (in front, inside the image)."""
    from .scene import project

    uv, z = project(np.asarray(truth, np.float64), pts)
    x0, x1 = -cam.cx / cam.fx, (cam.width - 1 - cam.cx) / cam.fx
    y0, y1 = -cam.cy / cam.fy, (cam.height - 1 - cam.cy) / cam.fy
    seen = ((z > 1e-3) & (uv[..., 0] >= x0) & (uv[..., 0] <= x1)
            & (uv[..., 1] >= y0) & (uv[..., 1] <= y1))
    return uv, seen


def pose_px(poses, truth, pts, cam) -> np.ndarray:
    """Per pose, the mean distance in pixels (at the focal length fx)
    between ``pts`` (world, (m, 3)) projected under ``poses`` and under
    ``truth`` ((n, 7) each), over the points the true camera sees;
    float64 (inf where a pose puts a seen point behind the camera)."""
    from .scene import project

    est, z = project(np.asarray(poses, np.float64), pts)
    ref, seen = in_view(truth, pts, cam)
    d = np.linalg.norm(est - ref, axis=-1) * cam.fx
    d = np.where(z > 1e-6, d, np.inf)
    return np.where(seen, d, 0).sum(1) / np.maximum(seen.sum(1), 1)


def align(truth: np.ndarray, poses: np.ndarray) -> tuple:
    """Similarity (s, R, t) that carries the truth's world into the world
    of ``poses`` (x' = s R x + t), from the same frames' true and estimated
    world->camera poses: R from the orientations (R = Rc'^T Rc for every
    frame, averaged and projected onto SO(3), which needs no motion), then
    s and t by least squares on the camera centres."""
    from .scene import centres, quat_to_matrix

    Rt = quat_to_matrix(truth[:, :4])
    Rp = quat_to_matrix(poses[:, :4])
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", Rp, Rt))
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    R = U @ D @ Vt
    c, cp = centres(truth), centres(poses)
    a, b = c - c.mean(0), cp - cp.mean(0)
    var = (a * a).sum()
    s = float((b * (a @ R.T)).sum() / var) if var > 0 else 1.0
    if not s > 0:
        s = 1.0
    return s, R, cp.mean(0) - s * R @ c.mean(0)


def to_truth_world(poses: np.ndarray, sim: tuple) -> np.ndarray:
    """World->camera poses of a world that ``sim`` = (s, R, t) maps the
    truth into, re-expressed as world->camera poses of the truth's world
    (translation in the truth's units)."""
    from .scene import matrix_to_quat, quat_to_matrix

    s, R, t = sim
    Rc = quat_to_matrix(poses[:, :4])                     # world' -> cam
    Rn = Rc @ R                                           # truth -> cam
    tn = ((Rc @ t) + poses[:, 4:]) / s
    return np.concatenate([matrix_to_quat(Rn), tn], -1)


def blockwise_px(poses, truth, ok, pts, cam, block: int) -> np.ndarray:
    """:func:`pose_px` of a monocular run's poses, each block of ``block``
    frames carried into the truth's world by the similarity that fits its
    poses (:func:`align`, frames with ``ok``); NaN where not ``ok``."""
    poses, truth = np.asarray(poses, np.float64), np.asarray(truth,
                                                              np.float64)
    out = np.full(len(poses), np.nan)
    for s in range(0, len(poses), block):
        sel = np.arange(s, min(s + block, len(poses)))
        sel = sel[ok[sel]]
        if len(sel) < 4:
            continue
        sim = align(truth[sel], poses[sel])
        out[sel] = pose_px(to_truth_world(poses[sel], sim), truth[sel], pts,
                           cam)
    return out


def map_errors(snap: dict, truth, pts, cam, plane_z: float) -> dict:
    """A monocular map against the truth. Its keyframes carried into the
    truth's world by the similarity that fits them (:func:`align`): the
    largest keyframe pose error in pixels (:func:`pose_px`) against the
    frame it was made from (``truth`` is indexed by frame number). Each
    point, carried by the same similarity: the error of its depth along
    the ray from its anchor keyframe's true camera centre, against where
    the ray meets the plane, in % of that depth; their median. inf where
    the map has fewer than 2 keyframes or no point."""
    from .scene import centres

    frames = snap["kf_frame"]
    if len(frames) < 2 or len(snap["pt_pos"]) == 0:
        return dict(kf_px_max=np.inf, pt_depth_pct_p50=np.inf)
    tr = np.asarray(truth, np.float64)[frames]
    poses = np.asarray(snap["kf_pose"], np.float64)
    sim = align(tr, poses)
    kf_px = pose_px(to_truth_world(poses, sim), tr, pts, cam)
    s, R, t = sim
    x = (np.asarray(snap["pt_pos"], np.float64) - t) @ R / s
    c = centres(np.asarray(truth, np.float64)[snap["pt_frame"]])
    d = x - c
    dist = np.linalg.norm(d, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        along = (plane_z - c[:, 2]) * dist / d[:, 2]
        err = np.where(along > 0, 100.0 * np.abs(dist - along) / along,
                       np.inf)
    err = np.where(np.isnan(err), np.inf, err)
    return dict(kf_px_max=float(np.max(kf_px)),
                pt_depth_pct_p50=rank(err, 50))


def triangulated_map(poses, frames, truth, pts, cam) -> dict:
    """A map made from keyframe ``poses`` (n, 7) of ``frames``: each grid
    point that the true cameras of two consecutive keyframes both see,
    matched where it truly projects in each, triangulated from the two
    poses (the midpoint of the closest approach of the two rays), anchored
    at the first. The reference's mapping in the program's place."""
    from .scene import centres, quat_to_matrix

    truth = np.asarray(truth, np.float64)
    poses = np.asarray(poses, np.float64)
    R = quat_to_matrix(poses[:, :4])
    c = centres(poses)
    out, anchor = [np.zeros((0, 3))], [np.zeros(0, np.int64)]
    for a in range(len(frames) - 1):
        b = a + 1
        uv, seen = in_view(truth[[frames[a], frames[b]]], pts, cam)
        both = seen[0] & seen[1]
        ray = [np.concatenate([uv[k][both], np.ones((both.sum(), 1))], -1)
               @ R[j] for k, j in ((0, a), (1, b))]
        ray = [r / np.linalg.norm(r, axis=-1, keepdims=True) for r in ray]
        w = c[a] - c[b]
        bb = (ray[0] * ray[1]).sum(-1)
        d, e = ray[0] @ w, ray[1] @ w
        den = np.maximum(1.0 - bb * bb, 1e-12)
        sa, sb = (bb * e - d) / den, (e - bb * d) / den
        out.append(0.5 * (c[a] + sa[:, None] * ray[0]
                          + c[b] + sb[:, None] * ray[1]))
        anchor.append(np.full(both.sum(), frames[a], np.int64))
    return dict(kf_pose=poses, kf_frame=np.asarray(frames),
                pt_pos=np.concatenate(out), pt_frame=np.concatenate(anchor))


def rank(values, q: float) -> float:
    """The ``q``-th percentile by the nearest rank (inf stays inf)."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return float("inf")
    return float(v[max(0, int(np.ceil(q / 100 * v.size)) - 1)])


# ------------------------------------------------------- image alignment
def _residual(R, t, rays, img, tex, extent, z, arith):
    """Rendered minus observed intensity at the sampled pixels, for the
    world->camera pose (R, t): each pixel's ray meets the plane, the
    texture is read there as the renderer reads it; and which pixels see
    the plane."""
    rw = arith.mm(rays, R)                             # rays in the world
    c = -(R.T @ t)                                     # camera centre
    s = (z - c[2]) / torch.where(rw[:, 2].abs() < 1e-9,
                                 torch.full_like(rw[:, 2], 1e-9), rw[:, 2])
    pw = c[:2] + s[:, None] * rw[:, :2]
    grid = (pw / extent).float().reshape(1, 1, -1, 2)
    val = torch.nn.functional.grid_sample(
        tex[None, None], grid, mode="bilinear", padding_mode="reflection",
        align_corners=True)[0, 0, 0]
    return val.to(img.dtype) - img, s > 0


def align_images(poses0, frames, tex, extent: float, z: float, cam,
                 arith: Arith, iters: int = 10, stride: int = 4,
                 step: float = 1e-4) -> np.ndarray:
    """The reference in the tracker's place: each frame's pose by
    Gauss-Newton on the photometric error between the frame and the
    textured plane rendered at the pose (every ``stride``-th pixel, central
    differences of ``step`` for the Jacobian, a step halved until the
    error falls), from the previous frame's answer (the first from
    ``poses0[0]``). (n, 7) poses, float64."""
    from .scene import quat_to_matrix

    dev = tex.device
    rays = cam.rays(dev)[::stride, ::stride].reshape(-1, 3).to(arith.dtype)
    tex = tex.to(torch.float32)
    R = torch.as_tensor(quat_to_matrix(np.asarray(poses0[0, :4])),
                        dtype=arith.dtype, device=dev)
    t = torch.as_tensor(np.asarray(poses0[0, 4:]), dtype=arith.dtype,
                        device=dev)
    eye = torch.eye(6, dtype=arith.dtype, device=dev) * step

    def cost(R, t, img):
        r, ok = _residual(R, t, rays, img, tex, extent, z, arith)
        return r, ok, (r[ok].double() ** 2).mean()

    out = np.empty((len(frames), 7))
    for i, frame in enumerate(frames):
        img = torch.as_tensor(np.asarray(frame)[::stride, ::stride],
                              device=dev).reshape(-1).to(arith.dtype)
        r, ok, c = cost(R, t, img)
        for _ in range(iters):
            cols = []
            for e in eye:
                rp, _ = _residual(so3_exp(e[3:]) @ R, t + e[:3], rays, img,
                                  tex, extent, z, arith)
                rm, _ = _residual(so3_exp(-e[3:]) @ R, t - e[:3], rays, img,
                                  tex, extent, z, arith)
                cols.append((rp - rm) / (2 * step))
            J = torch.stack(cols, 1)[ok]
            d = torch.linalg.solve((J.T @ J).double(),
                                   (J.T @ r[ok]).double()).to(arith.dtype)
            for _ in range(4):
                Rn, tn = so3_exp(-d[3:]) @ R, t - d[:3]
                rn, okn, cn = cost(Rn, tn, img)
                if cn < c:
                    R, t, r, ok, c = Rn, tn, rn, okn, cn
                    break
                d = d / 2
            else:
                break
        out[i, :4] = _quat(R.double().cpu().numpy())
        out[i, 4:] = t.double().cpu().numpy()
    return out


# ---------------------------------------------------------------- global BA
def _ba_terms(R, t, X, obs, w_mask, arith):
    """Residuals r (K, P, 2) = projection - observation, camera points
    (K, P, 3) and the front-of-camera mask folded into the weights."""
    pc = arith.mm(X[None], R.transpose(1, 2)) + t[:, None]
    z = pc[..., 2:]
    front = z[..., 0] > 1e-4
    zs = torch.where(front[..., None], z, torch.ones_like(z))
    r = pc[..., :2] / zs - obs
    return r, pc, w_mask * front


def robust_cost(r, w, huber: float) -> torch.Tensor:
    """Huber cost of residuals ``r`` (unit plane) under weights ``w``: the
    program's ``solvers/ba._robust_chi2``."""
    n2 = (r * r).sum(-1)
    n = n2.clamp_min(0).sqrt()
    rho = torch.where(n <= huber, n2, 2 * huber * n - huber * huber)
    return (rho * w).sum()


def bundle_adjust(poses, points, obs_uv, mask, fixed, free_pts, huber,
                  arith: Arith, stage_iters=(12, 24), device="cpu") -> dict:
    """Two-stage Levenberg-Marquardt on world->camera ``poses`` (K, 7) and
    ``points`` (P, 3) against unit-plane observations ``obs_uv`` (K, P, 2)
    where ``mask`` (K, P): Huber IRLS weights at ``huber``; slots ``fixed``
    and points not ``free_pts`` held; a step taken only where the cost
    falls; between the stages, observations whose squared error exceeds
    huber^2 or that lie behind the camera dropped. Returns poses, points
    (float64 numpy) and the stage-2 observation mask."""
    from .scene import quat_to_matrix

    dt, dev = arith.dtype, device
    R = torch.as_tensor(quat_to_matrix(np.asarray(poses)[:, :4]), dtype=dt,
                        device=dev)
    t = torch.as_tensor(np.asarray(poses)[:, 4:], dtype=dt, device=dev)
    X = torch.as_tensor(np.asarray(points), dtype=dt, device=dev)
    obs = torch.as_tensor(np.asarray(obs_uv), dtype=dt, device=dev)
    w_mask = torch.as_tensor(np.asarray(mask), dtype=dt, device=dev)
    free_c = ~torch.as_tensor(np.asarray(fixed), device=dev)
    free_p = torch.as_tensor(np.asarray(free_pts), device=dev)
    K, P = w_mask.shape

    def cost(R, t, X, wm):
        r, _, w = _ba_terms(R, t, X, obs, wm, arith)
        return robust_cost(r, w, huber)

    def stage(R, t, X, wm, iters):
        lam = 1e-4
        c0 = cost(R, t, X, wm)
        for _ in range(iters):
            r, pc, w = _ba_terms(R, t, X, obs, wm, arith)
            n = r.norm(dim=-1)
            w = w * torch.where(n <= huber, torch.ones_like(n),
                                huber / n.clamp_min(1e-12))
            z = pc[..., 2:]
            zs = torch.where(z.abs() > 1e-4, z, torch.ones_like(z))
            Jz = torch.zeros(pc.shape[:2] + (2, 3), dtype=dt, device=dev)
            Jz[..., 0, 0] = Jz[..., 1, 1] = 1 / zs[..., 0]
            Jz[..., :, 2] = -pc[..., :2] / (zs * zs)
            Jc = torch.cat([Jz, -Jz @ skew(pc - t[:, None])], -1)  # (K,P,2,6)
            Jx = Jz @ R[:, None]                                  # (K,P,2,3)
            Jc = Jc * free_c[:, None, None, None]
            Jx = Jx * free_p[None, :, None, None]
            wr = w[..., None, None]
            U = (Jc.transpose(-1, -2) @ (wr * Jc)).sum(1)         # (K,6,6)
            V = (Jx.transpose(-1, -2) @ (wr * Jx)).sum(0)         # (P,3,3)
            Wm = Jc.transpose(-1, -2) @ (wr * Jx)                 # (K,P,6,3)
            bc = (Jc.transpose(-1, -2) @ (wr * r[..., None])).sum(1)[..., 0]
            bp = (Jx.transpose(-1, -2) @ (wr * r[..., None])).sum(0)[..., 0]
            eye3 = torch.eye(3, dtype=dt, device=dev)
            eye6 = torch.eye(6, dtype=dt, device=dev)
            Vd = V + lam * (V * eye3) + (~free_p)[:, None, None] * eye3
            Ud = U + lam * (U * eye6) + (~free_c)[:, None, None] * eye6
            Vinv = torch.linalg.inv(Vd.double()).to(dt)
            Y = Wm @ Vinv[None]                                   # (K,P,6,3)
            S = -arith.mm(Y.permute(0, 2, 1, 3).reshape(K * 6, P * 3),
                          Wm.permute(1, 3, 0, 2).reshape(P * 3, K * 6))
            S = S.reshape(K, 6, K, 6)
            S[torch.arange(K), :, torch.arange(K)] += Ud
            rhs = bc - (Y @ bp[None, :, :, None]).sum(1)[..., 0]
            dc = torch.linalg.solve(S.reshape(K * 6, K * 6).double(),
                                    rhs.reshape(-1).double()).to(dt)
            dc = dc.reshape(K, 6) * free_c[:, None]
            dp = (Vinv @ (bp - (Wm.transpose(-1, -2)
                                @ dc[:, None, :, None]).sum(0)[..., 0]
                          )[..., None])[..., 0] * free_p[:, None]
            Rn = so3_exp(-dc[:, 3:]) @ R
            tn = t - dc[:, :3]
            Xn = X - dp
            c1 = cost(Rn, tn, Xn, wm)
            if c1 < c0:
                R, t, X, c0, lam = Rn, tn, Xn, c1, max(lam * 0.5, 1e-9)
            else:
                lam = min(lam * 4.0, 1e3)
        return R, t, X

    R, t, X = stage(R, t, X, w_mask, stage_iters[0])
    r, pc, _ = _ba_terms(R, t, X, obs, w_mask, arith)
    keep = ((r * r).sum(-1) < huber * huber) & (pc[..., 2] > 1e-4)
    w2 = w_mask * keep
    R, t, X = stage(R, t, X, w2, stage_iters[1])
    q = _quat(R.double().cpu().numpy())
    return dict(poses=np.concatenate([q, t.double().cpu().numpy()], -1),
                points=X.double().cpu().numpy(),
                mask=(w2 > 0).cpu().numpy())


def ba_cost(poses, points, obs_uv, mask, huber, device="cpu") -> float:
    """Huber cost, in float64, of a BA answer over ``mask``."""
    from .scene import quat_to_matrix

    a = Arith("float64")
    R = torch.as_tensor(quat_to_matrix(np.asarray(poses)[:, :4]),
                        device=device)
    t = a.t(np.asarray(poses)[:, 4:], device)
    X = a.t(points, device)
    r, _, w = _ba_terms(R, t, X, a.t(obs_uv, device),
                        a.t(np.asarray(mask, np.float64), device), a)
    return float(robust_cost(r, w, huber))
