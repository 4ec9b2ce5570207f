"""Map and trajectory figures (reference DrawScene equivalent).

Counterpart of ``sdvl_tpu/viz/scene.py``: the point cloud, keyframe
centres, the camera trail and the candidates' depth-uncertainty segments,
top-down, as matplotlib figures written to files. matplotlib is imported
when a figure is drawn; :func:`require_matplotlib` lets a caller fail before
a run starts rather than at its first figure.
"""

from __future__ import annotations

import numpy as np
import torch

from .overlay import host


def require_matplotlib() -> None:
    """Raise if matplotlib, which draws the map figures, is missing."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the map and trajectory figures of --viz need matplotlib, which "
            "is not installed") from e


def _cam_centers(poses_wc) -> np.ndarray:
    """World camera centres of world->camera poses (the port's SE3)."""
    from ..core import se3

    p = torch.from_numpy(np.array(host(poses_wc), np.float32))
    return se3.inverse(p)[..., 4:].numpy()


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(poses_wc, gt_poses_wc=None, path: str | None = None,
                    ax=None):
    """Top-down (x-z) trajectory plot; optionally overlays ground truth."""
    plt = _pyplot()
    own = ax is None
    if own:
        _, ax = plt.subplots(figsize=(6, 6))
    c = _cam_centers(np.stack(poses_wc))
    ax.plot(c[:, 0], c[:, 2], "-", lw=1.2, label="estimate")
    if gt_poses_wc is not None:
        g = _cam_centers(np.stack(gt_poses_wc))
        ax.plot(g[:, 0], g[:, 2], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if own and path:
        plt.savefig(path, dpi=120, bbox_inches="tight")
        plt.close()
    return ax


def candidate_segments(m, max_segments: int = 200):
    """World end points (n, 3) x 2 of the rho +- 2 sigma depth intervals of
    the first ``max_segments`` live candidates (drawscene.cc:103-121); the
    far end is capped at 10 / rho."""
    from ..core import se3

    cand_valid = host(m.cand_valid)
    idx = np.nonzero(cand_valid)[0][:max_segments]
    if not len(idx):
        return np.zeros((0, 3)), np.zeros((0, 3))
    rho = host(m.cand_rho)[idx]
    sig = np.sqrt(host(m.cand_sigma2)[idx])
    z_near = 1.0 / np.maximum(rho + 2 * sig, 1e-6)
    z_far = np.minimum(1.0 / np.maximum(rho - 2 * sig, 1e-6),
                       10.0 / np.maximum(rho, 1e-6))
    bear = host(m.cand_bearing)[idx]
    T_w_a = se3.inverse(torch.from_numpy(
        host(m.kf_pose)[host(m.cand_kf)[idx]].astype(np.float32)))

    def world(z):
        return se3.transform(T_w_a, torch.from_numpy(
            (bear * z[:, None]).astype(np.float32))).numpy()

    return world(z_near), world(z_far)


def plot_map(m, trajectory=None, path: str | None = None,
             max_uncertainty_segments: int = 200):
    """3D-ish map figure: points, keyframe centres, camera trail, and
    rho +- 2 sigma depth-uncertainty segments for live candidates
    (drawscene.cc:103-121). ``m`` may live on any device: its fields are
    copied to the host here."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    pts = host(m.pt_pos)[host(m.pt_valid)]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=2, c="#444444", label="points")

    kf_centers = _cam_centers(host(m.kf_pose))[host(m.kf_valid)]
    if len(kf_centers):
        ax.scatter(kf_centers[:, 0], kf_centers[:, 2], marker="s", s=28,
                   c="tab:blue", label="keyframes")

    if trajectory is not None and len(trajectory):
        c = _cam_centers(np.stack([p for _, p in trajectory]))
        ax.plot(c[:, 0], c[:, 2], "-", lw=1.0, c="tab:green", label="trail")

    for pn, pf in zip(*candidate_segments(m, max_uncertainty_segments)):
        ax.plot([pn[0], pf[0]], [pn[2], pf[2]], "-", lw=0.5,
                c="tab:orange", alpha=0.5)

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if path:
        plt.savefig(path, dpi=120, bbox_inches="tight")
        plt.close()
    return ax
