"""Two processes on ``torch.distributed`` (gloo): the port's
``dist/multihost.py`` bring-up, the point-sharded BA across ranks and
``MultiStream`` with its streams split over a ``stream`` mesh axis.

This file is also the worker: ``python tests/test_torch_multihost.py RANK
PORT OUT`` joins a 2-process group at ``127.0.0.1:PORT``, solves
``multihost.demo_ba_problem`` with 128 points per rank (Cholesky and PCG),
runs 2 SLAM streams at 160x128 over 10 frames with one stream per rank, and
rank 0 writes what it gathered to ``OUT``. The test starts both ranks (a
free port from the OS; a 120 s limit on each process), then computes the
same in one process and compares. Only the port is imported, JAX nowhere.

Tolerances: the sharded BA against the one-process solve at
``tests/test_dist.py``'s (poses 5e-4, points 5e-3, chi2 1e-3 relative: the
two sums add the shards in other orders); the streams exactly (each rank
runs its stream's own operations on the CPU).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

N_FRAMES = 10
HUBER = float(np.sqrt(5.991) / 420.0)
METHODS = ("chol", "cg")


def _config():
    from sdvl_tpu_torch.pipeline.config import (CameraConfig, Config,
                                                SdvlConfig)

    return Config(
        camera=CameraConfig(width=160, height=128, fx=120.0, fy=120.0,
                            u0=79.5, v0=63.5, dist=(0, 0, 0, 0, 0)),
        sdvl=SdvlConfig(cell_size=16, min_avg_shift=3.0, max_keyframes=6,
                        min_keyframe_its=5, min_init_corners=15,
                        min_matches=8, max_points=256, max_candidates=64,
                        map_scale=4.0))


def _batches():
    from sdvl_tpu_torch.io.synthetic import PlaneScene

    scene = PlaneScene(fx=120.0, fy=120.0, cx=79.5, cy=63.5, width=160,
                       height=128, plane_z=4.0)
    seqs = [[scene.render(p) for p in
             scene.trajectory(N_FRAMES, translation_amp=1.0 + 0.3 * i)]
            for i in range(2)]
    return np.stack([np.stack(f) for f in zip(*seqs)])     # (T, 2, H, W)


def _run(mesh_point=None, mesh_stream=None) -> dict:
    """The BA solves and the 2 streams, on the meshes (or in one
    process); returns whole results as numpy arrays."""
    from sdvl_tpu_torch.dist import ba_sharded, multihost
    from sdvl_tpu_torch.dist.multi_stream import MultiStream
    from sdvl_tpu_torch.solvers import ba

    out = {}
    # the CPU on every rank (gloo) and in the one-process reference
    problem = multihost.demo_ba_problem(device="cpu")
    for method in METHODS:
        if mesh_point is None:
            r = ba.solve(problem, huber=HUBER, method=method)
        else:
            r = ba_sharded.solve_sharded(problem, mesh_point, huber=HUBER,
                                         method=method)
        out.update({f"{method}_poses": r.poses.numpy(),
                    f"{method}_points": r.points.numpy(),
                    f"{method}_chi2": float(r.chi2)})
    ms = MultiStream(_config(), 2, seed=0, device="cpu", mesh=mesh_stream)
    out["local_streams"] = np.asarray(list(ms.local))
    ms.feed_chunk(_batches())
    for i, r in enumerate(ms.result()):
        out[f"states{i}"] = r.states
        out[f"trajectory{i}"] = r.trajectory
        out[f"n_matches{i}"] = r.n_matches
    return out


def _worker(rank: int, port: int, out_path: str) -> int:
    import torch.distributed as dist

    from sdvl_tpu_torch.dist import multihost

    torch.set_num_threads(1)
    assert multihost.initialize(f"127.0.0.1:{port}", 2, rank,
                                backend="gloo") == "gloo"
    try:
        assert multihost.process_count() == 2
        got = _run(multihost.global_mesh("point"),
                   multihost.global_mesh("stream"))
        if rank == 0:
            np.savez(out_path, **got)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(tmp_path):
    torch.set_num_threads(1)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
    port = _free_port()
    out = str(tmp_path / "rank0.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    got = dict(np.load(out))
    want = _run()
    assert got["local_streams"].tolist() == [0]     # rank 0's one stream
    for m in METHODS:
        np.testing.assert_allclose(got[f"{m}_poses"], want[f"{m}_poses"],
                                   atol=5e-4)
        np.testing.assert_allclose(got[f"{m}_points"], want[f"{m}_points"],
                                   atol=5e-3)
        assert abs(float(got[f"{m}_chi2"]) - want[f"{m}_chi2"]) < 1e-3 * max(
            want[f"{m}_chi2"], 1.0)
    for i in range(2):
        for k in ("states", "trajectory", "n_matches"):
            np.testing.assert_array_equal(got[f"{k}{i}"], want[f"{k}{i}"])
    assert (want["states1"] == 2).any()


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))


def test_initialize_defaults_to_the_card_and_never_falls_back():
    """``backend=None`` is nccl on the card: without one it raises the
    error ``require_device`` gives, and does not pick gloo on its own."""
    import torch.distributed as dist

    from sdvl_tpu_torch.dist import multihost

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nccl would start")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        multihost.initialize("127.0.0.1:1", 1, 0, backend=None)
    assert not dist.is_initialized()
