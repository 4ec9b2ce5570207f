"""The port's async mapper (``pipeline/runtime.py``): mapping on a thread of
its own, the tracker reading the latest published map.

The two tests of ``tests/test_runtime_async.py`` on the port's ``SDVL``
(CPU, 320x240 ``PlaneScene``, the JAX draws, the interpreter switching
threads every 10 us), with their criteria: RUNNING
at the end, the mapper did work, at least 18 of 26 frames RUNNING, more
than 80 % of them with at least 15 matches, the map grew, ATE under 5 % of
the extent; and a mapper error surfaces on the tracker side.
"""

import sys
import time

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu_torch.io import evaluate
from sdvl_tpu_torch.pipeline.runtime import AsyncMapper
from sdvl_tpu_torch.pipeline.sdvl import SDVL, TrackingState
from torch_port_helpers import jax_draws, small_scene

torch.set_num_threads(1)


def test_async_tracks_like_sequential():
    _, cfg, frames, poses = small_scene(26)
    slam = SDVL(cfg, seed=0, device="cpu",
                gumbel_provider=jax_draws(cfg,
                                          np.asarray(jax.random.PRNGKey(0))))
    # switch threads often: more interleavings of map reads and publishes
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    mapper = AsyncMapper(slam)
    try:
        infos = [slam.handle_frame(img) for img in frames]
    finally:
        mapper.stop()
        sys.setswitchinterval(interval)
    assert not mapper.thread.is_alive()

    assert slam.state == TrackingState.RUNNING
    assert mapper.processed > 0
    running = [i for i, inf in enumerate(infos) if inf["state"] == "RUNNING"]
    assert len(running) >= 18
    n_matches = np.asarray([infos[i]["n_matches"] for i in running])
    assert (n_matches >= 15).mean() > 0.8, n_matches
    # the map grew through the async path
    assert int(slam.m.pt_valid.sum()) >= 30
    assert int(slam.m.kf_valid.sum()) >= 2

    est = np.stack([infos[i]["pose"] for i in running])
    gt = np.stack([poses[i] for i in running])
    ate = evaluate.ate_rmse(evaluate.positions_from_poses(est),
                            evaluate.positions_from_poses(gt),
                            with_scale=True)
    extent = float(np.linalg.norm(
        np.ptp(evaluate.positions_from_poses(gt), axis=0)))
    assert ate < 0.05 * max(extent, 1e-6), (ate, extent)


def test_mapper_error_propagates():
    """A crash on the mapper thread surfaces at the next tracker call, not
    a hang or nothing."""
    _, cfg, _, _ = small_scene(1)
    slam = SDVL(cfg, seed=0, device="cpu")
    mapper = AsyncMapper(slam)

    class Boom:
        kind = "frame"
        payload = (None, None, None)  # malformed -> the worker raises

    mapper.q.put(Boom())
    for _ in range(200):
        if mapper._exc is not None:
            break
        time.sleep(0.05)
    with pytest.raises(BaseException):
        mapper._check()
    mapper._stop.set()
    mapper.q.put(type("S", (), {"kind": "stop", "payload": ()})())
    mapper.thread.join(timeout=10)
    assert not mapper.thread.is_alive()
