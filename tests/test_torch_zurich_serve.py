"""The Zurich tool's serving phase in the port against the JAX package's.

``tools/zurich_scale_smoke.py:175-277`` composed from ``sdvl_tpu`` functions
(``tests/make_torch_fixtures.py``: ``jax_zurich_fill``, ``jax_zurich_serve``)
and the port's ``sdvl_tpu_torch.tools.zurich_scale_smoke.serve_smoke`` (CPU,
fed the JAX stream's random draws) over the same filled map: 256 keyframe
slots, 220 of them filled, 512 plane points, at 320x240 (at 160x128 a
frame has fewer match lanes than ``min_matches``, so serving could never
track), the focal lengths and principal point scaled with the width. The
localize-only stream starts LOST near keyframe 8, takes the relocalization
step twice (sent LOST again in between), then 8 frames one ``feed`` each,
a first chunk of 8 and 2 chunks of 8 (the first fed again, as the tool
does); the standalone relocalizer runs at 16, 64 and 240 lanes (240 is
above the filled count and below the capacity: every valid keyframe, the
nearest-lane sort over a store with empty slots).

Tolerances: per-frame states and keyframe flags equal, ``n_matches``
within 2 (``tests/test_torch_localize.py``'s bound: a match on a threshold
may flip under another float32 rounding; measured: 2 of the 34 frames 1
match apart), poses within 1e-3 on 90 % of the frames and within 5e-3 on
all (``tests/test_torch_slam_long.py``'s bounds: each frame's Gauss-Newton
starts from the last one's result, so rounding carries over; measured: 1
frame of 34 at 1.3e-3, the others under 8.5e-4). The
standalone relocalizer: the selected lane sets equal but for keyframes
whose keys (``-distance + 1e-6 * frame id``) lie within 1e-6 of the key at
the cut (float32 distances from each package's ``se3.inverse`` can swap
such neighbours); the chosen keyframe equal and its pose within 1e-5
(measured 6e-8). The warm step is taken by the runner the cold step made:
the LOST carry is written in place, not adopted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_torch_fixtures import (jax_zurich_fill, jax_zurich_serve,
                                 query_frames, serve_config_jax)
from sdvl_tpu.core import se3 as jse3
from sdvl_tpu_torch.core import se3 as tse3
from sdvl_tpu_torch.io.snapshot import map_from_numpy
from sdvl_tpu_torch.tools import zurich_scale_smoke as tz
from torch_port_helpers import N, jax_draws, tree_to_numpy

torch.set_num_threads(1)

KF_CAP, KF, PTS, H, W = 256, 220, 512, 240, 320
LANES = (16, 64, 240)
PHASE = dict(chunk=8, steady=8, n_chunks=2)


@pytest.fixture(scope="module")
def run():
    intr_j, scene_j, mj, kf_poses, _ = jax_zurich_fill(KF_CAP, KF, PTS, H, W,
                                                       5)
    q = query_frames(scene_j, kf_poses, n=1 + max(
        PHASE["steady"], PHASE["chunk"] * PHASE["n_chunks"]))
    cfg_j = serve_config_jax(H, W, KF_CAP, PTS)
    js, rj, lanes_j = jax_zurich_serve(cfg_j, mj, intr_j, kf_poses, q,
                                       lanes=LANES, **PHASE)
    intr, _, cfg = tz.zurich_config(H, W, KF_CAP, PTS)
    mt = map_from_numpy(tree_to_numpy(mj), "cpu")
    runners = []

    def on_feed(stream, feed):
        runners.append(stream.runner)
        feed()

    stats, rt, lanes_t = tz.serve_smoke(
        mt, intr, cfg, kf_poses, q, device="cpu",
        gumbel_provider=jax_draws(cfg, js.carry.key), lanes=LANES,
        on_feed=on_feed, **PHASE)
    return dict(mj=tree_to_numpy(mj), mt=mt, kf_poses=kf_poses, rj=rj,
                rt=rt, stats=stats, lanes_j=lanes_j, lanes_t=lanes_t,
                runners=runners)


def test_serving_frames_equal_the_jax_runs(run):
    rj, rt = run["rj"], run["rt"]
    n = 2 + PHASE["steady"] + PHASE["chunk"] * (1 + PHASE["n_chunks"])
    assert rj.n_frames == rt.n_frames == n
    # relocalized on the first frame and tracking, in the reference too
    assert rj.states[0] == 2 and (rj.states == 2).mean() > 0.9
    np.testing.assert_array_equal(rt.states, rj.states)
    np.testing.assert_array_equal(rt.is_keyframe, rj.is_keyframe)
    assert np.abs(rt.n_matches - rj.n_matches).max() <= 2
    d = np.abs(rt.poses_raw - rj.poses_raw).max(axis=1)
    assert (d <= 1e-3).mean() >= 0.9 and d.max() <= 5e-3, d
    s = run["stats"]
    assert s["serve_relocalized"] and s["serve_final_state"] == "RUNNING"
    assert s["serve_tracked_frames"] == int((rj.states == 2).sum())
    assert s["serve_frames"] == n


def test_warm_reloc_step_runs_on_the_cold_steps_runner(run):
    runners = run["runners"]
    # cold and warm reloc steps, the steady feeds, the chunks
    assert len(runners) == 2 + PHASE["steady"] + 1 + PHASE["n_chunks"]
    assert all(r is runners[0] for r in runners)
    # the filled map is the stream's own storage, untouched by serving
    for name in ("kf_pose", "obs_mask", "pt_pos"):
        np.testing.assert_array_equal(N(getattr(run["mt"], name)),
                                      run["mj"][name])


def _keys(centres, guess_c, valid, frame_id):
    d = np.sqrt(np.sum((centres - guess_c) ** 2, axis=-1))
    return np.where(valid, -d + np.float32(1e-6) * frame_id.astype(
        np.float32), -np.inf).astype(np.float32)


@pytest.mark.parametrize("lanes", LANES)
def test_standalone_relocalizer_equals_the_jax_one(run, lanes):
    mj, kf_poses = run["mj"], run["kf_poses"]
    guess = kf_poses[8]
    # each package's keys, as its relocalize computes them
    kj = np.asarray(jnp.where(
        mj["kf_valid"],
        -jnp.linalg.norm(jse3.translation(jse3.inverse(jnp.asarray(
            mj["kf_pose"]))) - jse3.translation(jse3.inverse(jnp.asarray(
                guess))), axis=-1)
        + 1e-6 * jnp.asarray(mj["kf_frame_id"]).astype(jnp.float32),
        -jnp.inf))
    m = run["mt"]
    kt = _keys(N(tse3.translation(tse3.inverse(m.kf_pose))),
               N(tse3.translation(tse3.inverse(torch.from_numpy(guess)))),
               N(m.kf_valid), N(m.kf_frame_id))
    sel_j = np.asarray(jax.lax.top_k(jnp.asarray(kj), lanes)[1])
    sel_t = np.argsort(-kt, kind="stable")[:lanes]
    cut = kj[sel_j[-1]]
    near_cut = (set(np.flatnonzero(np.abs(kj - cut) <= 1e-6))
                if np.isfinite(cut) else set())
    assert set(sel_j) - near_cut == set(sel_t) - near_cut
    assert len(near_cut) < lanes
    if lanes > KF:
        assert set(sel_t) >= set(range(KF))
    rj, rt = run["lanes_j"][lanes], run["lanes_t"][lanes]
    assert int(rt.kf) == int(rj["kf"])
    assert np.isfinite(rj["error"])
    np.testing.assert_allclose(N(rt.pose), rj["pose"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(rt.error), float(rj["error"]),
                               rtol=1e-3)
