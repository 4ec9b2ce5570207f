"""The port's capacity probe against the JAX tool's, below its scale.

``tools/capacity_probe.py``'s ``probe_one`` (its stream kept to read its
result) and the port's ``sdvl_tpu_torch.tools.capacity_probe.probe_one``
(CPU, fed the JAX stream's random draws) over the same frames: the tool's
preset-shaped configuration (ORB gate, 1000 features, 200 match lanes,
``min_avg_shift`` 10, ``min_keyframe_its`` 15, ``min_init_corners`` 40) at
320x240 with the focal lengths and principal point halved
(``probe_config(240, 320)``), 512 point and
256 candidate slots, 64 frames of ``trajectory(64, translation_amp=1.0)``
in chunks of 16 (the capture and bootstrap, two settling chunks, one timed).
Capacities 8 and 72: 72 is above ``reloc_max_keyframes`` (64), so the step
holds the relocalizer's escalation to every slot.

Tolerances: against the JAX run at K = 72, per-frame states and keyframe
flags equal, ``n_matches`` within 2 (``tests/test_torch_slam.py``'s bound)
and the trajectory within 1e-3. The port's two capacities against each
other: states and keyframe flags equal, ``n_matches`` within 2, camera
centres within 2e-3 of the trajectory's extent. Capacity moves float32
rounding after the third keyframe (frame 48) in the reference too: the JAX
package's own runs at K = 8 and 72 on these frames part by 1 match and by
camera centres 1.1e-3 of the extent apart (2.1e-3 of 1.95); the port's by
0 matches and 8.7e-4 of the extent. The port's record carries the JAX
tool's keys.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from sdvl_tpu.io.synthetic import PlaneScene
from sdvl_tpu.pipeline import stream as j_stream
from sdvl_tpu.pipeline import config as jcfg
from sdvl_tpu_torch.tools import capacity_probe as tp
from sdvl_tpu_torch.tools import zurich_scale_smoke as tz
from torch_port_helpers import jax_draws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
from tools import capacity_probe as jp  # noqa: E402

torch.set_num_threads(1)

KS = (8, 72)
N_FRAMES = 64


def small_config():
    """The port's probe configuration at 320x240 with 512 point and 256
    candidate slots and 72 keyframe slots, and its scene."""
    scene, cfg = tp.probe_config(240, 320)
    return scene, dataclasses.replace(cfg, sdvl=dataclasses.replace(
        cfg.sdvl, max_points=512, max_candidates=256, max_keyframes=KS[1]))


def _centres(poses) -> np.ndarray:
    return tz.camera_centres(torch.as_tensor(np.asarray(poses,
                                                        np.float32))).numpy()


def _fields(dc) -> dict:
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


@pytest.fixture(scope="module")
def runs():
    scene_t, cfg_t = small_config()
    scene = PlaneScene(fx=scene_t.fx, fy=scene_t.fy, cx=scene_t.cx,
                       cy=scene_t.cy, width=320, height=240, plane_z=4.0)
    poses = scene.trajectory(N_FRAMES, translation_amp=1.0)
    frames = [np.clip(scene.render(p), 0, 255).astype(np.uint8)
              for p in poses]
    cfg_j = jcfg.Config(camera=jcfg.CameraConfig(**_fields(cfg_t.camera)),
                        sdvl=jcfg.SdvlConfig(**_fields(cfg_t.sdvl)))
    streams = []
    feed = j_stream.SdvlStream.feed_chunk

    def kept(self, imgs, block=False):
        streams.append(self)
        return feed(self, imgs, block)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_stream.SdvlStream, "feed_chunk", kept)
    try:
        out_j = jp.probe_one(KS[1], frames, cfg_j)
    finally:
        mp.undo()
    js = streams[-1]
    rj = js.result()
    draws = jax_draws(cfg_t, js.carry.key)
    out_t = {k: tp.probe_one(k, frames, cfg_t, device="cpu",
                             gumbel_provider=draws) for k in KS}
    return dict(out_j=out_j, rj=rj, out_t=out_t, poses=np.stack(poses))


def test_probe_at_72_slots_equals_the_jax_tools(runs):
    rj, out = runs["rj"], runs["out_t"][KS[1]]
    assert rj.n_frames == out["frames"] == N_FRAMES
    # the reference bootstrapped, tracked and made keyframes
    assert (rj.states == 2).sum() >= N_FRAMES - 8
    assert rj.is_keyframe.sum() >= 2
    np.testing.assert_array_equal(out["states"], rj.states)
    np.testing.assert_array_equal(out["is_keyframe"],
                                  rj.is_keyframe.astype(int))
    assert np.abs(np.subtract(out["n_matches"], rj.n_matches)).max() <= 2
    np.testing.assert_allclose(out["poses"], rj.trajectory, rtol=0,
                               atol=1e-3)


def test_capacity_changes_nothing(runs):
    a, b = (runs["out_t"][k] for k in KS)
    for key in ("states", "is_keyframe"):
        assert a[key] == b[key], key
    assert np.abs(np.subtract(a["n_matches"], b["n_matches"])).max() <= 2
    centres = [_centres(r["poses"]) for r in (a, b)]
    gt = _centres(runs["poses"])
    extent = float(np.linalg.norm(np.ptp(gt, axis=0)))
    assert np.abs(centres[0] - centres[1]).max() <= 2e-3 * extent


def test_record_carries_the_jax_tools_keys(runs):
    for k in KS:
        out = runs["out_t"][k]
        assert set(runs["out_j"]) <= set(out), set(runs["out_j"]) - set(out)
        assert out["max_keyframes"] == k
        assert out["metric"] == "capacity_probe"
        # chunks of 16: the first (capture and bootstrap), 2 settling, 1
        # timed; on the CPU nothing replays
        assert out["replays_per_chunk"] == [0] * (N_FRAMES // tp.CHUNK)
        assert out["step_ms_per_frame"] > 0 and out["fps"] > 0
    mb = [runs["out_t"][k]["map_state_mb"] for k in KS]
    assert mb[1] > mb[0]
