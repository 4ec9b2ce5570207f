"""Global BA's points at Zurich capacity: the port on the CPU held to the
reference's own spread.

Slow (``-m slow``; about 10 minutes on one core, most of it the port's
global BA over 1000 slots): tier-1 leaves it out, and its smaller twin
``tests/test_torch_zurich_scale.py`` (220 of 256 slots) runs there. Run it
with

    python -m pytest tests/test_torch_zurich_points.py -m slow -q -s

``tools/zurich_scale_smoke.py`` at its defaults: 320 of 1000 keyframe
slots filled with rendered 640x480 views, 4096 points, perturbed by the
JAX tool's draws, then global BA (PCG above ``CG_KF_THRESHOLD``, stage
iterations (4, 6)). ``tests/data/torch_zurich_record.npz``
(``tests/make_torch_fixtures.py --zurich-record``) holds the reference's
global BA twice on the same filled map and draws: jitted (``ba_*``) and op
by op (``ba_eager_*``: ``jax.disable_jit`` around the BA alone). Their
distance is the reference's own float32 spread at this size:

* points (Euclidean, per point): median 8.2e-5, 99th percentile 1.04e-4,
  largest 3.60e-3; the largest by the point's observations after BA: 0 for
  the 206 points seen by fewer than 2 keyframes (the BA leaves them out),
  3.60e-3 for the 8 seen by 2, 4.0e-4 for the 23 seen by 3-4, 1.16e-4,
  1.10e-4 and 1.04e-4 for 5-9, 10-19 and 20 or more;
* the filled slots' camera centres: largest 2.8e-5; gated observations
  equal.

The port on the CPU (its own filled map, fed the JAX draws) lands in the
same place: points median 8.2e-5, 99th percentile 1.04e-4, largest
3.59e-3 (seen by 2), 3.9e-4 (3-4), 1.18e-4 (5-9) from the jitted run;
centres 2.8e-5. Its distance to each reference run is the reference's
distance to itself, so the criterion is the one phase ``zurich`` holds
the card to (``chip_smoke.ZURICH_POINTS``): each point, at its distance
from the nearer of the reference's two runs, within the reference's own
largest distance among points seen by as many keyframes
(``zurich_scale_smoke.OBS_GROUPS``); the centres within the reference's
own largest distance from the nearer run, the gated observations equal to
the jitted run's.
"""

import json

import numpy as np
import pytest
import torch

from sdvl_tpu_torch.tools import zurich_scale_smoke as tz

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

RECORD = "tests/data/torch_zurich_record.npz"


@pytest.fixture(scope="module")
def run():
    rec = dict(np.load(RECORD))
    proto = json.loads(bytes(rec["protocol"]).decode())
    intr, _, _, m, _, sha = tz.build_map(
        proto["kf"], proto["pts"], proto["kf_cap"], proto["height"],
        proto["width"], "cpu", workers=0)
    assert sha == bytes(rec["kf_images_sha256"]).decode()
    ba = tz.run_global_ba(m, intr, torch.from_numpy(rec["pose_noise"]),
                          torch.from_numpy(rec["pt_noise"]),
                          proto["stage_iters"])
    return rec, proto, ba


def test_points_after_global_ba_within_the_references_own_spread(run):
    rec, proto, ba = run
    m = ba["map"]
    kf = proto["kf"]
    got = tz.spread_against(m.pt_pos.numpy(), m.kf_pose[:kf].numpy(),
                            np.packbits(m.obs_mask[:kf].numpy(), axis=1),
                            rec)
    print(json.dumps(got))
    assert got["own_obs_apart"] == 0 and got["obs_apart"] == 0, got
    assert not got["apart"], got["apart"]
    assert got["own"]["points"]["max_by_obs"]["2-2"] > 1e-3   # the spread
    assert abs(ba["e1"] - float(rec["reproj_px_after"])) < 1e-5
