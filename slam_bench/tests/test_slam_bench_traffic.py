"""Each generator is a function of the seed: the same seed gives the same
inputs, another seed other inputs of the same sizes and amount of work."""

import numpy as np
import torch

from slam_bench import drivers, scene
from slam_bench.tests.conftest import spec_of as spec


def test_seed_words():
    assert scene.seed_int(5, 1) == scene.seed_int(5, 1)
    assert len({scene.seed_int(s, 1) for s in (0, 1, -1, 2 ** 31 + 7,
                                               2 ** 70)}) == 5
    assert scene.seed_int(5, -1) != scene.seed_int(5, 1)


def test_texture_is_seeded():
    a = scene.texture(256, scene.seeded(9, 1), "cpu")
    b = scene.texture(256, scene.seeded(9, 1), "cpu")
    c = scene.texture(256, scene.seeded(10, 1), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 255 and a.std() > 20


def test_live_map_trajectory():
    s = spec("tum_f1.map")
    a = drivers.live_inputs(s, 2 ** 31 + 3, "cpu", render=False)["poses"]
    b = drivers.live_inputs(s, 2 ** 31 + 3, "cpu", render=False)["poses"]
    c = drivers.live_inputs(s, 4, "cpu", render=False)["poses"]
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == c.shape == (s["traffic"]["frames"], 7)
    # the same sweep, other phases: the same path length to within 2 %
    la, lc = (np.linalg.norm(np.diff(scene.centres(p), axis=0),
                             axis=1).sum() for p in (a, c))
    assert abs(la - lc) / la < 0.02


def test_live_map_moves_at_fr1_xyz_speed():
    """The sweep after its ramp at 30 frames/s: TUM fr1/xyz's published
    mean velocities, 0.244 m/s and 8.920 deg/s, within 2 %."""
    s = spec("tum_f1.map")
    for seed in (1, 2 ** 31 + 3):
        p = drivers.live_inputs(s, seed, "cpu", render=False)["poses"]
        p = p[s["traffic"]["trajectory"]["ramp"]:]
        R = scene.quat_to_matrix(p[:, :4])
        cos = (np.trace(np.einsum("nji,njk->nik", R[:-1], R[1:]), axis1=1,
                        axis2=2) - 1) / 2
        deg_s = np.degrees(np.arccos(np.clip(cos, -1, 1))).mean() * 30
        m_s = np.linalg.norm(np.diff(scene.centres(p), axis=0),
                             axis=1).mean() * 30
        assert abs(deg_s / 8.920 - 1) < 0.02 and abs(m_s / 0.244 - 1) < 0.02


def test_zurich_map():
    s = spec("zurich.ba")
    za = drivers.zurich_inputs(s, 77, "cpu", render=False)
    zb = drivers.zurich_inputs(s, 77, "cpu", render=False)
    assert np.array_equal(za["kf_poses"], zb["kf_poses"])
    assert torch.equal(za["pts"], zb["pts"])
    assert torch.equal(za["seen"], zb["seen"])
    assert za["seen"].shape == (320, 4096)
    # the mix fixes one map for every seed, at the cfg's own intrinsics
    zc = drivers.zurich_inputs(s, 78, "cpu", render=False)
    assert torch.equal(za["pts"], zc["pts"])
    assert za["cam"].fx == s["config"]["cfg"]["Camera.fx"]
    assert not any(za["cam"].dist)


def test_ba_draws():
    s = spec("zurich.ba")
    z = drivers.zurich_inputs(s, 5, "cpu", render=False)
    p1, x1 = drivers.ba_draw(s, z, 5, 3, "cpu")
    p2, x2 = drivers.ba_draw(s, z, 5, 3, "cpu")
    p3, _ = drivers.ba_draw(s, z, 5, 4, "cpu")
    assert np.array_equal(p1, p2) and torch.equal(x1, x2)
    assert not np.array_equal(p1, p3)
    # every seed works through the same pool, in an order of its own
    pool = s["traffic"]["perturb"]["pool"]
    first = [drivers.ba_draw(s, z, 5, k, "cpu")[0][5, 4] for k in range(pool)]
    other = [drivers.ba_draw(s, z, 6, k, "cpu")[0][5, 4] for k in range(pool)]
    assert sorted(first) == sorted(other) and first != other
    # the gauge: the two oldest keyframes are not perturbed
    assert np.allclose(p1[:2], z["kf_poses"][:2], atol=1e-6)
