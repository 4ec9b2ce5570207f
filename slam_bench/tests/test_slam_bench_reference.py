"""The reference against the port at a small size on the CPU, and the
control failing there.

The port's whole-map BA (its dense path below 200 slots) and its serving
and map-building streams run through the drivers as a run does; the
reference judges them and passes them. The reference put in their place at
the precision below comes out as not correct."""

import time

import numpy as np
import pytest
import torch

from slam_bench import control, drivers, reference

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ba_spec(small_spec):
    return small_spec("zurich.ba", 160, 128,
                      cfg={"SDVL.max_keyframes": 24,
                           "SDVL.max_points": 256,
                           "SDVL.max_candidates": 8},
                      traffic=dict(warmup_solves=1),
                      map=dict(keyframes=16, points=256))


def test_global_ba_port_passes(small_spec):
    spec = ba_spec(small_spec)
    spec["traffic"]["scene"]["texture"] = 256
    run = drivers.run_ba(spec, 2 ** 31 + 11, 2.0, 0, CPU,
                         time.perf_counter())
    assert len(run.steps) >= 2
    assert run.correct, run.checks


@pytest.mark.parametrize("precision", ["tf32", "bfloat16"])
def test_global_ba_control_fails(small_spec, precision):
    spec = ba_spec(small_spec)
    ck = control.checks(spec, 2 ** 31 + 12, None, CPU, precision)
    assert not all(v <= lim for v, lim in ck.values()), ck


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11,
                      3.0])
    assert reference.tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0, 3.0]
    y = torch.randn(1000)
    assert torch.equal(reference.round_mantissa(y, 7),
                       y.to(torch.bfloat16).float())


def test_alignment_recovers_a_similarity():
    """A run's poses in a world of their own read as the truth."""
    from slam_bench import scene

    truth = scene.sweep(120, 4.0, 1, 0.4, 0.06, 90.0, 0.2, (0.1, 0.2, 0.3))
    R = scene.quat_to_matrix(np.array([0.9, 0.1, -0.3, 0.2]))
    s, t = 0.3, np.array([1.0, -2.0, 0.5])
    Rc = scene.quat_to_matrix(truth[:, :4])
    moved = np.concatenate([scene.matrix_to_quat(Rc @ R.T),
                            s * truth[:, 4:] - (Rc @ R.T @ t)], -1)
    cam = scene.Camera(517.3, 516.5, 318.6, 255.3, 640, 480)
    pts = scene.Plane(None, 12.0, 4.0).grid_points(64)
    px = reference.blockwise_px(moved, truth, np.ones(120, bool), pts, cam,
                                60)
    assert np.nanmax(px) < 1e-6


def test_map_building_port_passes(small_spec, monkeypatch):
    spec = small_spec("tum_f1.map", 320, 240,
                      cfg={"SDVL.max_keyframes": 30},
                      traffic=dict(warmup_frames=60))
    spec["traffic"]["scene"]["texture"] = 1024
    # depth from pixels half the size is half as sharp
    spec["traffic"]["check"]["limits"]["pt_depth_pct_p50"] *= 2
    # a window of 100 frames, whatever the CPU's pace: keyframes come one
    # in 30 at this size, and the map's numbers need two in the window
    loop = drivers.timed_loop
    monkeypatch.setattr(drivers, "timed_loop", lambda run, s, n, *a: loop(
        run, 1e9, min(n, 100), *a))
    run = drivers.run_live(spec, 3, 10.0, 0, CPU, time.perf_counter())
    assert len(run.steps) == 100 and run.failed == 0
    assert run.correct, run.checks


def test_map_building_control_fails(small_spec):
    """The reference aligns each frame to the rendered plane: in float64
    it reads a thousandth of a pixel. Answering each frame with the pose
    of the frame before, as the control does, is not correct."""
    spec = small_spec("tum_f1.map", 320, 240)
    ok = control.checks(spec, 5, 40, CPU, "float64", "own")
    assert ok["px_p50"][0] < 0.01, ok
    ck = control.checks(spec, 5, 40, CPU)
    assert not all(v <= lim for v, lim in ck.values()), ck
