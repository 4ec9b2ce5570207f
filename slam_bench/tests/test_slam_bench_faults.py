"""A run with the timed path broken underneath comes out as not correct.

Each test skips the look for a card and drives the rest of a run, on the
CPU at a small size, with the program replaced by a stand-in: a sound one
(answers from the truth, in a world of its own), then one fault at a time:
a step that returns its state unchanged, half of the work left out, an
answer altered where it is produced, and, for a live map, a fifth to two
fifths of the frames lost or answered wrong, in one stretch or scattered,
and a map whose keyframes or points are wrong."""

import collections
import time

import numpy as np
import pytest
import torch

from slam_bench import drivers, program, reference, scene

Info = collections.namedtuple("Info", "pose state is_keyframe n_matches")
CPU = torch.device("cpu")


def info(poses, states):
    poses = torch.as_tensor(np.asarray(poses, np.float32))
    states = torch.as_tensor(np.asarray(states, np.int32))
    return Info(poses, states, torch.zeros_like(states, dtype=torch.bool),
                torch.full_like(states, 100))


def sim3_world(poses):
    """The poses in a world the truth's is carried into by a similarity
    (scale 2.5, a turn, a shift): what a monocular map answers."""
    Rc = scene.quat_to_matrix(poses[:, :4])
    Rn = Rc @ SIM_R.T
    tn = SIM_S * poses[:, 4:] - (Rn @ SIM_T)
    return np.concatenate([scene.matrix_to_quat(Rn), tn], -1)


SIM_R = scene.quat_to_matrix(np.array([0.9, 0.1, -0.3, 0.2]))
SIM_S, SIM_T = 2.5, np.array([1.0, -2.0, 0.5])


@pytest.fixture
def capture(monkeypatch):
    """What the drivers generate, kept for the stand-ins."""
    got = {}
    for name in ("live_inputs", "zurich_inputs"):
        real = getattr(drivers, name)

        def wrap(*a, _real=real, _name=name, **k):
            got[_name] = out = _real(*a, **k)
            return out

        monkeypatch.setattr(drivers, name, wrap)
    monkeypatch.setattr(program, "load_config", lambda cfg: None)
    return got


class FakeStream:
    """Answers from the truth in a world of its own; a keyframe every 10
    frames, each with 8 points on the plane in its view."""

    def __init__(self, got, fault):
        self.got, self.fault, self.i = got, fault, 0
        self.runner = type("R", (), dict(replays=0, capture_s=1.0,
                                         pool_bytes=0))()

    def feed(self, img):
        truth = sim3_world(self.got["live_inputs"]["poses"])
        i = self.i
        self.i += 1
        n = len(truth)
        state = 2
        if self.fault == "unchanged" and i > 20:
            i = 20
        pose = truth[i].copy()
        if self.fault == "altered":
            pose[4:] += 0.5 * (-1) ** i
        if self.fault == "lost_stretch" and 0.5 * n <= i < 0.8 * n:
            state = 3
        if self.fault == "lost_scattered" and i % 4 == 0:
            state = 3
        if self.fault == "wrong_stretch" and 0.5 * n <= i < 0.8 * n:
            pose[4:] += 0.25 * (-1) ** i
        return info(pose, state)

    def snapshot(self):
        inp = self.got["live_inputs"]
        frames = np.arange(0, self.i, 10)
        kf = sim3_world(inp["poses"][frames])
        if self.fault == "keyframes":
            kf[::3, 4:] += 0.3
        c = scene.centres(inp["poses"][frames])
        xy = c[:, None, :2] + np.linspace(-0.5, 0.5, 8)[None, :, None]
        pts = np.concatenate([xy, np.full(xy.shape[:2] + (1,),
                                          inp["plane"].z)], -1)
        if self.fault == "points":
            pts[..., 2] += 0.3 * (pts[..., 2] - c[:, None, 2])
        pts = SIM_S * pts @ SIM_R.T + SIM_T
        return dict(kf_pose=kf, kf_frame=frames, pt_pos=pts.reshape(-1, 3),
                    pt_frame=np.repeat(frames, 8))


@pytest.mark.parametrize("fault,correct", [
    (None, True), ("unchanged", False), ("altered", False),
    ("lost_stretch", False), ("lost_scattered", False),
    ("wrong_stretch", False), ("keyframes", False), ("points", False)])
def test_live_map(small_spec, capture, monkeypatch, fault, correct):
    spec = small_spec("tum_f1.map", 160, 128,
                      traffic=dict(frames=400, warmup_frames=20))
    spec["traffic"]["scene"]["texture"] = 256
    monkeypatch.setattr(program, "open_stream",
                        lambda cfg, seed, dev: FakeStream(capture, fault))
    monkeypatch.setattr(program, "map_snapshot", lambda st: st.snapshot())
    run = drivers.run_live(spec, 11, 30.0, 0, CPU, time.perf_counter())
    assert len(run.steps) == 380 and run.ran_out
    assert run.correct is correct, run.checks


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("unchanged", False),
                                           ("half", False),
                                           ("altered", False)])
def test_global_ba(small_spec, capture, monkeypatch, fault, correct):
    spec = small_spec("zurich.ba", 160, 128,
                      cfg={"SDVL.max_keyframes": 24,
                           "SDVL.max_points": 192},
                      traffic=dict(warmup_solves=0),
                      map=dict(keyframes=16, points=192))
    spec["traffic"]["scene"]["texture"] = 256
    monkeypatch.setattr(program, "intrinsics", lambda cfg: None)
    state = {}

    def fill(config, kf_poses, imgs, pts, seen, obs_px):
        return dict(kf_pose=kf_poses, pt_pos=pts)

    def geometry(m, poses, pts):
        return dict(kf_pose=poses, pt_pos=pts)

    def global_ba(m, intr, stats):
        stats["cg_iterations"] = torch.zeros(0, dtype=torch.int32)
        if fault == "unchanged":
            return collections.namedtuple("M", "kf_pose pt_pos")(
                m["kf_pose"], m["pt_pos"])
        if "prob" not in state:
            state["prob"] = drivers.ba_problem(capture["zurich_inputs"])
        p = state["prob"]
        out = reference.bundle_adjust(
            m["kf_pose"].numpy(), m["pt_pos"].numpy(), p["obs_uv"],
            p["mask"], p["fixed"], p["free_pts"], p["huber"],
            reference.Arith("float64"), (8, 12))
        poses = torch.as_tensor(out["poses"], dtype=torch.float32)
        if fault == "half":
            poses[len(poses) // 2:] = m["kf_pose"][len(poses) // 2:]
        if fault == "altered":
            poses[5, 4] += 0.01
        return collections.namedtuple("M", "kf_pose pt_pos")(
            poses, torch.as_tensor(out["points"], dtype=torch.float32))

    monkeypatch.setattr(program, "fill_map", fill)
    monkeypatch.setattr(program, "with_geometry", geometry)
    monkeypatch.setattr(program, "global_ba", global_ba)
    run = drivers.run_ba(spec, 13, 1.0, 0, CPU, time.perf_counter())
    assert run.correct is correct, run.checks
