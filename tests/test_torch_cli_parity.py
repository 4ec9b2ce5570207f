"""The port's command-line program against the JAX package's, run for run.

``sdvl_tpu.cli.run.main`` and ``sdvl_tpu_torch.cli.run.main`` (``--device
cpu``) run the same 320x240 ``PlaneScene`` frames, written as binary PGM
files with a ``files.txt``, under the same ``.cfg``: the stream driver and
the host driver, each with ``--global-ba --output --viz``. The port's
drivers are fed the random draws the JAX drivers derive from their key. The
config is the sequence's as written (``use_pallas_detect`` unset, as in
every shipped config), so both programs take the reference's plain
detection route and make the same decisions.

Tolerances: summary key sets equal; per-frame states and keyframe flags (from
the per-frame log lines) equal; the TUM files after global BA and the
trajectory rebase within 1e-3 (the host driver's criterion against JAX, see
``tests/test_torch_slam.py``) once one rotation of the world frame is taken
out: its yaw about world z, which must be a rotation about z (other
components under 1e-4) of at most 3e-3 rad. That yaw is float32 noise of the
reference itself. The ground-plane alignment maps the plane normal, nearly
antiparallel to z (in-plane part 0.026 long on this sequence), onto z by the
minimal rotation, whose axis -- so the world's yaw -- turns with the normal's
in-plane direction; and the two-view triangulation that seeds the plane's
points solves float32 normal equations of near-parallel rays, so the seeded
points carry the summation order's rounding. The witness is the reference
against itself: its host driver with the bootstrap evaluated op by op
(``jax.disable_jit``, another summation order, nothing else changed) turns
its world 2.35e-3 rad about z and moves its TUM file 1.4e-3 from the
reference run (``tests/test_torch_cli_witness.py``).
The port against the reference: 2.09e-3 rad, 1.19e-3 before the yaw is
taken out (measured on this sequence, both drivers).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu.cli import run as jrun
from sdvl_tpu_torch.cli import run as trun
from sdvl_tpu_torch.pipeline import sdvl as tsdvl
from sdvl_tpu_torch.pipeline import stream as tstream
from torch_port_helpers import jax_draws

from test_torch_cli import N_FRAMES, seq  # noqa: F401 (seq: a fixture)

torch.set_num_threads(1)

KEY = np.asarray(jax.random.PRNGKey(0))   # both JAX drivers' key (seed 0)


def _main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _frames(lines):
    """(state, keyframe flag) per frame from the per-frame log lines."""
    return [(ln.split()[3], ln.endswith("[KF]")) for ln in lines
            if ln.startswith("[INFO] frame ")]


def _summary(lines):
    got = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(got) == 1, lines
    return got[0]


@pytest.fixture(scope="module", params=["stream", "host"])
def both(request, seq, tmp_path_factory):
    """Both programs over the sequence with one driver; the port's driver
    classes are swapped for ones fed the JAX draws."""
    tmp = tmp_path_factory.mktemp(request.param)
    flags = ["--config", seq["cfg"], "--images", seq["dir"], "--global-ba"]
    if request.param == "stream":
        flags.append("--stream")

    class Stream(tstream.SdvlStream):
        def __init__(self, config, seed=0, device="cuda",
                     gumbel_provider=None):
            super().__init__(config, seed, device,
                             gumbel_provider or jax_draws(config, KEY))

    class Host(tsdvl.SDVL):
        def __init__(self, config, seed=0, device="cuda", tracer=None,
                     gumbel_provider=None):
            super().__init__(config, seed, device, tracer,
                             gumbel_provider or jax_draws(config, KEY))

    mp = pytest.MonkeyPatch()
    mp.setattr(tstream, "SdvlStream", Stream)
    mp.setattr(tsdvl, "SDVL", Host)
    try:
        # the JAX side decodes without its native loader, which would
        # build into the repository's native/
        lj = _main(jrun.main, flags + ["--no-native-loader", "--output",
                                       str(tmp / "jax.txt"), "--viz",
                                       str(tmp / "viz_jax"), "--viz-every",
                                       "10"])
        lt = _main(trun.main, flags + ["--device", "cpu", "--output",
                                       str(tmp / "port.txt"), "--viz",
                                       str(tmp / "viz_port"), "--viz-every",
                                       "10"])
    finally:
        mp.undo()
    return dict(lj=lj, lt=lt, tj=np.loadtxt(tmp / "jax.txt"),
                tt=np.loadtxt(tmp / "port.txt"),
                viz=[sorted(os.listdir(tmp / d))
                     for d in ("viz_jax", "viz_port")])


def test_same_summary_keys_and_log_lines(both):
    sj, st = _summary(both["lj"]), _summary(both["lt"])
    assert set(st) == set(sj)
    assert st["frames"] == sj["frames"] == N_FRAMES
    assert st["keyframes"] == sj["keyframes"] >= 2
    tags = ("global BA over ", "trajectory written to ")
    for tag in tags:
        assert sum(tag in ln for ln in both["lt"]) == 1
        assert sum(tag in ln for ln in both["lj"]) == 1
    # "[INFO] global BA over K keyframes / P points": the same keyframes
    n_kf = [[ln.split("/")[0] for ln in lines if "global BA over " in ln]
            for lines in (both["lj"], both["lt"])]
    assert n_kf[0] == n_kf[1]


def test_same_viz_files(both):
    """``--viz DIR --viz-every 10`` writes the same PNG files (overlays,
    map figures; after the run, for the stream driver)."""
    names_j, names_t = both["viz"]
    assert names_t == names_j
    assert any(n.startswith("map_") for n in names_t)
    assert any(n.startswith("frame_") for n in names_t)


def test_same_states_and_keyframes(both):
    fj, ft = _frames(both["lj"]), _frames(both["lt"])
    assert len(fj) == N_FRAMES
    assert ft == fj
    assert fj[-1][0] == "RUNNING" and sum(kf for _, kf in fj) >= 2


def _rotations(q):
    """TUM quaternions (qx qy qz qw), (N, 4) -> rotation matrices (N, 3, 3)."""
    x, y, z, w = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1),
    ], 1)


def _world_yaw(tj, tt):
    """The rotation between the two runs' world frames (JAX from port, mean
    over frames of R_j R_t^T) as an axis-angle vector."""
    D = np.einsum("nij,nkj->ik", _rotations(tj[:, 4:]), _rotations(tt[:, 4:]))
    u, _, vt = np.linalg.svd(D)
    R = u @ vt
    angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return axis / max(np.linalg.norm(axis), 1e-12) * angle, R


def _assert_same_up_to_world_yaw(ta, tb):
    """TUM files ``ta`` and ``tb`` agree within 1e-3 once ``tb``'s world is
    turned onto ``ta``'s by the yaw between them, a rotation about z of at
    most 3e-3 rad. Returns the yaw."""
    assert ta.shape == tb.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(tb[:, 0], ta[:, 0])
    rotvec, _ = _world_yaw(ta, tb)
    assert abs(rotvec[2]) < 3e-3, rotvec
    assert np.abs(rotvec[:2]).max() < 1e-4, rotvec    # a yaw about z only
    yaw = np.array([[np.cos(rotvec[2]), -np.sin(rotvec[2]), 0.0],
                    [np.sin(rotvec[2]), np.cos(rotvec[2]), 0.0],
                    [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(tb[:, 1:4] @ yaw.T, ta[:, 1:4], atol=1e-3)
    # ``tb``'s orientations turned by the same yaw (quaternion product
    # q_yaw * q_b, TUM order qx qy qz qw); a unit quaternion and its
    # negation are one rotation
    s, c = np.sin(rotvec[2] / 2), np.cos(rotvec[2] / 2)
    x, y, z, w = tb[:, 4:].T
    q_b = np.stack([c * x - s * y, c * y + s * x, c * z + s * w,
                    c * w - s * z], 1)
    q_a = ta[:, 4:]
    sign = np.sign(np.sum(q_b * q_a, axis=1, keepdims=True))
    np.testing.assert_allclose(q_b * sign, q_a, atol=1e-3)
    return rotvec[2]


def test_same_trajectory_after_global_ba(both):
    _assert_same_up_to_world_yaw(both["tj"], both["tt"])
