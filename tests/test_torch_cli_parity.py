"""The port's command-line program against the JAX package's, run for run.

``sdvl_tpu.cli.run.main`` and ``sdvl_tpu_torch.cli.run.main`` (``--device
cpu``) run the same 320x240 ``PlaneScene`` frames, written as binary PGM
files with a ``files.txt``, under the same ``.cfg``: the stream driver and
the host driver, each with ``--global-ba --output``. The port's drivers are
fed the random draws the JAX drivers derive from their key, and the JAX
program detects with its Pallas kernel in interpret mode (the config sets
``use_pallas_detect``, which the port reads and ignores), the route the
port's detection kernel ports (as in ``tests/test_torch_host_fsm.py``), so
both programs make the same decisions.

Tolerances: summary key sets equal; per-frame states and keyframe flags (from
the per-frame log lines) equal; the TUM files after global BA and the
trajectory rebase within 1e-3 (the host driver's criterion against JAX: the
ground-plane rotation amplifies float32 differences of the bootstrap, see
``tests/test_torch_slam.py``).
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from sdvl_tpu.cli import run as jrun
from sdvl_tpu_torch.cli import run as trun
from sdvl_tpu_torch.pipeline import sdvl as tsdvl
from sdvl_tpu_torch.pipeline import stream as tstream
from torch_port_helpers import detect_route, jax_draws

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
    cfg = tmp / "pallas.cfg"
    cfg.write_text(open(seq["cfg"]).read() + "SDVL.use_pallas_detect: 1\n")
    flags = ["--config", str(cfg), "--images", seq["dir"], "--global-ba"]
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
        with detect_route("pallas"):
            # the JAX side decodes without its native loader, which would
            # build into the repository's native/
            lj = _main(jrun.main, flags + ["--no-native-loader", "--output",
                                           str(tmp / "jax.txt")])
            lt = _main(trun.main, flags + ["--device", "cpu", "--output",
                                           str(tmp / "port.txt")])
    finally:
        mp.undo()
    return dict(lj=lj, lt=lt, tj=np.loadtxt(tmp / "jax.txt"),
                tt=np.loadtxt(tmp / "port.txt"))


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


def test_same_states_and_keyframes(both):
    fj, ft = _frames(both["lj"]), _frames(both["lt"])
    assert len(fj) == N_FRAMES
    assert ft == fj
    assert fj[-1][0] == "RUNNING" and sum(kf for _, kf in fj) >= 2


def test_same_trajectory_after_global_ba(both):
    tj, tt = both["tj"], both["tt"]
    assert tt.shape == tj.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    np.testing.assert_allclose(tt[:, 1:4], tj[:, 1:4], atol=1e-3)
    # a unit quaternion and its negation are one rotation
    q_t, q_j = tt[:, 4:], tj[:, 4:]
    sign = np.sign(np.sum(q_t * q_j, axis=1, keepdims=True))
    np.testing.assert_allclose(q_t * sign, q_j, atol=1e-3)
