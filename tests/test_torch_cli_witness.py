"""The reference's command-line program against itself: the witness for the
world yaw that ``tests/test_torch_cli_parity.py`` takes out of its
comparison.

``sdvl_tpu.cli.run.main`` runs the host driver with ``--global-ba`` over the
parity test's sequence twice: as shipped, and with its two-view bootstrap
evaluated op by op (``jax.disable_jit``) -- the same program and numbers
under another float32 summation order. The bootstrap triangulates the seed
points from near-parallel rays by float32 normal equations, so the orders
leave the points apart, and the ground-plane alignment turns that into a
yaw of the world about z.

Criteria: the two runs differ by more than 1e-3 rad of world yaw (measured
2.35e-3; their TUM files 1.4e-3 apart, over the parity test's 1e-3) and
pass the parity test's comparison, a yaw about z of at most 3e-3 rad
taken out, then 1e-3.
"""

import contextlib
import io

import jax
import numpy as np
import pytest

from sdvl_tpu.cli import run as jrun
from sdvl_tpu.pipeline import sdvl as jsdvl
from test_torch_cli_parity import _assert_same_up_to_world_yaw

from test_torch_cli import seq  # noqa: F401 (a fixture)


def _run(seq, out):
    with contextlib.redirect_stdout(io.StringIO()):
        assert jrun.main(["--config", seq["cfg"], "--images", seq["dir"],
                          "--global-ba", "--no-native-loader", "--output",
                          str(out)]) == 0
    return np.loadtxt(out)


def test_reference_against_itself_differs_by_a_world_yaw(seq, tmp_path):
    shipped = _run(seq, tmp_path / "shipped.txt")
    build = jsdvl.SDVL._build_jits

    def build_op_by_op(self):
        build(self)
        bootstrap = self._bootstrap.__wrapped__

        def run(*args):
            with jax.disable_jit():
                return bootstrap(*args)

        self._bootstrap = run

    mp = pytest.MonkeyPatch()
    mp.setattr(jsdvl.SDVL, "_build_jits", build_op_by_op)
    try:
        op_by_op = _run(seq, tmp_path / "op_by_op.txt")
    finally:
        mp.undo()
    yaw = _assert_same_up_to_world_yaw(shipped, op_by_op)
    assert abs(yaw) > 1e-3, yaw
