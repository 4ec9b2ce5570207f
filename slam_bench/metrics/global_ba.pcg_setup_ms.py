"""Device ms per solve of the global BA's ``pcg_setup`` stage: each LM step's
PCG set-up: the point blocks' inverses, the right-hand side and the
block-Jacobi preconditioner. The program's stage marks (``trace.mark``,
captured into the traced solve's graph) time it on the card's
``%globaltimer``."""

from slam_bench.metrics import _program


def read(run, spec):
    return _program.stage_ms_per_solve(run, "pcg_setup")
