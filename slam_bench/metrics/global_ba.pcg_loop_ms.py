"""Device ms per solve of the global BA's ``pcg_loop`` stage: each LM step's
CG loop (its WHILE node). The program's stage marks (``trace.mark``,
captured into the traced solve's graph) time it on the card's
``%globaltimer``."""

from slam_bench.metrics import _program


def read(run, spec):
    return _program.stage_ms_per_solve(run, "pcg_loop")
