"""Device ms per solve of the global BA's ``linearize`` stage: the residuals,
robust weights and normal equations of each LM step. The program's stage
marks (``trace.mark``, captured into the traced solve's graph) time it on
the card's ``%globaltimer``."""

from slam_bench.metrics import _program


def read(run, spec):
    return _program.stage_ms_per_solve(run, "linearize")
