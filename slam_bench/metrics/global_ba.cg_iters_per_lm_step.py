"""CG iterations per LM step of the window's solves: the program's own
device count (``global_ba(stats=...)["cg_iterations"]``), averaged."""


def read(run, spec):
    return run.counters.get("cg_iters_per_lm_step")
