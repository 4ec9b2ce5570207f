"""Everything before the window: the process's start, imports, generation,
the program's set-up and warm-up, in s."""


def read(run, spec):
    return run.setup_s
