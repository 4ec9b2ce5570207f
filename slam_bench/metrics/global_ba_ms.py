"""The window over the number of whole-map BA solves completed in it, in
ms."""


def read(run, spec):
    if not run.steps:
        return None
    return 1e3 * run.window_s / len(run.steps)
