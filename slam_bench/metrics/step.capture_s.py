"""The program's own count of host seconds spent warming up and capturing
the step's CUDA graphs (``StepRunner.capture_s``, summed over its graphs),
all of it in set-up."""


def read(run, spec):
    return run.counters.get("capture_s")
