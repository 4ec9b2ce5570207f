"""Host seconds each solve spends warming up and capturing its CUDA graph
(``global_ba(stats=...)["capture_s"]``, the mean over the window's
solves): ``global_ba`` captures anew on every call, inside the solve."""


def read(run, spec):
    return run.counters.get("ba_capture_s")
