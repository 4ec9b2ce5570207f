"""Seconds the process spent compiling the port's CUDA libraries
(``nvcc`` in ``ops/cuda/detect.build_library``, the program's
``kernels.build_s`` counter): the part of ``setup_s`` the compiler owns."""

from slam_bench.metrics import _program


def read(run, spec):
    t = _program.tracer()
    if t is None:
        return None
    return float(getattr(t, "counters", {}).get("kernels.build_s", 0.0))
