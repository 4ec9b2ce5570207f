"""Run one cell of the benchmark once.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Loads, warms up, measures for ``--seconds``, compares what the timed path
produced with the plain reference, and prints as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device`` and, last, ``check``: each number compared
with its limit (also the last lines of standard error). Exits non-zero,
printing no result, without enough CUDA devices, or where the JAX package
or JAX was loaded.
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import manifest  # noqa: E402

# the modules the benchmark may never load: JAX, and the JAX package
# beside the port (compared by the whole top-level name: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdvl_tpu")
HOST_THREADS = 2


def forbidden_modules(modules=None) -> list:
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache under the checkout, at fixed paths."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def metric_values(spec: dict, run, names) -> dict:
    out = {}
    for m in names:
        v = manifest.reader(m["name"])(run, spec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(manifest.ROOT)
    spec = manifest.cell(manifest.load(), args.workload)
    chips = spec["cell"]["chips"]
    # one process, few threads: the host's share stays steady
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)

    import torch

    torch.set_num_threads(HOST_THREADS)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from . import drivers

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = spec["traffic"]["kind"]
    run = drivers.KINDS[kind](spec, args.seed, args.seconds,
                              spec["traffic"]["trace_steps"] if args.trace
                              else 0, dev, T_PROC)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3

    print(json.dumps(run_info(args, run)), file=sys.stderr)
    out = result(spec, run, bool(args.trace),
                 dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                      count=chips))
    if out is None:
        print("the profiler recorded no window", file=sys.stderr)
        return 4
    for n, (v, lim) in run.checks.items():
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def run_info(args, run) -> dict:
    """What a run says on standard error before its result: the window,
    the program's counters and the card's clocks and power before and
    after the window."""
    info = dict(cell=args.workload, seed=args.seed, setup_s=run.setup_s,
                window_s=run.window_s, steps=len(run.steps),
                counters=run.counters,
                card_before=run.extra.get("card_before"),
                card_after=run.extra.get("card_after"),
                keyframes=run.extra.get("keyframes"),
                check_s=run.extra.get("check_s"),
                failed=run.failed)
    if run.ran_out:
        info["note"] = ("the generated sequence ran out before --seconds: "
                        "the window ended at its last frame")
    return info


def result(spec: dict, run, traced: bool, device: dict):
    """The result line's object, ``check`` last; None for a traced run
    whose profiler recorded no window."""
    from . import trace

    metrics = metric_values(spec, run, spec["per_layer"] if traced
                            else spec["end_to_end"])
    out = dict(correct=run.correct, attempted=run.attempted,
               failed=run.failed, metrics=metrics,
               device=dict(device,
                           memory_peak_bytes=run.extra["memory_peak_bytes"]))
    if traced:
        if run.trace is None or run.trace["window_us"] is None:
            return None
        w0, w1 = run.trace["window_us"]
        out["device"]["busy_s"] = trace.busy_us(run.trace) / 1e6
        out["device"]["window_s"] = (w1 - w0) / 1e6
        out["breakdown"] = trace.breakdown(run.trace)
    out["check"] = {n: {"value": finite(v), "limit": lim}
                    for n, (v, lim) in run.checks.items()}
    return out


def finite(v):
    """A number for JSON; None where there is none (a frame never
    answered reads inf)."""
    import math

    return v if math.isfinite(v) else None


if __name__ == "__main__":
    sys.exit(main())
