"""Phase ``multi`` of ``chip_smoke.py`` alone, from one checkout of the repo.

    python3 sdvl_tpu_torch/tools/multi_phase.py [ROOT]

imports ``chip_smoke.py`` and the port from ROOT (by default the checkout
this file is in), builds the kernels, serves the committed query frames
once with the localizer (phase ``slice``'s run, which lane 0 of the
frozen-map streams is held to), then runs phase ``multi`` and prints its
lines, the card's SM clock before and after it, and last its numbers as
one JSON line. To compare with an earlier commit on one card, unpack that
commit with ``git archive`` into ``_parent/`` and run this file for each
root in turns (parent, change, change, parent), each in a process of its
own. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def sm_clock() -> str:
    """The card's SM clock and power draw, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.join(here, "..", ".."))
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from sdvl_tpu_torch.ops.cuda import detect, graph_if, small_eig

    if not torch.cuda.is_available():
        print("multi_phase: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    for lib in (detect, graph_if, small_eig):
        lib.load_library()
    card = smoke.gpu_line()
    cfg = smoke.preset_config()
    query = dict(np.load(smoke.QUERY_NPZ))
    served = smoke.run_slice(cfg, query, count_launches=False)[0]
    clocks = [sm_clock()]
    t0 = time.perf_counter()
    out = smoke.run_multi_phase(card, served, query)
    seconds = time.perf_counter() - t0
    clocks.append(sm_clock())
    print(f"[multi_phase] root {root}: phase multi took {seconds:.1f} s; SM "
          f"clock and power before and after {clocks} on {card}",
          flush=True)
    print(json.dumps({"root": root, "card": card, "clocks": clocks,
                      "seconds": seconds, "multi": out}, default=str),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
