"""Where the detection kernel's time goes, stage by stage, on the GPU.

Builds copies of ``csrc/detect.cu`` that stop after each stage of the block
(the copy stores what it has computed so far, so the compiler keeps the
stage) and times one launch over the three detection levels of the first
query frame (the stream's preset shapes), each as the device time of a CUDA
graph replay of many launches:

* ``launch``    -- the block returns as soon as it has found its level;
* ``staging``   -- plus the halo tile staged in shared memory;
* ``tensor``    -- plus the Sobel products and their vertical 4-sums;
* ``maps``      -- the whole kernel without cells (``cell`` = 0);
* ``cells``     -- the whole kernel with the preset's 32-px cells.

Each stage's cost is the difference to the line before it.

    python3 -m sdvl_tpu_torch.tools.detect_stages
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Text inserted before a marker comment of csrc/detect.cu: store the stage's
# value for the thread's pixels and leave.
_STOP = """    {
        for (int k = 0; k < PX; ++k) {
            const int y = y0 + ty + ROWS * k, x = x0 + tx;
            if (x < W && y < H) L.out[static_cast<size_t>(y) * W + x] = %s;
        }
        return;
    }
"""
_CUTS = (
    ("launch", "    // The cells of the cropped grid", "0.0f"),
    ("staging", "    // Stage 2:", "s_img[ty + ROWS * k + HALO][tx + HALO]"),
    ("tensor", "    // Stage 3:", "s_v[0][ty + ROWS * k][tx]"),
)


def _variant(src: str, marker: str, value: str) -> str:
    i = src.index(marker)
    return src[:i] + _STOP % value + src[i:]


def main() -> int:
    if not torch.cuda.is_available():
        print("detect_stages needs a GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    from sdvl_tpu_torch.ops import pyramid
    from sdvl_tpu_torch.ops.cuda import detect

    src = open(detect.SOURCE).read()
    os.makedirs(detect.BUILD_DIR, exist_ok=True)
    jobs = []
    for name, marker, value in _CUTS:
        path = os.path.join(detect.BUILD_DIR, f"detect_stage_{name}.cu")
        with open(path, "w") as f:
            f.write(_variant(src, marker, value))
        jobs.append((path, f"libsdvl_detect_stage_{name}.so"))
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        futures = [ex.submit(detect.build_library, False, p, n)
                   for p, n in jobs]
        full = ex.submit(detect.build_library)
        libs = [detect.bind_library(f.result()) for f in futures]
        full_lib = detect.bind_library(full.result())

    cfg = chip_smoke.preset_config()
    query = dict(np.load(chip_smoke.QUERY_NPZ))
    frame0 = torch.from_numpy(query["frames"][0]).cuda()
    levels = pyramid.build_pyramid(frame0, 3)[: cfg.sdvl.max_fast_levels]
    cell = cfg.sdvl.cell_size
    runs = [(name, lib, cell) for (name, _, _), lib in zip(_CUTS, libs)]
    runs += [("maps", full_lib, 0), ("cells", full_lib, cell)]
    print(chip_smoke.gpu_line(), flush=True)
    print(f"one launch over {[list(l.shape) for l in levels]}, device ms "
          f"per launch (CUDA graph replay), stage cost = difference:",
          flush=True)
    prev = 0.0
    for name, lib, c in runs:
        ms = chip_smoke.graph_ms(lambda: detect._launch(
            levels, c, chip_smoke.FAST_T, chip_smoke.ST_T, lib=lib))
        print(f"  {name:8s} {ms:.5f} ms  (+{ms - prev:.5f})", flush=True)
        prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
