"""Nothing the benchmark runs loads JAX or the JAX package ``sdvl_tpu``
(top-level names compared whole: the port ``sdvl_tpu_torch`` begins with
``sdvl_tpu``), and the reference loads nothing of the port."""

import json
import subprocess
import sys

from slam_bench import manifest
from slam_bench.run import FORBIDDEN, forbidden_modules


def loaded(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=manifest.ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_compared_whole():
    assert forbidden_modules(["sdvl_tpu_torch", "sdvl_tpu_torch.ops",
                              "torch", "jaxtyping"]) == []
    assert forbidden_modules(["sdvl_tpu.ops.pallas", "jax._src.api",
                              "flax.linen"]) == ["flax", "jax", "sdvl_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "sdvl_tpu"}


def test_benchmark_loads_no_jax():
    """Every module of the benchmark, every metric reader, the port's
    entry points that the drivers call, and each config read through the
    port."""
    names = loaded(
        "import glob, os\n"
        "import slam_bench.run, slam_bench.drivers, slam_bench.control\n"
        "from slam_bench import manifest, program\n"
        "for f in glob.glob(os.path.join(manifest.HERE, 'configs', "
        "'*.json')):\n"
        "    program.load_config(manifest.json.load(open(f))['cfg'])\n"
        "import sdvl_tpu_torch.pipeline.stream, "
        "sdvl_tpu_torch.pipeline.mapper\n"
        "for f in glob.glob(os.path.join(manifest.HERE, 'metrics', "
        "'[a-z]*.py')):\n"
        "    manifest.reader(os.path.basename(f)[:-3])\n")
    assert "sdvl_tpu_torch" in names
    assert forbidden_modules(names) == []


def test_reference_loads_nothing_of_the_port():
    names = loaded("import slam_bench.reference, slam_bench.scene, "
                   "slam_bench.stats, slam_bench.peaks")
    assert "sdvl_tpu_torch" not in names
    assert forbidden_modules(names) == []
