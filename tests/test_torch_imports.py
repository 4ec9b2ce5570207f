"""The port stands alone: ``sdvl_tpu_torch/`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, nor OpenCV (the card's machine
has none): the exceptions are the live-camera source and the live viewer's
windows (``viz/live.py``'s ``LiveUI``), which need a camera or a display and
OpenCV, import it when they open, and say so where it is absent."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+sdvl_tpu\b(?!_torch)"
    r"|from\s+sdvl_tpu(\.|\s))", re.M)
# any use of the reference package's modules, e.g. ``sdvl_tpu.ops``
DOTTED = re.compile(r"(?<![\w/`])sdvl_tpu\.\w+\s*(\(|\.\w+\()")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "sdvl_tpu_torch")):
        if "_build" in d:
            continue
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    hits = []
    for f in files:
        text = open(f).read()
        for pat in (FORBIDDEN, DOTTED):
            for m in pat.finditer(text):
                hits.append((os.path.relpath(f, ROOT), m.group(0).strip()))
    assert not hits, hits


def test_port_package_mirrors_the_reference_layout():
    for sub in ("core", "ops", "solvers", "state", "pipeline", "io", "utils",
                "cli", "dist", "viz"):
        assert os.path.isfile(
            os.path.join(ROOT, "sdvl_tpu_torch", sub, "__init__.py"))
    pairs = [
        "core/se3.py", "core/camera.py", "core/geometry.py",
        "pipeline/config.py", "state/map_state.py", "ops/interp.py",
        "ops/pyramid.py", "ops/fast.py", "ops/patch.py", "ops/orb.py",
        "solvers/lk.py", "solvers/image_align.py", "solvers/pose.py",
        "pipeline/matcher.py", "pipeline/tracker.py",
        "pipeline/relocalize.py", "pipeline/device_fsm.py",
        "pipeline/stream.py", "io/snapshot.py",
        "solvers/homography.py", "solvers/ba.py", "pipeline/bootstrap.py",
        "pipeline/depth_filter.py", "pipeline/mapper.py",
        "io/synthetic.py", "io/evaluate.py",
        "io/dataset.py", "io/native_loader.py", "pipeline/sdvl.py",
        "pipeline/runtime.py", "utils/trace.py", "cli/run.py",
        "dist/mesh.py", "dist/multi_stream.py", "dist/ba_sharded.py",
        "dist/multihost.py", "viz/overlay.py", "viz/recorder.py",
        "viz/scene.py", "viz/live.py",
    ]
    for rel in pairs:
        assert os.path.isfile(os.path.join(ROOT, "sdvl_tpu", rel)), rel
        assert os.path.isfile(os.path.join(ROOT, "sdvl_tpu_torch", rel)), rel
    # the JAX side's root tools the port has its own copy of
    for rel in ("long_run.py", "zurich_scale_smoke.py", "capacity_probe.py"):
        assert os.path.isfile(os.path.join(ROOT, "tools", rel)), rel
        assert os.path.isfile(os.path.join(ROOT, "sdvl_tpu_torch", "tools",
                                           rel)), rel
    assert os.path.isfile(os.path.join(ROOT, "sdvl_tpu_torch", "ops", "cuda",
                                       "detect.py"))
    assert os.path.isfile(os.path.join(ROOT, "sdvl_tpu_torch", "csrc",
                                       "detect.cu"))


CV2 = re.compile(r"^\s*(import\s+cv2\b|from\s+cv2\b)", re.M)


def test_port_imports_no_opencv_but_for_the_live_camera():
    hits = []
    for f in _port_files():
        text = open(f).read()
        for m in CV2.finditer(text):
            func = re.findall(r"^\s*def (\w+)", text[:m.start()], re.M)[-1:]
            hits.append((os.path.relpath(f, ROOT), func))
    assert sorted(hits) == [
        ("sdvl_tpu_torch/io/dataset.py", ["camera_source"]),
        ("sdvl_tpu_torch/viz/live.py", ["_on_mouse"]),
        ("sdvl_tpu_torch/viz/live.py", ["_run"]),
        ("sdvl_tpu_torch/viz/live.py", ["available"]),
    ]
    # and importing every module of the port loads neither cv2 nor jax
    mods = []
    for f in _port_files()[1:]:
        rel = os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted(m for m in ('cv2', 'jax', 'sdvl_tpu') "
              "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("tool", ["zurich_scale_smoke", "capacity_probe",
                                  "long_run"])
def test_tools_default_to_the_card_with_no_fallback(tool):
    """Each tool runs on the card unless asked for the CPU: without one it
    stops before any work, naming the device."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    mod = importlib.import_module(f"sdvl_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
