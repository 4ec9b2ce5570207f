"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its metrics' readers
(``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """One cell with its configuration file, traffic file and the
    metrics it reports: ``end_to_end`` (with ``--trace 0``) and
    ``per_layer`` (with ``--trace 1``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    return pairing(bench, cells[name])


def pairing(bench: dict, w: dict) -> dict:
    """A configuration under a traffic mix, ``w`` = {name, config,
    traffic, chips}: the files and the metrics that name its cell. A
    configuration that no cell of ``bench`` uses is read from
    ``configs/<config>.json``."""
    conf = {c["name"]: c["file"] for c in bench["configs"]}.get(
        w["config"], os.path.join("slam_bench", "configs",
                                  w["config"] + ".json"))
    with open(os.path.join(ROOT, conf)) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(ms):
        return [m for m in ms if w["name"] in m.get("workloads",
                                                    [w["name"]])]

    return dict(cell=w, config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def reader(metric: str):
    """The ``read(run, spec)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "slam_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
