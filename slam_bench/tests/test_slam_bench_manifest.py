"""BENCHMARK.json against its format's rules for names, units, keys and
limits, and every name it gives found as a file."""

import json
import os
import re

import pytest

from slam_bench import manifest

BENCH = manifest.load()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_the_full_check():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(manifest.NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("slam_bench/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(manifest.NAME.match(k) for k in c["reduced"])
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in body["cfg"] and k in body.get("source_values", {})
            assert not re.search(r"(_dim|_rank)$|width|height", k)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = {(w["config"], w["traffic"]) for w in ws}
    assert len(pairs) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert manifest.NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(manifest.HERE, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in METRICS:
        assert manifest.UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"] if "workloads" in m else []) <= cells
        assert os.path.exists(os.path.join(manifest.HERE, "metrics",
                                           m["name"] + ".py"))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        mover = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mover.get("workloads", cells))
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(cell):
    spec = manifest.cell(BENCH, cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    assert spec["traffic"]["kind"] in ("live_map", "global_ba")
    for lim in spec["traffic"]["check"]["limits"].values():
        assert lim >= 0
