"""Tests of the benchmark harness. They run on the CPU at small sizes;
those marked ``cuda`` need the card and skip without one."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the cell's own size on the card); "
        "skipped with a reason where there is none")


def spec_of(name: str) -> dict:
    """A cell of ``BENCHMARK.json``, or a pairing ``<config>.<traffic>``
    of its files that no cell uses yet."""
    from slam_bench import manifest

    bench = manifest.load()
    if name in {w["name"] for w in bench["workloads"]}:
        return manifest.cell(bench, name)
    config, traffic = name.split(".")
    return manifest.pairing(bench, dict(name=name, config=config,
                                        traffic=traffic, chips=1))


@pytest.fixture
def small_spec():
    """A cell of ``BENCHMARK.json`` cut to a small frame for the CPU:
    ``small_spec(name, width, height, cfg=..., traffic=..., map=...)``."""
    from slam_bench import manifest

    def make(name, width=320, height=240, cfg=None, traffic=None,
             map=None):
        spec = copy.deepcopy(spec_of(name))
        c = spec["config"]["cfg"]
        s = width / c["Camera.width"]
        c.update({"Camera.width": width, "Camera.height": height,
                  "Camera.fx": c["Camera.fx"] * s,
                  "Camera.fy": c["Camera.fy"] * s,
                  "Camera.u0": c["Camera.u0"] * s,
                  "Camera.v0": c["Camera.v0"] * s})
        c.update(cfg or {})
        spec["traffic"].update(traffic or {})
        if map:
            spec["traffic"]["map"].update(map)
        return spec

    return make


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size on the card")
    return torch.device("cuda", 0)
