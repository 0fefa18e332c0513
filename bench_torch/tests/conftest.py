"""Self-tests of the benchmark harness. They run on the CPU at small sizes:

    python -m pytest bench_torch/tests -q

Tests marked ``card`` need a CUDA device and skip without one (decided in
the ``card`` fixture, never at import)."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(tmp, cell_name, size):
    """Copies of a cell and its configuration at ``size`` per axis under
    ``tmp`` (as new files, found before the shipped ones), and the spec
    with the copy added as a cell of the same metrics."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(BENCH, "cells", cell_name + ".json")) as f:
        cell = json.load(f)
    with open(os.path.join(BENCH, "configs", cell["config"] + ".json")) as f:
        cfg = json.load(f)
    small = f"small.{cell_name}"
    cfg["name"] = f"small_{cfg['name']}"
    cfg["shape"] = [size] * len(cfg["shape"])
    cell["config"] = cfg["name"]
    for sub, name, obj in (("configs", cfg["name"], cfg),
                           ("cells", small, cell)):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        with open(os.path.join(tmp, sub, name + ".json"), "w") as f:
            json.dump(obj, f)
    entry = dict(next(w for w in spec["workloads"]
                      if w["name"] == cell_name), name=small,
                 config=cfg["name"])
    spec["workloads"].append(entry)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if cell_name in m.get("workloads", ()):
            m["workloads"].append(small)
    return spec, small, [str(tmp), BENCH]
