"""The harness finds everything by name, and its arithmetic."""

import json
import os
import subprocess
import sys

import pytest
import torch

import clock
import field
import registry
import run
from conftest import BENCH, REPO, small_cell


def test_finds_each_piece_by_name():
    roots = [BENCH]
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = registry.cell(roots, w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        cfg = registry.config(roots, cell["config"])
        assert cfg["name"] == w["config"]
        assert hasattr(registry.traffic(roots, cell["traffic"]), "Traffic")
    for m in spec["per_layer"]:
        assert callable(registry.layer_metric(roots, m["name"]).read)
    for m in spec["end_to_end"]:
        assert callable(registry.e2e_metric(roots, m["name"]).compute)
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_new_files_in_another_root_are_found(tmp_path):
    """A throwaway traffic kind, metric, configuration and cell, each a new
    file, run through run_cell with no edit to a file that is there."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "echo.py").write_text(
        "class Traffic:\n"
        "    def __init__(self, program, params, cfg, device):\n"
        "        self.scale = params['scale']\n"
        "    def request(self, field, rec):\n"
        "        out, r = rec.call('write', lambda: field * self.scale,\n"
        "                          field.numel() * 4)\n"
        "        r['stream_bytes'] = 1\n"
        "        out, r = rec.call('read', lambda: out / self.scale,\n"
        "                          field.numel() * 4)\n"
        "        r['stream_bytes'] = field.numel()\n"
        "        return out\n"
        "    def check(self, out, field):\n"
        "        return {'gap': float((out - field).abs().max())}\n")
    (tmp_path / "e2e").mkdir()
    (tmp_path / "e2e" / "calls_per_s.py").write_text(
        "def compute(run):\n"
        "    return len(run.calls) / sum(c['seconds'] for c in run.calls)\n")
    (tmp_path / "configs").mkdir()
    cfg = registry.config([BENCH], "nyx512_f32")
    cfg.update(name="tiny", shape=[8, 8, 8])
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "cells").mkdir()
    (tmp_path / "cells" / "tiny.echo.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "echo", "params": {"scale": 2.0},
         "samples": 2, "limits": {"gap": 0.0}}))
    spec = {"workloads": [{"name": "tiny.echo", "config": "tiny",
                           "traffic": "echo", "chips": 1, "why": "x"}],
            "end_to_end": [{"name": "calls_per_s", "unit": "1/s"},
                           {"name": "ratio", "unit": "x"}],
            "per_layer": []}
    r, _ = run.run_cell(spec, "tiny.echo", 5, 0.05, False, "cpu",
                        roots=[str(tmp_path), BENCH])
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"calls_per_s", "ratio"}
    assert r["metrics"]["ratio"]["value"] == pytest.approx(4.0)
    assert list(r)[-1] == "checks"


def test_cell_env_is_set_before_the_program(tmp_path, monkeypatch):
    """A cell's ``env`` is in the environment when the program is
    imported and when its requests run."""
    import builtins

    monkeypatch.delenv("BENCH_CELL_KNOB", raising=False)
    seen, real_import = [], builtins.__import__

    def probe(name, *args, **kwargs):
        if name == "mgard_tpu_torch":
            seen.append(os.environ.get("BENCH_CELL_KNOB"))
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", probe)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "knob.py").write_text(
        "import os\n"
        "class Traffic:\n"
        "    def __init__(self, program, params, cfg, device):\n"
        "        pass\n"
        "    def request(self, field, rec):\n"
        "        out, r = rec.call('write', lambda: field, 4)\n"
        "        r['stream_bytes'] = 1\n"
        "        return os.environ['BENCH_CELL_KNOB']\n"
        "    def check(self, out, field):\n"
        "        return {'knob_gap': abs(int(out) - 3)}\n")
    (tmp_path / "configs").mkdir()
    cfg = registry.config([BENCH], "nyx512_f32")
    cfg.update(name="tiny", shape=[4, 4, 4])
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "cells").mkdir()
    (tmp_path / "cells" / "tiny.knob.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "knob", "env": {"BENCH_CELL_KNOB": 3},
         "params": {}, "samples": 1, "limits": {"knob_gap": 0}}))
    spec = {"workloads": [{"name": "tiny.knob", "config": "tiny",
                           "traffic": "knob", "chips": 1, "why": "x"}],
            "end_to_end": [], "per_layer": []}
    r, _ = run.run_cell(spec, "tiny.knob", 5, 0.01, False, "cpu",
                        roots=[str(tmp_path), BENCH])
    assert r["correct"], r["checks"]
    assert seen and seen[0] == "3"


def _calls(seconds, kind="write", nbytes=10**9):
    return [{"kind": kind, "seconds": s, "field_bytes": nbytes,
             "stream_bytes": nbytes // 4} for s in seconds]


def test_rates_and_tails_over_every_call():
    steady = _calls([0.25] * 100)
    assert clock.rate_GBps(steady, "write") == pytest.approx(4.0)
    assert clock.percentile_ms(steady, "write", 90) == pytest.approx(250.0)
    # a stall in 15 of the calls: the rate is a sum over all calls, and the
    # tail sees them (a median or a best-of would not)
    stalled = _calls([0.25] * 85 + [1.0] * 15)
    assert clock.rate_GBps(stalled, "write") == pytest.approx(
        100 / (85 * 0.25 + 15 * 1.0))
    assert clock.percentile_ms(stalled, "write", 90) == pytest.approx(1000.0)
    assert clock.rate_GBps(stalled, "read") is None
    reads = _calls([0.1] * 3, kind="read")
    assert clock.ratio(stalled + reads) == pytest.approx(4.0)


def test_field_is_the_seeds():
    cfg = registry.config([BENCH], "nyx512_f32")
    cfg["shape"] = [16, 16, 16]
    a = field.make_pool(cfg, 2**31 + 7, "cpu")
    b = field.make_pool(cfg, 2**31 + 7, "cpu")
    c = field.make_pool(cfg, 2**31 + 8, "cpu")
    assert len(a) == cfg["timesteps"]
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and not torch.equal(x, z)
        assert x.dtype == torch.float32 and tuple(x.shape) == (16, 16, 16)
    assert not torch.equal(a[0], a[1])


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload",
         "nyx512.bfp.roundtrip", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    p = _run_cli(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and bench_torch/ exits
    non-zero with nothing on standard output."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_small_roundtrip_cell_runs_correct(tmp_path):
    spec, name, roots = small_cell(tmp_path, "nyx512.bfp.roundtrip", 64)
    r, _ = run.run_cell(spec, name, 2**31 + 3, 0.5, False, "cpu",
                        roots=roots)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"write_GBps", "read_GBps", "ratio",
                                 "write_p90_ms", "setup_s"}
