"""The cells beside the first two: `s3d500.l2.roundtrip` (the roundtrip_l2
kind, reference_l2.py) and `nyx512.bfx.roundtrip`. Whole CPU runs of small
copies: sound runs are correct; a fault planted under the timed path (the
L2 correction dropped, the transform in float32, one level's quantizer
step doubled, one level skipped) and the float32 control are not; a
program without the new counters still runs correct, with its
``transform_ops_MB.*`` None."""

import json
import os

import numpy as np
import pytest
import torch

import registry
import run
from conftest import BENCH, REPO, small_cell
from mgard_tpu_torch import highlevel
from mgard_tpu_torch.hierarchy import Hierarchy, get_hierarchy
from mgard_tpu_torch.ops import refactor
from mgard_tpu_torch.utils import trace

L2 = "s3d500.l2.roundtrip"
NEW = (L2, "nyx512.bfx.roundtrip")
OPS = ("transform_ops_MB.write", "transform_ops_MB.read")


def _run(tmp_path, cell=L2, size=33, traced=False, tf32=False):
    spec, name, roots = small_cell(tmp_path, cell, size)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        r, _ = run.run_cell(spec, name, 2**31 + 17, 0.3, traced, "cpu",
                            roots=roots, tf32=tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    return r


def test_new_cells_load():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    import mgard_tpu_torch as program

    for name in NEW:
        cell = registry.cell([BENCH], name)
        cfg = registry.config([BENCH], cell["config"])
        kind = registry.traffic([BENCH], cell["traffic"])
        kind.Traffic(program, cell["params"], cfg, torch.device("cpu"))
        e2e, layer = registry.cell_metrics(spec, name)
        assert {"write_GBps", "read_GBps", "ratio", "setup_s"} <= {
            m["name"] for m in e2e}
        names = {m["name"] for m in layer}
        assert (set(OPS) <= names) == (name == L2)
        for m in layer:
            assert callable(registry.layer_metric([BENCH], m["name"]).read)
    cfg = registry.config([BENCH], "s3d500_f64")
    assert cfg["shape"] == [500, 500, 500] and cfg["dtype"] == "float64"
    assert cfg["error_bound"] == {"tol": 1e-3, "mode": "REL", "s": 0}


def test_each_pair_of_config_and_traffic_is_one_cell():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs), pairs
    for w in spec["workloads"]:
        cell = registry.cell([BENCH], w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])


def test_bfx_kind_runs_lossless_bfx():
    import mgard_tpu_torch as program

    kind = registry.traffic([BENCH], "roundtrip_bfx")
    cfg = registry.config([BENCH], "nyx512_f32")
    for options in ({}, {"lossless": "BFX"}):
        t = kind.Traffic(program, {"config": options, "mismatch_at": 0.25},
                         cfg, torch.device("cpu"))
        assert t.config.lossless == program.lossless_type.BFX
    with pytest.raises(ValueError):
        kind.Traffic(program, {"config": {"lossless": "BFP"},
                               "mismatch_at": 0.25}, cfg, torch.device("cpu"))


@pytest.mark.parametrize("cell,size", [(L2, 33), (L2, 40),
                                       ("nyx512.bfx.roundtrip", 64)])
def test_sound_small_runs_are_correct(tmp_path, cell, size):
    r = _run(tmp_path, cell, size)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def test_traced_run_reads_the_operator_bytes(tmp_path):
    r = _run(tmp_path, traced=True)
    assert r["correct"], r["checks"]
    hier = get_hierarchy((33, 33, 33), np.float64)
    for m, inverse in zip(OPS, (False, True)):
        assert r["metrics"][m]["value"] == pytest.approx(
            refactor.operator_bytes(hier, True, inverse) / 1e6)


def test_without_the_counters_the_run_is_correct(tmp_path, monkeypatch):
    """The parent program: no raw-path counters (a fresh registry that
    never learns them)."""
    monkeypatch.setattr(trace, "_GROUPS", {})
    monkeypatch.setattr(highlevel, "_count_raw", lambda *a: None)
    r = _run(tmp_path, traced=True)
    assert r["correct"], r["checks"]
    assert not set(OPS) & set(r["metrics"])


def test_float32_control_is_not_correct(tmp_path):
    """control.py's switch: the program on the field's float32 image."""
    r = _run(tmp_path, size=40, tf32=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["l2_over_tol"]["value"] <= 1.0


def _in_float32(real):
    def fn(v, hier, orthogonal):
        h32 = get_hierarchy(hier.shape, np.float32)
        return real(v.to(torch.float32), h32, orthogonal).to(v.dtype)
    return fn


def _step_doubled(real):
    def quantizers(self, *a, **k):
        q = real(self, *a, **k).copy()
        q[1] *= 2.0
        return q
    return quantizers


def _level_skipped(real):
    """The transform stops one coarsening short of the hierarchy's."""
    def fn(v, hier, orthogonal):
        cfg = highlevel.Config()
        cfg.max_larget_level = hier.l_target - 1
        short = Hierarchy(hier.shape, hier.dtype, None, cfg)
        return real(v, short, orthogonal)
    return fn


def _plant_no_correction(m):
    real = refactor._correction_mm
    m.setattr(refactor, "_correction_mm",
              lambda resid, ops, D: torch.zeros_like(real(resid, ops, D)))


FAULTS = {
    "correction_dropped": _plant_no_correction,
    "transform_in_float32": lambda m: [
        m.setattr(highlevel, "decompose", _in_float32(highlevel.decompose)),
        m.setattr(highlevel, "recompose", _in_float32(highlevel.recompose))],
    "one_step_doubled": lambda m: m.setattr(
        Hierarchy, "quantizers", _step_doubled(Hierarchy.quantizers)),
    "one_level_skipped": lambda m: [
        m.setattr(highlevel, "decompose", _level_skipped(highlevel.decompose)),
        m.setattr(highlevel, "recompose",
                  _level_skipped(highlevel.recompose))],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_l2_fault_fails(tmp_path, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = _run(tmp_path)
    assert r["failed"] == 0 and not r["correct"], r["checks"]
