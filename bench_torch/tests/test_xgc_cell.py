"""The cells of XGC's f0 and of MDR with BFX planes: `xgc4d.l2.roundtrip`
(the roundtrip_l2 kind at rank 4, whose long axis takes the program's
slice route) and `mdr384.bfx.progressive` (the progressive_bfx kind).
Whole CPU runs of small copies: sound runs are correct; the float32
control and a fault planted under the timed path (one level's quantizer
step doubled, the slice route's L2 correction skipped) are not; a traced
run reads the slice route's scan passes, and a program without that
counter still runs correct with the metric left out."""

import json
import os

import numpy as np
import pytest
import torch

import registry
import run
from conftest import BENCH, REPO, small_cell
from mgard_tpu_torch.hierarchy import Hierarchy, get_hierarchy
from mgard_tpu_torch.ops import _be, axis, refactor
from mgard_tpu_torch.utils import trace

XGC = "xgc4d.l2.roundtrip"
MDR = "mdr384.bfx.progressive"
PASSES = ("transform_scan_passes.write", "transform_scan_passes.read")
# rank 4 with an axis over refactor._FAST_MAX_AXIS: the slice route
SMALL = (4, 5, 4200, 5)


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _small(tmp_path, cell, shape):
    """small_cell's copy of ``cell``, its configuration at ``shape``."""
    spec, name, roots = small_cell(tmp_path, cell, 2)
    cfg_name = registry.cell(roots, name)["config"]
    path = os.path.join(str(tmp_path), "configs", cfg_name + ".json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["shape"] = list(shape)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return spec, name, roots


def _run(tmp_path, cell=XGC, shape=SMALL, traced=False, tf32=False):
    spec, name, roots = _small(tmp_path, cell, shape)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        r, _ = run.run_cell(spec, name, 2**31 + 23, 0.3, traced, "cpu",
                            roots=roots, tf32=tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    return r


@pytest.mark.parametrize("name", [XGC, MDR])
def test_new_cells_load(name):
    import mgard_tpu_torch as program

    spec = _spec()
    cell = registry.cell([BENCH], name)
    cfg = registry.config([BENCH], cell["config"])
    kind = registry.traffic([BENCH], cell["traffic"])
    kind.Traffic(program, cell["params"], cfg, torch.device("cpu"))
    e2e, layer = registry.cell_metrics(spec, name)
    assert {"write_GBps", "read_GBps", "ratio", "setup_s"} <= {
        m["name"] for m in e2e}
    names = {m["name"] for m in layer}
    assert (set(PASSES) <= names) == (name == XGC)
    assert {"device_idle.write", "kernel_roofline.read",
            "copy_GBps.write"} <= names
    for m in layer:
        assert callable(registry.layer_metric([BENCH], m["name"]).read)
    entry = next(w for w in spec["workloads"] if w["name"] == name)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200


def test_xgc_configuration_is_the_published_shape():
    cfg = registry.config([BENCH], "xgc4d_f64")
    assert cfg["shape"] == [8, 39, 16395, 39] and cfg["dtype"] == "float64"
    assert cfg["error_bound"] == {"tol": 1e-3, "mode": "REL", "s": 0}
    assert cfg["reduced"] == [] and cfg["timesteps"] == 4
    s3d = registry.config([BENCH], "s3d500_f64")["generator"]
    gen = cfg["generator"]
    assert gen["phase_step"] == s3d["phase_step"]
    for mine, theirs in zip(gen["modes"], s3d["modes"]):
        assert (mine["amp"], mine["phase"]) == (theirs["amp"],
                                                theirs["phase"])
    assert registry.cell([BENCH], XGC)["limits"] == {
        "l2_over_tol": 1.0, "mismatch_share": 1e-6,
        "gap_mean_over_tol": 1e-6}
    hier = get_hierarchy(tuple(cfg["shape"]), np.float64)
    assert not refactor._use_fast(hier) and hier.l_target == 3


def test_each_pair_of_config_and_traffic_is_one_cell():
    spec = _spec()
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs), pairs
    assert {(w["config"], w["traffic"]) for w in spec["workloads"]
            if w["name"] in (XGC, MDR)} == {
        ("xgc4d_f64", "roundtrip_l2"), ("mdr384_f32", "progressive_bfx")}


def test_progressive_bfx_kind_runs_bfx_planes():
    import mgard_tpu_torch as program

    kind = registry.traffic([BENCH], "progressive_bfx")
    cfg = registry.config([BENCH], "mdr384_f32")
    params = {"tols": [1e-2], "mismatch_at": 0.25}
    for options in ({}, {"mdr_level_compressor": "bfx"}):
        t = kind.Traffic(program, {**params, "config": options}, cfg,
                         torch.device("cpu"))
        assert t.config.mdr_level_compressor == "bfx"
        assert t.config.total_num_bitplanes == cfg["bitplanes"]
    with pytest.raises(ValueError):
        kind.Traffic(program, {**params, "config": {
            "mdr_level_compressor": "zlib"}}, cfg, torch.device("cpu"))


@pytest.mark.parametrize("cell,shape", [(XGC, SMALL), (XGC, (6, 9, 17, 9)),
                                        (MDR, (48, 48, 48))])
def test_sound_small_runs_are_correct(tmp_path, cell, shape):
    r = _run(tmp_path, cell, shape)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def _passes(shape) -> int:
    """transform.scan_passes of one slice-route transform of ``shape``."""
    hier = get_hierarchy(shape, np.float64)
    return sum(2 * (n - 1).bit_length()
               for l in range(1, hier.l_target + 1)
               for n in hier.level_shape[l - 1])


def test_traced_run_reads_the_scan_passes(tmp_path):
    r = _run(tmp_path, traced=True)
    assert r["correct"], r["checks"]
    for m in PASSES:
        assert r["metrics"][m]["value"] == _passes(SMALL)
        assert r["metrics"][m]["unit"] == "passes"


def test_without_the_counters_the_run_is_correct(tmp_path, monkeypatch):
    """The parent program: the slice route counts nothing (a fresh
    registry, and neither the scans nor the solves count)."""
    monkeypatch.setattr(trace, "_GROUPS", {})
    for module in (_be, axis):
        monkeypatch.setattr(module, "count", lambda *a, **k: None)
    r = _run(tmp_path, traced=True)
    assert r["correct"], r["checks"]
    assert not set(PASSES) & set(r["metrics"])


def test_float32_control_is_not_correct(tmp_path):
    """control.py's switch: the program on the field's float32 image. It
    holds the stated bound and misses the mean gap's limit by 100x."""
    r = _run(tmp_path, tf32=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["l2_over_tol"]["value"] <= 1.0
    gap = r["checks"]["gap_mean_over_tol"]
    assert gap["value"] >= 100 * gap["limit"]


def test_mdr_bfx_control_is_not_correct(tmp_path):
    """The bfx cell's control: the program on the field's float16 image
    misses the stated L-inf bound at the finest tolerance and the mismatch
    limit, while the planner's byte count stays exact."""
    r = _run(tmp_path, MDR, (48, 48, 48), tf32=True)
    assert not r["correct"], r["checks"]
    checks = r["checks"]
    assert checks["linf_over_tol"]["value"] > checks["linf_over_tol"]["limit"]
    assert checks["mismatch_share"]["value"] > checks["mismatch_share"][
        "limit"]
    assert checks["planned_bytes_gap"]["value"] == 0


def _step_doubled(real):
    def quantizers(self, *a, **k):
        q = real(self, *a, **k).copy()
        q[1] *= 2.0
        return q
    return quantizers


FAULTS = {
    "one_step_doubled": lambda m: m.setattr(
        Hierarchy, "quantizers", _step_doubled(Hierarchy.quantizers)),
    "correction_skipped": lambda m: m.setattr(
        refactor, "_correction", lambda resid, axes: 0.0),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_xgc_fault_fails(tmp_path, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = _run(tmp_path)
    assert r["failed"] == 0 and not r["correct"], r["checks"]
