"""PyTorch port, its stage spans and counters (``utils/trace.py``) on the
CPU: the ``mgard.*`` ranges a torch profiler records around compress /
decompress (64^3, and the flag-1 shape of test_torch_highlevel.py) and the
MDR calls (48^3), nested on the caller's thread; the shared no-op object
without a profiler; the counter registry (the kernels' launch counts, the
sticky-K and fallback counters on the fallback inputs of
test_torch_highlevel_fused.py, no copies on the CPU); and the readings of
``scripts/h100_trace_layers.py`` on synthetic profiler events."""

import importlib
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu_torch import kernels, mdr
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import multidim as MD, refactor as TR
from mgard_tpu_torch.utils import trace
from test_torch_highlevel import (  # noqa: F401 (fixtures)
    SHAPE, _field, bfp_small, fresh_k_caches)
from test_torch_highlevel_fused import FUSED_SHAPE, _fused_cfg

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

log_mod = importlib.import_module("mgard_tpu_torch.utils.log")

_SCRIPT = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
           / "h100_trace_layers.py")
_spec = importlib.util.spec_from_file_location("h100_trace_layers", _SCRIPT)
TL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TL)

# every span's enclosing span (None: the call itself)
PARENTS = {
    "api.compress": {None},
    "api.decompress": {None},
    "api.mdr_refactor": {None},
    "api.mdr_request": {None},
    "api.mdr_reconstruct": {None},
    "api.metadata": {"api.compress", "api.decompress"},
    "api.join": {"api.compress", "api.mdr_refactor", "codec.plane_encode"},
    "kernel.front": {"api.compress", "api.decompress"},
    "kernel.remainder": {"kernel.front"},
    "codec.lossless": {"api.compress", "api.decompress", "kernel.front"},
    "kernel.bfp_encode": {"api.compress", "codec.lossless"},
    "kernel.bfp_decode": {"api.decompress", "codec.lossless"},
    "codec.bfp_plan": {"kernel.bfp_encode", "kernel.bfp_decode"},
    "codec.choose_K": {"api.compress", "codec.lossless"},
    "codec.bfp_blob": {"api.compress"},
    "kernel.bfp_compact": {"codec.bfp_blob"},
    "codec.bfp_parse": {"api.decompress", "codec.lossless"},
    "kernel.bfp_expand": {"api.decompress", "codec.lossless"},
    "kernel.mdr_decompose": {"api.mdr_refactor"},
    "codec.plane_encode": {"api.mdr_refactor"},
    "codec.plan": {"api.mdr_request"},
    "kernel.mdr_recompose": {"api.mdr_reconstruct"},
    "codec.plane_decode": {"api.mdr_reconstruct"},
    "api.norm": {"api.compress"},
    "kernel.decompose": {"api.compress"},
    "kernel.quantize": {"api.compress"},
    "kernel.dequantize": {"api.decompress"},
    "kernel.recompose": {"api.decompress"},
    "transform.slice_level": {"kernel.decompose", "kernel.recompose",
                              "kernel.remainder", "kernel.mdr_decompose",
                              "kernel.mdr_recompose"},
    "transform.solve": {"transform.slice_level"},
}
FLAG1_SPANS = {"api.compress", "api.decompress", "api.metadata", "api.join",
               "kernel.bfp_compact", "kernel.front", "kernel.remainder",
               "codec.lossless", "kernel.bfp_encode", "kernel.bfp_decode",
               "codec.bfp_plan", "codec.choose_K", "codec.bfp_blob",
               "codec.bfp_parse", "kernel.bfp_expand"}
RAW_SPANS = {"api.norm", "kernel.decompose", "kernel.quantize",
             "kernel.dequantize", "kernel.recompose"}
MDR_SPANS = {"api.mdr_refactor", "api.mdr_request", "api.mdr_reconstruct",
             "kernel.mdr_decompose", "codec.plane_encode", "codec.plan",
             "kernel.mdr_recompose", "codec.plane_decode"}


def _traced_events(tmp_path, calls):
    """Run each (kind, fn) of ``calls`` in a ``bench.<kind>`` annotation
    under a CPU profiler; returns the exported trace's events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for kind, fn in calls:
            with torch.profiler.record_function(f"bench.{kind}"):
                fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _check_nesting(events, kinds):
    """Every mgard span lies inside its parent on its call's thread, under
    the parent the table allows; no call opens more than 100. Returns the
    names seen."""
    seen = set()
    spans = TL.annotations(events, "mgard.")
    for kind in kinds:
        for tid, a, b in TL.calls_of(events, kind):
            mine = sorted(((s, e, n[len("mgard."):]) for t, s, e, n in spans
                           if t == tid and a <= s < b),
                          key=lambda x: (x[0], -x[1]))
            assert 0 < len(mine) <= 100
            stack = []
            for s, e, n in mine:
                while stack and stack[-1][1] <= s:
                    stack.pop()
                parent = stack[-1] if stack else None
                assert e <= (parent[1] if parent else b) + 1e-3, n
                assert (parent[2] if parent else None) in PARENTS[n], (
                    n, parent)
                seen.add(n)
                stack.append((s, e, n))
    return seen


def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    assert trace.span("api.compress") is trace.NO_SPAN
    assert trace.span("codec.x") is trace.span("kernel.y")

    def boom(*a, **k):
        raise AssertionError("record_function with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    v = _field((32, 32, 32))
    blob, st = M.compress(v, 1e-3, device="cpu")
    out, st2 = M.decompress(blob, device="cpu")
    assert st == st2 == M.compress_status_type.Success


def test_span_records_under_a_profiler(tmp_path):
    events = _traced_events(tmp_path, [("write", lambda: trace.span(
        "api.x").__enter__().__exit__(None, None, None))])
    assert [n for *_, n in TL.annotations(events, "mgard.")] == [
        "mgard.api.x"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.span("api.x") is not trace.NO_SPAN


def test_traced_keeps_the_function(tmp_path):
    @trace.traced("kernel.t")
    def f(x, y=2):
        """doc"""
        return x + y

    assert f(1) == 3 and f.__name__ == "f" and f.__doc__ == "doc"
    events = _traced_events(tmp_path, [("write", lambda: f(1, y=3))])
    assert [n for *_, n in TL.annotations(events, "mgard.")] == [
        "mgard.kernel.t"]


def test_flag1_spans_nest_under_their_calls(tmp_path, bfp_small):
    """The flag-1 main path (BFP cf stream and a BFP remainder): every span
    of the table that the CPU path runs, each inside its parent."""
    v = _field(SHAPE)
    box = {}

    def write():
        box["blob"], st = M.compress(v, 1e-3, device="cpu")
        assert st == 0

    def read():
        out, st = M.decompress(box["blob"], device="cpu")
        assert st == 0 and float(np.abs(out.numpy() - v).max()) <= 1e-3

    events = _traced_events(tmp_path, [("write", write), ("read", read)])
    assert _check_nesting(events, ("write", "read")) == FLAG1_SPANS


def test_flag0_spans_at_64cubed(tmp_path):
    v = torch.from_numpy(_field((64, 64, 64)))
    box = {}

    def write():
        box["blob"], _ = M.compress(v, 1e-3, device="cpu")

    def read():
        M.decompress(box["blob"], device="cpu")

    events = _traced_events(tmp_path, [("write", write), ("read", read)])
    seen = _check_nesting(events, ("write", "read"))
    assert {"api.compress", "api.decompress", "kernel.front",
            "kernel.remainder", "codec.lossless", "api.join"} <= seen


def test_raw_path_spans_and_counters(tmp_path):
    """A float64 REL stream at s = 0 (the raw MultiDim path with the L2
    correction): the five raw-path spans in their calls, and per call the
    levels, operator bytes, symbols and float64 sections counted; on the
    CPU every level step runs the dense operators, none K14."""
    shape = (33, 20, 9)
    v = torch.from_numpy(_field(shape).astype(np.float64))
    hier = M.get_hierarchy(shape, np.float64)
    box = {}

    def write():
        box["dw"] = _delta(lambda: box.update(blob=M.compress(
            v, 1e-3, 0.0, M.error_bound_type.REL, device="cpu")[0]))

    def read():
        box["dr"] = _delta(lambda: M.decompress(box["blob"], device="cpu"))

    events = _traced_events(tmp_path, [("write", write), ("read", read)])
    seen = _check_nesting(events, ("write", "read"))
    assert RAW_SPANS <= seen
    for kind, inverse in (("dw", False), ("dr", True)):
        d = box[kind]
        assert d["transform.levels"] == hier.l_target
        assert d["transform.dense_levels"] == hier.l_target
        assert "transform.kernel_levels" not in d
        assert d["transform.ops_bytes"] == TR.operator_bytes(
            hier, True, inverse) > 0
        assert d["quantize.symbols"] == v.numel() and d["raw.f64"] == 1


def _field4(shape):
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape],
                        indexing="ij")
    return (np.sin(2 * np.pi * (grids[0] + 3 * grids[2]))
            + 0.5 * np.cos(2 * np.pi * (grids[1] + 2 * grids[3])))


def test_slice_route_spans_and_counters(tmp_path):
    """A rank-4 float64 REL stream at s = 0 with an axis over
    ``refactor._FAST_MAX_AXIS`` (the slice route, as XGC's f0 takes it):
    per call one ``transform.slice_levels`` a level step; per level step
    one Thomas solve an axis over the coarse box, each counting the 2
    ceil(log2 n) passes of its two doubling scans over its n coarse nodes
    (``transform.scan_passes``) and the box's elements
    (``transform.solve_elems``); the ``transform.slice_level`` and
    ``transform.solve`` spans nested in the raw path's transform spans; no
    dense level. A field within the dense operators' axes counts none of
    the slice route's counters."""
    shape = (5, 5, 4200, 5)
    v = torch.from_numpy(_field4(shape))
    hier = M.get_hierarchy(shape, np.float64)
    assert not TR._use_fast(hier) and hier.l_target == 2
    coarse = [hier.level_shape[l - 1] for l in range(1, hier.l_target + 1)]
    passes = sum(2 * (n - 1).bit_length() for c in coarse for n in c)
    elems = sum(len(c) * int(np.prod(c)) for c in coarse)
    box = {}

    def write():
        box["dw"] = _delta(lambda: box.update(blob=M.compress(
            v, 1e-3, 0.0, M.error_bound_type.REL, device="cpu")[0]))

    def read():
        box["dr"] = _delta(lambda: M.decompress(box["blob"], device="cpu"))

    events = _traced_events(tmp_path, [("write", write), ("read", read)])
    seen = _check_nesting(events, ("write", "read"))
    assert RAW_SPANS | {"transform.slice_level", "transform.solve"} <= seen
    names = [n for *_, n in TL.annotations(events, "mgard.transform.")]
    assert names.count("mgard.transform.slice_level") == 2 * hier.l_target
    assert names.count("mgard.transform.solve") == 2 * hier.l_target * 4
    for kind in ("dw", "dr"):
        d = box[kind]
        assert d["transform.slice_levels"] == hier.l_target
        assert d["transform.scan_passes"] == passes
        assert d["transform.solve_elems"] == elems
        assert d["transform.levels"] == hier.l_target
        assert "transform.dense_levels" not in d
    dense = torch.from_numpy(_field4((5, 5, 33, 5)))
    d = _delta(lambda: M.decompress(M.compress(
        dense, 1e-3, 0.0, M.error_bound_type.REL, device="cpu")[0],
        device="cpu"))
    assert d["transform.dense_levels"] > 0
    assert not any(k in d for k in ("transform.slice_levels",
                                    "transform.scan_passes",
                                    "transform.solve_elems"))


def test_slice_tables_count_where_they_go_up():
    """The slice route's per-axis tables (lerp weights, mass stencil,
    restriction weights, Thomas factors) count in ``transform.put_bytes``
    each call where they go to a device other than the CPU (the meta
    device here), every byte of every table once, and not on the CPU."""
    shape = (5, 5, 4200, 5)
    hier = M.get_hierarchy(shape, np.float64)
    want = sum(al.lerp_t.nbytes + 3 * (len(al.h_ext) + 1) * al.h_ext.itemsize
               + al.rw_left.nbytes + al.rw_right.nbytes + al.fwd_f.nbytes
               + al.bwd_binv.nbytes + al.bwd_g.nbytes
               for axes in hier.axis[:hier.l_target] for al in axes)
    for dev, put in (("meta", want), ("cpu", 0)):
        v = torch.zeros(shape, dtype=torch.float64, device=dev)
        box = {}
        d = _delta(lambda: box.update(dec=TR.decompose(v, hier, True)))
        assert d.get("transform.put_bytes", 0) == put
        d = _delta(lambda: TR.recompose(box["dec"], hier, True))
        assert d.get("transform.put_bytes", 0) == put


def test_host_scratch_is_reused_per_thread():
    """The warm landing buffer of a bulk copy: one a process, the same
    memory for every size up to the largest asked for, a larger one after
    that; a fresh array, not kept, for a thread that finds it held and for
    a size above ``SCRATCH_CAP``."""
    import threading

    with trace.host_scratch(1000) as a:
        addr = a.__array_interface__["data"][0]
    with trace.host_scratch(600) as b:
        assert a.size == 1000 and b.size == 600
        assert b.__array_interface__["data"][0] == addr
        other = []
        t = threading.Thread(target=lambda: other.append(
            trace.host_scratch(10).__enter__()))
        t.start()
        t.join()
        assert other[0].size == 10 and other[0].base is not b.base
    with trace.host_scratch(5000) as c:
        assert c.size == 5000
    with trace.host_scratch(1000) as d:
        assert d.base is c.base
    with trace.host_scratch(trace.SCRATCH_CAP + 1) as e:
        assert e.base is None
    with trace.host_scratch(1000) as f:
        assert f.base is c.base


def test_hybrid_inf_opens_no_raw_span(tmp_path):
    """A Hybrid s = inf round trip (flag 0 at 64^3: its remainder runs the
    dense transform) opens none of the raw path's spans, so its transform
    stays in ``kernel.remainder``, and moves none of its counters; the
    transform counts the remainder's dense level steps and the operators
    it puts on the device, each way."""
    v = torch.from_numpy(_field((64, 64, 64)))
    box = {}

    def run():
        box["d"] = _delta(lambda: M.decompress(
            M.compress(v, 1e-3, device="cpu")[0], device="cpu"))

    events = _traced_events(tmp_path, [("write", run)])
    seen = _check_nesting(events, ("write",))
    assert "kernel.remainder" in seen and not RAW_SPANS & seen
    assert not any(k.startswith(("transform.levels", "transform.ops_bytes",
                                 "quantize.", "raw.")) for k in box["d"])
    assert box["d"]["transform.dense_levels"] > 0
    assert box["d"]["transform.put_bytes"] > 0
    assert "transform.kernel_levels" not in box["d"]


def test_mdr_spans_at_48cubed(tmp_path):
    v = torch.from_numpy(_field((48, 48, 48)))
    box = {}

    def write():
        box["md"] = mdr.MDRefactor(v, M.Config())

    def read():
        meta, data = box["md"]
        meta.prev_used = []
        mdr.MDRequest(meta, 1e-3)
        r = mdr.MDReconstruct(meta, data, device="cpu")
        assert float((r.data - v).abs().max()) <= 1e-3

    events = _traced_events(tmp_path, [("write", write), ("read", read)])
    assert _check_nesting(events, ("write", "read")) == MDR_SPANS
    # one plane-codec span a level, never one a plane
    levels = len(box["md"][0].levels)
    names = [n for *_, n in TL.annotations(events, "mgard.codec.plane_")]
    assert names.count("mgard.codec.plane_encode") == levels
    assert names.count("mgard.codec.plane_decode") <= levels


def test_launches_is_the_registrys_launch_group():
    assert kernels.LAUNCHES is trace.group("launch")
    kernels.LAUNCHES["bfp_encode"] += 2
    assert trace.counters()["launch.bfp_encode"] >= 2
    kernels.reset_launches()
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert "launch.probe_u16_butterfly" in trace.counters()


def test_count_snapshot_and_reset():
    trace.reset_counters()
    trace.count("t.a")
    trace.count("t.a", 4)
    snap = trace.counters()
    assert snap["t.a"] == 5
    trace.count("t.a")
    assert snap["t.a"] == 5 and trace.counters()["t.a"] == 6
    trace.reset_counters()
    assert trace.counters()["t.a"] == 0
    assert all(v == 0 for v in trace.counters().values())


def _delta(fn):
    before = trace.counters()
    fn()
    return {k: v - before.get(k, 0) for k, v in trace.counters().items()
            if v != before.get(k, 0)}


def test_stale_K_moves_rechoose(bfp_small):
    """The inputs of test_stale_sticky_K_rechoose: a coarser, then a finer
    tolerance on one shape."""
    v = _field((16, 128, 256))
    d1 = _delta(lambda: M.compress(v, 1e-2, device="cpu"))
    assert d1.get("bfp.k_cache.miss", 0) >= 1
    assert d1["hybrid.flag.1"] == 1 and "bfp.k_cache.rechoose" not in d1
    d2 = _delta(lambda: M.compress(v, 1e-4, device="cpu"))
    assert d2["bfp.k_cache.rechoose"] == 1 and d2["hybrid.flag.1"] == 1
    assert d2.get("bfp.k_cache.hit", 0) >= 1


def test_fused_stale_K_counts_the_fall_back_to_flag1(fresh_k_caches):
    """The inputs of test_fused_stale_K_falls_back_to_flag1_and_refreshes."""
    v = _field(FUSED_SHAPE)
    cfg = _fused_cfg()
    M.compress(v, 1e-2, config=cfg, device="cpu")
    d = _delta(lambda: M.compress(v, 1e-4, config=cfg, device="cpu"))
    assert d["hybrid.fallback.v3_to_v2"] == 1
    assert d["bfp.k_cache.rechoose"] == 1 and d["hybrid.flag.1"] == 1
    d = _delta(lambda: M.compress(v, 1e-4, config=cfg, device="cpu"))
    assert d["hybrid.flag.2"] == 1 and not any(
        k.startswith("hybrid.fallback") for k in d)


@pytest.mark.parametrize("K", [0, 6])
def test_fused_overflow_counts_the_fall_back_to_flag0(fresh_k_caches, K):
    """The inputs of test_fused_overflow_falls_back_to_flag0."""
    v = _field(FUSED_SHAPE)
    cfg = _fused_cfg(K)
    if not K:
        M.compress(v, 1e-3, config=cfg, device="cpu")
    v[3, 5, 7] = 1e4
    d = _delta(lambda: M.compress(v, 1e-3, config=cfg, device="cpu"))
    assert d["hybrid.fallback.to_flag0"] == 1 and d["hybrid.flag.0"] == 1
    assert "hybrid.flag.1" not in d and "hybrid.flag.2" not in d


def test_copy_counters_stay_zero_on_the_cpu(bfp_small):
    v = _field(SHAPE)

    def run():
        blob, _ = M.compress(v, 1e-3, device="cpu")
        M.decompress(blob, device="cpu")
        meta, data = mdr.MDRefactor(torch.from_numpy(v[:32, :32, :32]
                                                     .copy()), M.Config())
        mdr.MDRequest(meta, 1e-3)
        mdr.MDReconstruct(meta, data, device="cpu")

    d = _delta(run)
    assert not any(k.startswith("copy.") for k in d), d
    assert d["mdr.plane.bytes_in"] >= d["mdr.plane.bytes_out"] > 0
    assert sum(d.get(f"mdr.plane.{c}", 0) for c in ("raw", "zlib", "bfx")) \
        > 0


def test_copy_helpers_on_the_cpu_share_memory():
    a = np.arange(6, dtype=np.float32)
    t = trace.to_device(a, "cpu")
    assert t.data_ptr() == a.ctypes.data
    assert trace.to_host(t) is not None and trace.to_host(t)[5] == 5.0


PLAN_SIZES = {"0": 0, "1": 1, "chunk-1": trace.CHUNK - 1,
              "chunk": trace.CHUNK, "chunk+1": trace.CHUNK + 1,
              "3.5chunks": 7 * trace.CHUNK // 2,
              "9chunks+5": 9 * trace.CHUNK + 5}


@pytest.mark.parametrize("slots", [2, 3, 4])
@pytest.mark.parametrize("n", PLAN_SIZES.values(), ids=PLAN_SIZES.keys())
def test_chunk_plan_covers_the_bytes_once(n, slots):
    """A staged copy's steps tile [0, n) in order, full chunks but the
    last, and reuse a slot only every ``slots`` steps."""
    plan = trace.chunk_plan(n, trace.CHUNK, slots)
    assert [o for o, _, _ in plan] == list(range(0, n, trace.CHUNK))
    assert sum(size for _, size, _ in plan) == n
    assert all(size == trace.CHUNK for _, size, _ in plan[:-1])
    assert all(0 < size <= trace.CHUNK for _, size, _ in plan)
    assert [s for *_, s in plan] == [k % slots for k in range(len(plan))]
    assert trace.chunk_plan(n) == trace.chunk_plan(n, trace.CHUNK,
                                                   trace.SLOTS)


def test_bulk_copies_off_the_card_are_not_staged():
    """Only a CUDA device's copies take a ring: a bulk copy to the meta
    device or on the CPU counts as it did, and pins nothing."""
    a = np.arange(trace.STAGE_MIN, dtype=np.uint8)
    d = _delta(lambda: trace.to_device(a, "meta"))
    assert d == {"copy.htod.calls": 1, "copy.htod.bytes": a.nbytes}
    dst = np.zeros(a.nbytes + 1, np.uint8)
    assert not _delta(lambda: trace.to_host_into(torch.from_numpy(a),
                                                 dst[1:]))
    np.testing.assert_array_equal(dst[1:], a)
    assert trace.pinned_bytes() == 0
    assert trace.SLOTS * trace.CHUNK <= 128 * 10**6
    assert trace.CHUNK % 4096 == 0


def test_transform_operators_come_up_in_one_span(tmp_path):
    """A transform on a card copies every dense operator it applies before
    its first level, one copy each, in one ``copy.htod`` span (the meta
    device stands in for the card); on the CPU they are the host
    matrices."""
    hier = M.get_hierarchy((33, 17, 9), np.float32)
    levels = tuple(range(hier.l_target, 0, -1))
    for inverse, orthogonal in ((False, False), (True, False), (True, True)):
        host = {l: dict(TR._level_ops(hier, l, orthogonal, inverse))
                for l in levels}
        n = sum(len(h) for h in host.values())
        d = _delta(lambda: TR._device_ops(hier, levels, orthogonal, inverse,
                                          "cpu"))
        assert not d
        cpu = TR._device_ops(hier, levels, orthogonal, inverse, "cpu")
        box = {}
        events = _traced_events(tmp_path, [("write", lambda: box.update(
            d=_delta(lambda: box.update(ops=TR._device_ops(
                hier, levels, orthogonal, inverse, "meta")))))])
        assert box["d"]["copy.htod.calls"] == n
        assert [n for *_, n in TL.annotations(events, "mgard.")] == [
            "mgard.copy.htod"]
        for l in levels:
            assert set(box["ops"][l]) == set(host[l]) == set(cpu[l])
            for k, A in host[l].items():
                assert box["ops"][l][k].device.type == "meta"
                assert tuple(box["ops"][l][k].shape) == A.shape
                np.testing.assert_array_equal(cpu[l][k].numpy(), A)


def test_k14_tables_come_up_once_per_device():
    """K14's tables go to a device in one ``copy.htod`` on the first
    transform there and never after (the meta device stands in for the
    card), counted as they go up in ``transform.put_bytes``; the dense path
    counts its operators there on every call."""
    hier = Hierarchy((33, 18, 9), np.float64)
    size = sum(MD.level_table(hier, l).nbytes
               for l in range(1, hier.l_target + 1))
    d = _delta(lambda: MD._tables(hier, "meta"))
    assert d == {"copy.htod.calls": 1, "copy.htod.bytes": size,
                 "transform.put_bytes": size} and size > 0
    assert not _delta(lambda: MD._tables(hier, torch.device("meta")))
    v = torch.from_numpy(_field(hier.shape).astype(np.float64))
    for inverse, fn in ((False, TR.decompose), (True, TR.recompose)):
        d = _delta(lambda: fn(v, hier, True))
        assert d["transform.put_bytes"] == TR.operator_bytes(
            hier, True, inverse) > size


def test_log_time_lines_come_from_the_api_spans(capsys):
    v = _field((32, 32, 32))
    cfg = M.Config()
    cfg.log_level = log_mod.log.TIME
    old = log_mod.log.level
    try:
        blob, _ = M.compress(v, 1e-3, config=cfg, device="cpu")
        M.decompress(blob, config=cfg, device="cpu")
    finally:
        log_mod.log.level = old
    out = capsys.readouterr().out
    assert "compress total:" in out and "GB/s" in out
    assert "decompress total:" in out and "to enqueue" in out
    assert not hasattr(log_mod, "Timer")
    assert not hasattr(log_mod.log, "csv") and not hasattr(log_mod.log,
                                                            "dbg")


# ----------------------------------------------------------------------
# The readings of scripts/h100_trace_layers.py on synthetic events
# ----------------------------------------------------------------------
def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    _x("user_annotation", "bench.write", 0.0, 100.0),
    _x("user_annotation", "mgard.api.compress", 10.0, 80.0),
    _x("user_annotation", "mgard.kernel.front", 20.0, 30.0),
    _x("user_annotation", "mgard.copy.dtoh", 30.0, 10.0),
    _x("user_annotation", "mgard.codec.bfp_blob", 60.0, 20.0),
    # another thread's spans count for nothing
    _x("user_annotation", "mgard.codec.other", 0.0, 100.0, tid=2),
    _x("user_annotation", "bench.read", 200.0, 50.0),
    _x("user_annotation", "mgard.api.decompress", 200.0, 40.0),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 32.0, 6.0, tid=7),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 52.0, 4.0, tid=7),
    _x("kernel", "k", 22.0, 4.0, tid=7),
    _x("kernel", "k2", 210.0, 10.0, tid=7),
]


def test_layer_share_is_self_time_of_the_innermost_span():
    share = {lay: TL.layer_share(EVENTS, "write", lay)
             for lay in ("api", "codec", "copy", "kernel", None)}
    # api.compress 10-20, 50-60, 80-90; kernel.front 20-30, 40-50; copy
    # 30-40; codec 60-80; outside 0-10, 90-100
    assert share == pytest.approx({"api": 30.0, "codec": 20.0, "copy": 10.0,
                                   "kernel": 20.0, None: 20.0})
    assert sum(share.values()) == pytest.approx(100.0)
    assert TL.layer_share(EVENTS, "read", "api") == pytest.approx(80.0)
    assert TL.layer_share(EVENTS, "none", "api") is None


def test_span_share_is_self_time_by_span():
    assert TL.span_share(EVENTS, "write") == pytest.approx({
        "api.compress": 30.0, "kernel.front": 20.0, "codec.bfp_blob": 20.0,
        "(outside)": 20.0, "copy.dtoh": 10.0})
    assert TL.span_share(EVENTS, "none") == {}


def test_idle_by_span_sums_to_the_calls_idle_time():
    idle = TL.idle_by_span(EVENTS, "write")
    assert idle == pytest.approx({"(outside)": 20e-6, "api.compress": 26e-6,
                                  "kernel.front": 16e-6, "copy.dtoh": 4e-6,
                                  "codec.bfp_blob": 20e-6})
    busy = 4.0 + 6.0 + 4.0
    assert sum(idle.values()) == pytest.approx((100.0 - busy) * 1e-6)
    assert TL.idle_by_span(EVENTS, "read") == pytest.approx(
        {"api.decompress": 30e-6, "(outside)": 10e-6})


def test_dtoh_share_inside_copy_spans_and_span_counts():
    # 6 us of the first copy inside copy.dtoh, the second outside any
    assert TL.dtoh_in_copy_span(EVENTS, "write") == pytest.approx(60.0)
    assert TL.dtoh_in_copy_span(EVENTS, "read") is None
    assert TL.dtoh_outside(EVENTS, "write") == [
        (4.0, 4.0, 0, "mgard.api.compress", 4.0)]
    c = TL.span_counts(EVENTS, "write")
    assert c["calls"] == 1 and c["most"] == 4
    assert c["copies_by_parent"] == {"copy.dtoh in kernel.front": 1.0}


def test_segments_clamp_children_to_their_parent():
    segs = TL.segments([(0.0, 10.0, "a"), (5.0, 12.0, "b")], 0.0, 20.0)
    assert segs == [(0.0, 5.0, "a"), (5.0, 10.0, "b"), (10.0, 20.0, None)]
