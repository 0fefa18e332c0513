"""Idle share, copy rate, kernel roofline and breakdown from a synthetic
profiler trace."""

import pytest

import devtrace
import registry
import roofline
from conftest import BENCH


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


EVENTS = [
    _x("user_annotation", "bench.window", 0.0, 1000.0),
    _x("user_annotation", "bench.write", 100.0, 300.0),
    _x("user_annotation", "bench.read", 500.0, 200.0),
    _x("cpu_op", "aten::mul", 140.0, 20.0),
    _x("cuda_runtime", "cudaLaunchKernel", 145.0, 2.0, correlation=7),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)",
       150.0, 50.0, correlation=7),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 200.0, 100.0,
       bytes=1_000_000),
    _x("kernel", "hybrid_inv_v2_kernel(float*)", 550.0, 50.0),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 600.0, 50.0,
       bytes=500_000),
    _x("kernel", "outside_the_window", 2000.0, 10.0),
]
CALLS = [
    {"kind": "write", "t0": 100e-6, "seconds": 300e-6,
     "field_bytes": 10_000_000, "stream_bytes": 6_750_000},
    {"kind": "read", "t0": 500e-6, "seconds": 200e-6,
     "field_bytes": 10_000_000, "stream_bytes": 6_750_000},
]


@pytest.fixture
def trace():
    samples = [(400e-6, "x.py:f"), (450e-6, "lossless/bfp.py:_blob_parts"),
               (500e-6, "mdr/api.py:MDRefactor")]
    return devtrace.Trace(EVENTS, CALLS, samples)


def test_idle_share_and_copy_rate(trace):
    assert registry.layer_metric([BENCH], "device_idle.write").read(
        trace) == pytest.approx(50.0)
    assert registry.layer_metric([BENCH], "device_idle.read").read(
        trace) == pytest.approx(50.0)
    assert registry.layer_metric([BENCH], "copy_GBps.write").read(
        trace) == pytest.approx(10.0)
    assert registry.layer_metric([BENCH], "copy_GBps.read").read(
        trace) == pytest.approx(10.0)
    assert trace.busy_s() == pytest.approx(250e-6)
    assert trace.window_s() == pytest.approx(1000e-6)


def test_kernel_roofline_counts_the_calls_bytes(trace):
    # 16.75 MB at 3.35 TB/s is 5 us against 50 us of kernels in each call
    assert roofline.least_seconds(10_000_000, 6_750_000) == pytest.approx(
        5e-6)
    for kind in ("write", "read"):
        assert registry.layer_metric([BENCH], f"kernel_roofline.{kind}").read(
            trace) == pytest.approx(10.0)


def test_breakdown_names_ops_and_idle_host(trace):
    ops = dict(trace.device_ops())
    assert ops["aten::mul"] == pytest.approx(50e-6)
    assert ops["hybrid_inv_v2_kernel"] == pytest.approx(50e-6)
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(100e-6)
    assert "outside_the_window" not in ops
    idle = dict(trace.idle_by_host())
    assert idle["lossless/bfp.py:_blob_parts"] == pytest.approx(50e-6)
    assert idle["mdr/api.py:MDRefactor"] == pytest.approx(50e-6)


def test_no_device_events_reads_nothing():
    t = devtrace.Trace([e for e in EVENTS if e["cat"] == "user_annotation"],
                      CALLS)
    assert t.copy_GBps("write", "DtoH") is None
    assert registry.layer_metric([BENCH], "kernel_roofline.write").read(
        t) is None
    assert t.idle_share("write") is None
