"""The port's benchmark: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name under bench_torch/ (see
registry.py); a cell's ``env`` sets knobs of the program's environment
before the program is imported. Set-up makes the configuration's timestep
fields on the card from the seed and runs one request (loading or building
the kernels and warming the cell's shapes); then one caller runs requests back to back for
``--seconds``. With ``--trace 0`` the last line of standard output gives
the cell's end-to-end metrics, from the host clock around calls that end in
a device synchronisation, over every call of the window; with ``--trace 1``
its per-layer metrics, from torch.profiler over the window. A sample of the
requests, drawn from the seed, is then compared with the plain reference
(reference.py); each number compared is printed beside its limit. The run
exits non-zero, with no result, without as many CUDA devices as the cell
asks for.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

BENCH_ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(BENCH_ROOT)
for _p in (BENCH_ROOT, REPO_ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import clock  # noqa: E402
import field  # noqa: E402
import registry  # noqa: E402
from traffic import RequestFailed  # noqa: E402


class Run:
    """What the end-to-end metrics read: the calls and the set-up."""

    def __init__(self, calls, setup_s):
        self.calls, self.setup_s = calls, setup_s


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device, roots=(BENCH_ROOT,), t_start: float = T_START,
             tf32: bool = False) -> tuple:
    """One run of cell ``name``. Returns the result line's object and every
    number of the comparison (the worst over the kept requests). With
    ``tf32`` the program's float32 matmuls run in TF32 (the control)."""
    device = torch.device(device)
    entry = next(w for w in spec["workloads"] if w["name"] == name)
    cell = registry.cell(roots, name)
    cfg = registry.config(roots, cell["config"])
    e2e, layer = registry.cell_metrics(spec, name)

    # the cell's settings of the program's environment knobs, made before
    # the program is imported (it reads them then)
    for k, v in cell.get("env", {}).items():
        os.environ[k] = str(v)
    import mgard_tpu_torch as program

    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    sync = _sync(device)
    traffic = registry.traffic(roots, cell["traffic"]).Traffic(
        program, cell["params"], cfg, device)
    pool = field.make_pool(cfg, seed, device)
    traffic.request(pool[0], clock.Recorder(sync))
    sync()
    setup_s = time.perf_counter() - t_start
    _say(f"set-up {setup_s:.3f} s: {len(pool)} fields of "
         f"{tuple(pool[0].shape)} {cfg['dtype']}, one request warmed")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracer = annotate = None
    if trace:
        import devtrace

        tracer = devtrace.Tracer()
        annotate = torch.profiler.record_function
    rec = clock.Recorder(sync, annotate)
    k = int(cell["samples"])
    rng = random.Random(seed)
    kept = []  # reservoir of (request index, field index, outputs)
    attempted = failed = 0
    window = contextlib.ExitStack()
    if trace:
        window.enter_context(tracer)
        window.enter_context(annotate("bench.window"))
    with window:
        t0 = time.perf_counter()
        while attempted == 0 or time.perf_counter() - t0 < seconds:
            f = attempted % len(pool)
            try:
                out = traffic.request(pool[f], rec)
            except RequestFailed as e:
                failed += 1
                _say(f"request {attempted} failed: {e}")
                out = None
            if out is not None:
                if len(kept) < k:
                    kept.append((attempted, f, out))
                else:
                    j = rng.randrange(attempted + 1)
                    if j < k:
                        kept[j] = (attempted, f, out)
            attempted += 1
            del out
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    _say(f"window {window_s:.3f} s: {attempted} requests, {failed} failed, "
         f"{len(rec.calls)} calls")

    metrics, dev = {}, {}
    breakdown = None
    if trace:
        import roofline

        tr = tracer.read(rec.calls)
        for m in layer:
            v = registry.layer_metric(roots, m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        limit = roofline.power_limit()
        for m in layer:
            if "roofline" in m["name"] and m["name"] in metrics:
                _say(f"{m['name']} {metrics[m['name']]['value']} % of "
                     f"{roofline.HBM_BYTES_PER_S:.3e} B/s, card: {limit}")
        ops = tr.device_ops(top=25)
        for op, secs in ops:
            _say(f"device op {op}: {secs * 1e3:.4f} ms in the window "
                 f"({len(tr.calls)} calls)")
        dev = {"busy_s": tr.busy_s(), "window_s": tr.window_s(),
               "power_limit": limit}
        breakdown = {"device_ops": ops[:10], "idle_gaps": tr.idle_by_host()}
    else:
        run = Run(rec.calls, setup_s)
        for m in e2e:
            v = registry.e2e_metric(roots, m["name"]).compute(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the comparison with the plain reference, on the kept requests
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {}
    for i, f, out in sorted(kept, key=lambda t: t[0]):
        nums = traffic.check(out, pool[f])
        _say(f"request {i} (field {f}): " + ", ".join(
            f"{n} {v!r}" for n, v in nums.items()))
        for n, v in nums.items():
            worst[n] = max(worst.get(n, v), v)
    limits = cell["limits"]
    checks = {n: [worst.get(n, math.inf), lim] for n, lim in limits.items()}
    correct = (failed == 0 and bool(kept) and all(
        lim is not None and v <= lim for v, lim in checks.values()))

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": int(entry["chips"]),
                   "memory_peak_bytes": int(peak), **dev}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    for n, (v, lim) in checks.items():
        _say(f"check {n} {v!r} limit {lim!r}")
    return result, worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    names = [w["name"] for w in spec["workloads"]]
    if args.workload not in names:
        _say(f"unknown workload {args.workload!r}; cells: {names}")
        return 2
    chips = next(int(w["chips"]) for w in spec["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"the cell needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             ": no result")
        return 3
    result, _ = run_cell(spec, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
