"""Per-layer self time of the port's calls, read from its ``mgard.*`` spans.

    python3 scripts/h100_trace_layers.py --cell NAME [--seed N]
        [--seconds S] [--device cuda|cpu] [--size N] [--out FILE]

For one benchmark cell (``bench_torch/cells/``; one process a cell, since a
cell's ``env`` is set before the program's import), the cell's set-up and
one warm request, then ``--seconds`` of requests under ``torch.profiler`` (CPU
and CUDA activities), each call inside the harness's ``bench.write`` /
``bench.read`` annotation. From the one exported trace, per kind of call:

- ``layer_share``: the share of the calls' wall time in which the
  innermost open ``mgard.*`` span on the caller's thread belongs to each
  layer (``api``, ``codec``, ``copy``, ``kernel``, ``transform``) or to none
  (``outside``), in %: each layer's self time;
- ``span_share``: the same split by the innermost span itself, in %;
- ``idle_by_span``: device-idle seconds inside the calls by the innermost
  open span, beside the device-idle seconds of the harness's
  ``device_idle.*`` reading (``bench_torch/devtrace.py``);
- ``dtoh_in_copy_span``: the share of the device's DtoH memcpy time inside
  the calls that lies inside a ``copy.dtoh`` span, on the profiler's
  clock, with no offset;
- spans a call (most, mean), the spans by name, the copy spans by their
  parent span, and the window's change in every counter of
  ``mgard_tpu_torch.utils.trace``.

Before the window it times ``span()`` with no profiler, ``count()``, and
``span()`` while a profiler records (the cost a span adds to a traced
call). ``--device cpu --size 48`` rehearses the whole script on the CPU;
a CPU run gives no device number. The readings are one JSON object,
printed, and written to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_torch")
LAYERS = ("api", "codec", "copy", "kernel", "transform")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# ----------------------------------------------------------------------
# Readings of a chrome trace's events (pure: the tests feed them)
# ----------------------------------------------------------------------
def annotations(events, prefix: str):
    """(tid, start, end, name) of the user annotations named prefix*."""
    out = []
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(prefix)):
            ts = float(e["ts"])
            out.append((e.get("tid"), ts, ts + float(e.get("dur", 0.0)),
                        e["name"]))
    return out


def calls_of(events, kind: str):
    """(tid, start, end) of the ``bench.<kind>`` annotations."""
    name = f"bench.{kind}"
    return [(t, a, b) for t, a, b, n in annotations(events, name)
            if n == name]


def segments(spans, a: float, b: float):
    """[(t0, t1, name or None)] covering [a, b]: the innermost open span of
    ``spans`` ((start, end, name), nested, one thread) at each instant."""
    out, stack, t = [], [], a

    def close_until(s):
        nonlocal t
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if e <= a or s >= b:
            continue
        s = max(s, a)
        close_until(s)
        if s > t:
            out.append((t, s, stack[-1][1] if stack else None))
            t = s
        stack.append((min(e, b, stack[-1][0]) if stack else min(e, b),
                      name))
    close_until(b)
    if b > t:
        out.append((t, b, None))
    return out


def _layer(name):
    return None if name is None else name[len("mgard."):].split(".", 1)[0]


def call_segments(events, kind: str):
    """[(call (tid, start, end), its segments)] of the ``kind`` calls."""
    spans = collections.defaultdict(list)
    for tid, s, e, name in annotations(events, "mgard."):
        spans[tid].append((s, e, name))
    return [((tid, a, b), segments(spans[tid], a, b))
            for tid, a, b in calls_of(events, kind)]


def layer_share(events, kind: str, layer) -> float | None:
    """Share of the ``kind`` calls' wall time whose innermost open span on
    the caller's thread is of ``layer`` (None: no span open), in %."""
    segs = call_segments(events, kind)
    wall = sum(b - a for (_, a, b), _ in segs)
    if wall <= 0:
        return None
    own = sum(t1 - t0 for _, ss in segs for t0, t1, n in ss
              if _layer(n) == layer)
    return 100.0 * own / wall


def span_share(events, kind: str) -> dict:
    """Share of the ``kind`` calls' wall time whose innermost open span on
    the caller's thread is each span ("(outside)" where none is open), in
    %: each span's self time, largest first."""
    segs = call_segments(events, kind)
    wall = sum(b - a for (_, a, b), _ in segs)
    tot = collections.Counter()
    for _, ss in segs:
        for t0, t1, name in ss:
            tot[name[len("mgard."):] if name else "(outside)"] += t1 - t0
    return ({n: 100.0 * v / wall for n, v in tot.most_common()}
            if wall > 0 else {})


def device_busy(events):
    """Merged [start, end] intervals with a kernel, copy or memset."""
    out = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur",
                                                                     0.0)))
                       for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_in(busy, starts, a: float, b: float) -> float:
    """Microseconds of [a, b] inside the merged intervals ``busy`` (whose
    starts are ``starts``)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0.0
    while i < len(busy) and busy[i][0] < b:
        tot += max(0.0, min(busy[i][1], b) - max(busy[i][0], a))
        i += 1
    return tot


def idle_by_span(events, kind: str) -> dict:
    """Device-idle seconds in the ``kind`` calls by the innermost open
    program span ("(outside)" where none is open)."""
    busy = device_busy(events)
    starts = [s for s, _ in busy]
    tot = collections.Counter()
    for _, segs in call_segments(events, kind):
        for t0, t1, name in segs:
            idle = (t1 - t0) - busy_in(busy, starts, t0, t1)
            if idle > 0:
                tot[name[len("mgard."):] if name else "(outside)"] += \
                    idle / 1e6
    return dict(tot.most_common())


def dtoh_in_copy_span(events, kind: str) -> float | None:
    """Share of the DtoH memcpy device time starting inside the ``kind``
    calls that lies inside a ``copy.dtoh`` span of the calling thread."""
    spans = collections.defaultdict(list)
    for tid, s, e, name in annotations(events, "mgard.copy.dtoh"):
        spans[tid].append((s, e))
    copies = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"])
    total = covered = 0.0
    for tid, a, b in calls_of(events, kind):
        mine = [(s, e) for s, e in spans[tid] if e > a and s < b]
        for s, e in copies:
            if a <= s < b:
                total += e - s
                covered += sum(max(0.0, min(e, y) - max(s, x))
                               for x, y in mine)
    return 100.0 * covered / total if total > 0 else None


def dtoh_outside(events, kind: str, top: int = 8) -> list:
    """The DtoH copies of the ``kind`` calls with the most device time
    outside any ``copy.dtoh`` span: (us outside, us long, bytes, the
    innermost span open on the calling thread when the copy started, us
    from the copy's end to the end of that span)."""
    out = []
    for (tid, a, b), segs in call_segments(events, kind):
        spans = [(s, e) for t, s, e, n in annotations(events,
                                                      "mgard.copy.dtoh")
                 if t == tid and e > a and s < b]
        for e in events:
            if not (e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                    and "DtoH" in e["name"]):
                continue
            s0 = float(e["ts"])
            s1 = s0 + float(e.get("dur", 0))
            if not a <= s0 < b:
                continue
            cov = sum(max(0.0, min(s1, y) - max(s0, x)) for x, y in spans)
            if s1 - s0 - cov > 0.01:
                seg = next((g for g in segs if g[0] <= s0 < g[1]), None)
                out.append((s1 - s0 - cov, s1 - s0,
                            int(e.get("args", {}).get("bytes", 0)),
                            seg[2] if seg else None,
                            (seg[1] - s1) if seg else None))
    return sorted(out, reverse=True)[:top]


def span_counts(events, kind: str) -> dict:
    """Per ``kind`` call: the most and mean spans, the mean count of each
    span name, and of each copy span by its parent span."""
    by_tid = collections.defaultdict(list)
    for tid, s, e, name in annotations(events, "mgard."):
        by_tid[tid].append((s, e, name[len("mgard."):]))
    per_call, names, parents = [], collections.Counter(), \
        collections.Counter()
    calls = calls_of(events, kind)
    for tid, a, b in calls:
        mine = sorted(((s, e, n) for s, e, n in by_tid[tid] if a <= s < b),
                      key=lambda x: (x[0], -x[1]))
        per_call.append(len(mine))
        stack = []
        for s, e, n in mine:
            while stack and stack[-1][1] <= s:
                stack.pop()
            names[n] += 1
            if n.startswith("copy."):
                parents[f"{n} in {stack[-1][2] if stack else '(call)'}"] += 1
            stack.append((s, e, n))
    k = max(len(calls), 1)
    return {"calls": len(calls), "most": max(per_call, default=0),
            "mean": sum(per_call) / k,
            "by_name": {n: c / k for n, c in names.most_common()},
            "copies_by_parent": {n: c / k for n, c in parents.most_common()}}


# ----------------------------------------------------------------------
# The run
# ----------------------------------------------------------------------
def _costs(trace, torch, acts) -> dict:
    """Per-call costs in microseconds: span() and count() with no profiler,
    and an empty span while a profiler records."""
    def per(fn, n):
        t0 = time.perf_counter()
        fn(n)
        return (time.perf_counter() - t0) / n * 1e6

    def spans(n):
        for _ in range(n):
            with trace.span("api.cost"):
                pass

    def calls(n):
        for _ in range(n):
            trace.span("api.cost")

    def counts(n):
        for _ in range(n):
            trace.count("cost.probe")

    out = {"span_call_off_us": per(calls, 200_000),
           "span_with_off_us": per(spans, 200_000),
           "count_us": per(counts, 200_000)}
    with torch.profiler.profile(activities=acts):
        out["span_with_on_us"] = per(spans, 5_000)
    return out


def run_cell(name, seed, seconds, device, size):
    import torch

    for p in (BENCH, REPO):
        if p not in sys.path:
            sys.path.insert(0, p)
    import clock
    import devtrace
    import field
    import registry

    roots = (BENCH,)
    cell = registry.cell(roots, name)
    cfg = dict(registry.config(roots, cell["config"]))
    if size:
        cfg["shape"] = [size] * len(cfg["shape"])
    for k, v in cell.get("env", {}).items():
        os.environ[k] = str(v)
    import mgard_tpu_torch as program
    from mgard_tpu_torch.utils import trace

    device = torch.device(device)
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    traffic = registry.traffic(roots, cell["traffic"]).Traffic(
        program, cell["params"], cfg, device)
    pool = field.make_pool(cfg, seed, device)
    traffic.request(pool[0], clock.Recorder(sync))
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    costs = _costs(trace, torch, acts)

    rec = clock.Recorder(sync, torch.profiler.record_function)
    before = trace.counters()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            t0, i = time.perf_counter(), 0
            while i == 0 or time.perf_counter() - t0 < seconds:
                traffic.request(pool[i % len(pool)], rec)
                i += 1
    after = trace.counters()
    d = tempfile.mkdtemp(prefix="trace_layers_")
    try:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(d, ignore_errors=True)

    tr = devtrace.Trace(events, rec.calls)
    kinds = sorted({c["kind"] for c in rec.calls})
    out = {"cell": name, "seed": seed, "requests": i,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "shape": cfg["shape"], "costs_us": costs,
           "counters": {k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)},
           "kinds": {}}
    for kind in kinds:
        cs = tr.of_kind(kind)
        wall_s = sum(c["span"][1] - c["span"][0] for c in cs) / 1e6
        shares = {lay: layer_share(events, kind, lay) for lay in LAYERS}
        shares["outside"] = layer_share(events, kind, None)
        idle = tr.idle_share(kind)
        ibs = idle_by_span(events, kind)
        out["kinds"][kind] = {
            "calls": len(cs), "wall_s": wall_s,
            "host_s_per_call": [c["seconds"] for c in cs][:3],
            "layer_share": shares,
            "span_share": dict(list(span_share(events, kind).items())[:15]),
            "device_idle_s": (None if idle is None
                              else idle / 100.0 * wall_s),
            "idle_by_span_s": sum(ibs.values()) if ibs else None,
            "idle_by_span": dict(list(ibs.items())[:15]),
            "dtoh_in_copy_span": dtoh_in_copy_span(events, kind),
            "dtoh_outside": dtoh_outside(events, kind),
            "spans": span_counts(events, kind)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2400000017)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=0,
                    help="per-axis size in place of the configuration's")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 3
    res = run_cell(args.cell, args.seed, args.seconds, args.device,
                   args.size)
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
