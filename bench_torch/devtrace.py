"""The traced run: torch.profiler (CPU and CUDA activities) over the
window, a sampler of what the host's main thread runs, and the readings the
per-layer metrics take from them.

Device activity is every kernel, copy and memset of the profiler's trace.
Calls are located by the harness's ``bench.write`` / ``bench.read``
annotations, matched in order to the host-clock records of the calls.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import shutil
import sys
import tempfile
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PROGRAM = "mgard_tpu_torch" + os.sep


class Sampler(threading.Thread):
    """Every ``period`` seconds, the innermost frame of the program (else
    the innermost frame) that the main thread runs, as 'file:function'."""

    def __init__(self, period: float = 0.002):
        super().__init__(daemon=True)
        self.period = period
        self.main = threading.main_thread().ident
        self.samples = []
        self._stop_evt = threading.Event()

    @staticmethod
    def label(frame) -> str:
        inner = frame
        f = frame
        while f is not None:
            path = f.f_code.co_filename
            if _PROGRAM in path:
                rel = path.split(_PROGRAM, 1)[1]
                return f"{rel}:{f.f_code.co_name}"
            f = f.f_back
        return (f"{os.path.basename(inner.f_code.co_filename)}:"
                f"{inner.f_code.co_name}")

    def run(self):
        while not self._stop_evt.wait(self.period):
            frame = sys._current_frames().get(self.main)
            if frame is not None:
                self.samples.append((time.perf_counter(), self.label(frame)))

    def stop(self):
        self._stop_evt.set()
        self.join()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Device intervals and call spans of one traced window, in the
    profiler's clock (microseconds)."""

    def __init__(self, events, calls, samples=()):
        self.device = []  # (start, end, name, cat, bytes)
        spans = collections.defaultdict(list)
        window = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(
                e.get("dur", 0.0))
            name = e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name, cat,
                                    int(e.get("args", {}).get("bytes", 0))))
            elif cat == "user_annotation" and name.startswith("bench."):
                if name == "bench.window":
                    window.append((ts, ts + dur))
                else:
                    spans[name[len("bench."):]].append((ts, ts + dur))
        self.device.sort()
        self._dev_starts = [d[0] for d in self.device]
        self.busy = _merge([(a, b) for a, b, *_ in self.device])
        self._starts = [a for a, _ in self.busy]
        self.window = window[0] if window else None
        # the i-th annotation of a kind is the i-th host record of it
        self.calls = []
        seen = collections.Counter()
        offsets = []
        for c in calls:
            k = c["kind"]
            lst = spans.get(k, [])
            if seen[k] < len(lst):
                a, b = lst[seen[k]]
                self.calls.append(dict(c, span=(a, b)))
                offsets.append(a - c["t0"] * 1e6)
            seen[k] += 1
        offsets.sort()
        self.offset = offsets[len(offsets) // 2] if offsets else None
        self.samples = ([(t * 1e6 + self.offset, lab) for t, lab in samples]
                        if self.offset is not None else [])
        # (kernel name, start) -> the op that launched it
        corr = _kernel_op_map(events)
        self.launcher = {
            (e["name"], float(e["ts"])): corr[e["args"]["correlation"]]
            for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in corr}

    # -- device time ---------------------------------------------------
    def busy_in(self, a: float, b: float) -> float:
        """Microseconds in [a, b] in which the device ran anything."""
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        tot = 0.0
        while i < len(self.busy) and self.busy[i][0] < b:
            s, e = self.busy[i]
            tot += max(0.0, min(e, b) - max(s, a))
            i += 1
        return tot

    def in_span(self, a: float, b: float, cat=None):
        """Device events that start inside [a, b) (of ``cat``)."""
        lo = bisect.bisect_left(self._dev_starts, a)
        hi = bisect.bisect_left(self._dev_starts, b)
        return [d for d in self.device[lo:hi] if cat is None or d[3] == cat]

    def of_kind(self, kind):
        return [c for c in self.calls if c["kind"] == kind]

    def idle_share(self, kind):
        """Share of the ``kind`` calls' wall time with nothing on the
        device, in %; None for a trace that holds no device activity."""
        cs = self.of_kind(kind)
        wall = sum(c["span"][1] - c["span"][0] for c in cs)
        if not self.device or not cs or wall <= 0:
            return None
        busy = sum(self.busy_in(*c["span"]) for c in cs)
        return 100.0 * (1.0 - busy / wall)

    def kernel_seconds(self, kind):
        return sum(d[1] - d[0] for c in self.of_kind(kind)
                   for d in self.in_span(*c["span"], cat="kernel")) / 1e6

    def copy_GBps(self, kind, direction: str):
        """Bytes of the ``direction`` ('DtoH', 'HtoD') copies inside the
        ``kind`` calls over those copies' device time, in GB/s."""
        nbytes = secs = 0.0
        for c in self.of_kind(kind):
            for d in self.in_span(*c["span"], cat="gpu_memcpy"):
                if direction in d[2] and d[4] > 0:
                    nbytes += d[4]
                    secs += (d[1] - d[0]) / 1e6
        return nbytes / secs / 1e9 if secs > 0 else None

    # -- the traced window ---------------------------------------------
    def window_span(self):
        if self.window:
            return self.window
        spans = [c["span"] for c in self.calls]
        return (min(a for a, _ in spans), max(b for _, b in spans))

    def busy_s(self):
        return self.busy_in(*self.window_span()) / 1e6

    def window_s(self):
        a, b = self.window_span()
        return (b - a) / 1e6

    def device_ops(self, top=10):
        """Device seconds by operation: the torch op or C entry point that
        launched a kernel, or the copy's kind."""
        tot = collections.Counter()
        for s, e, name, cat, _ in self.in_span(*self.window_span()):
            tot[self.op_name(name, cat, s)] += (e - s) / 1e6
        return [[k, v] for k, v in tot.most_common(top)]

    def op_name(self, name, cat, ts):
        if cat != "kernel":
            return name
        return self.launcher.get((name, ts), _short(name))

    def idle_by_host(self, top=10):
        """Device-idle seconds in the window by what the host ran then
        (each sample stands for the time since the previous one)."""
        a, b = self.window_span()
        tot = collections.Counter()
        prev = None
        for t, lab in self.samples:
            if prev is not None and a <= prev and t <= b:
                idle = (t - prev) - self.busy_in(prev, t)
                if idle > 0:
                    tot[lab] += idle / 1e6
            prev = t
        return [[k, v] for k, v in tot.most_common(top)]


def _short(name: str) -> str:
    """A kernel's name without its argument list and template arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s[5:] if s.startswith("void ") else s


def _kernel_op_map(events):
    """correlation id -> the innermost cpu_op around its runtime call."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime"):
            by_tid[e.get("tid")].append(e)
    corr = {}
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []
        for e in evs:
            ts = float(e["ts"])
            while stack and float(stack[-1]["ts"]) + float(
                    stack[-1].get("dur", 0)) <= ts:
                stack.pop()
            if e["cat"] == "cpu_op":
                stack.append(e)
            elif stack:
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    corr[c] = stack[-1]["name"]
    return corr


class Tracer:
    """Profiles the window: enter before it, exit after it, then read()."""

    def __init__(self):
        import torch

        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.sampler = Sampler()

    def __enter__(self):
        self.prof.__enter__()
        self.sampler.start()
        return self

    def __exit__(self, *exc):
        self.sampler.stop()
        self.prof.__exit__(*exc)
        return False

    def read(self, calls) -> Trace:
        d = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return Trace(events, calls, self.sampler.samples)
