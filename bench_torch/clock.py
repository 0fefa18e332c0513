"""Host-clock records of the calls in a window, and the arithmetic of the
end-to-end metrics over all of them (sums and tails, never a best-of)."""

from __future__ import annotations

import contextlib
import statistics
import time


class Recorder:
    """Times each call on the host clock, from its start to the end of a
    device synchronisation after it, and keeps one record per call."""

    def __init__(self, sync, annotate=None):
        self.sync = sync
        self.annotate = annotate
        self.calls = []

    def call(self, kind: str, fn, field_bytes: int):
        """Run fn as one call of ``kind`` ("write" or "read"); returns
        (fn's result, the call's record). The caller sets the record's
        ``stream_bytes``."""
        ctx = (self.annotate(f"bench.{kind}") if self.annotate
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            t1 = time.perf_counter()
        rec = {"kind": kind, "t0": t0, "seconds": t1 - t0,
               "field_bytes": int(field_bytes), "stream_bytes": None}
        self.calls.append(rec)
        return out, rec


def of_kind(calls, kind):
    return [c for c in calls if c["kind"] == kind]


def rate_GBps(calls, kind):
    """Field bytes of the ``kind`` calls over their summed seconds, in
    GB/s (1e9 bytes), or None without such calls."""
    cs = of_kind(calls, kind)
    if not cs:
        return None
    return sum(c["field_bytes"] for c in cs) / sum(c["seconds"]
                                                    for c in cs) / 1e9


def ratio(calls):
    """Field bytes of all reads over the bytes those reads needed."""
    cs = of_kind(calls, "read")
    if not cs:
        return None
    return (sum(c["field_bytes"] for c in cs)
            / sum(c["stream_bytes"] for c in cs))


def percentile_ms(calls, kind, pct: int):
    """The pct-th percentile (linear between ranks) of the latencies of
    every ``kind`` call, in ms; None with fewer than two calls."""
    xs = [c["seconds"] * 1e3 for c in of_kind(calls, kind)]
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=100, method="inclusive")[pct - 1]
