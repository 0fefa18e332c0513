"""The 90th percentile of the latency of every write call, in ms."""

import clock


def compute(run):
    return clock.percentile_ms(run.calls, "write", 90)
