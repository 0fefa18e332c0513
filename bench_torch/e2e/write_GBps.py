"""Field bytes written over the summed seconds of the write calls."""

import clock


def compute(run):
    return clock.rate_GBps(run.calls, "write")
