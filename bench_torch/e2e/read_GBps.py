"""Field bytes rebuilt over the summed seconds of the read calls."""

import clock


def compute(run):
    return clock.rate_GBps(run.calls, "read")
