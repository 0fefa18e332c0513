"""Field bytes of all reads over the bytes those reads needed."""

import clock


def compute(run):
    return clock.ratio(run.calls)
