"""The least time of the write calls' device work (field and stream bytes,
each moved once, at the HBM peak) over the kernel time inside them, in %."""

import roofline


def read(trace):
    secs = trace.kernel_seconds("write")
    if secs <= 0:
        return None
    least = sum(roofline.least_seconds(c["field_bytes"], c["stream_bytes"])
                for c in trace.of_kind("write"))
    return 100.0 * least / secs
