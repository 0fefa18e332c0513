"""The least time of the read calls' device work (field and stream bytes,
each moved once, at the HBM peak) over the kernel time inside them, in %."""

import roofline


def read(trace):
    secs = trace.kernel_seconds("read")
    if secs <= 0:
        return None
    least = sum(roofline.least_seconds(c["field_bytes"], c["stream_bytes"])
                for c in trace.of_kind("read"))
    return 100.0 * least / secs
