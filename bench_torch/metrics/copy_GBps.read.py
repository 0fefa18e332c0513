"""Bytes copied host-to-device in the read calls over those copies' device
time, in GB/s."""


def read(trace):
    return trace.copy_GBps("read", "HtoD")
