"""Bytes copied device-to-host in the write calls over those copies' device
time, in GB/s."""


def read(trace):
    return trace.copy_GBps("write", "DtoH")
