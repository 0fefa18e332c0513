"""Share of the read calls' wall time in which the card runs neither a
kernel nor a copy (the host's hold on the chip), in %."""


def read(trace):
    return trace.idle_share("read")
