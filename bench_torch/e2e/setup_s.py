"""Seconds from process start to the first timed call."""


def compute(run):
    return run.setup_s
