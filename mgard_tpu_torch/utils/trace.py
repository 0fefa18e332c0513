"""Stage spans and counters of the port.

``span(name)`` brackets one stage. While no torch profiler records, it
returns one shared no-op object (the only cost is one read of the
profiler's enabled flag); while one records, it is
``torch.profiler.record_function("mgard." + name)``, so the stage lands in
the profiler's trace as a ``user_annotation`` on the caller's thread, on
the same clock as the kernels and copies, nested under the stage that
encloses it. Wrap a job in ``torch.profiler.profile(activities=[CPU,
CUDA])`` to see the ``mgard.*`` ranges on the kernels' timeline. A span
never synchronises the device, reads a tensor or changes what runs.

The first part of a name is its layer:

- ``api``: entry points, metadata, stream assembly;
- ``codec``: host codec stages, the MDR plane codec and planner;
- ``copy``: host-device copies (``to_host`` / ``to_device`` below);
- ``kernel``: host time spent issuing device work (torch ops, the ctypes
  launches, the dense transforms).

Spans sit at stage granularity, never inside a per-superblock,
per-element or per-plane loop.

``count(key, n)`` bumps an always-on integer counter of one registry,
grouped by the key's first dotted part; ``counters()`` is a flat snapshot
and ``reset_counters()`` zeroes every counter. The ``launch`` group is
``kernels.LAUNCHES``.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd import profiler as _profiler


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """Context manager of the stage ``name`` ("<layer>.<stage>")."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function("mgard." + name)


def traced(name: str):
    """Decorator: every call of the function is one ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function("mgard." + name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ----------------------------------------------------------------------
# Counters
# ----------------------------------------------------------------------
_GROUPS: dict = {}


def group(name: str) -> dict:
    """The live dict of one counter group (created empty)."""
    return _GROUPS.setdefault(name, {})


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` ("<group>.<name>")."""
    g, _, k = key.partition(".")
    d = _GROUPS.get(g)
    if d is None:
        d = _GROUPS[g] = {}
    d[k] = d.get(k, 0) + n


def counters() -> dict:
    """Snapshot of every counter, by its full key."""
    return {f"{g}.{k}": v for g, d in _GROUPS.items() for k, v in d.items()}


def reset_counters() -> None:
    """Zero every counter (the keys stay)."""
    for d in _GROUPS.values():
        for k in d:
            d[k] = 0


# ----------------------------------------------------------------------
# Host-device copies
# ----------------------------------------------------------------------
def to_host(t):
    """The values of tensor ``t`` as a host NumPy array. A device tensor is
    copied in a ``copy.dtoh`` span (the host waits for the work queued
    ahead of it) and counted; a CPU tensor is returned as it is."""
    if t.device.type == "cpu":
        return t.numpy()
    with span("copy.dtoh"):
        h = t.cpu()
    count("copy.dtoh.calls")
    count("copy.dtoh.bytes", h.nbytes)
    return h.numpy()


def to_host_into(t, dst, stream=None) -> None:
    """Copy the bytes of contiguous tensor ``t`` into the host uint8 array
    ``dst`` (of their size; any alignment), e.g. a region of a stream being
    assembled. A device tensor is copied in a ``copy.dtoh`` span and
    counted, like ``to_host``, ordered on ``stream`` (a torch CUDA stream;
    default the current one): a copy made on another thread than the work
    that wrote ``t`` passes that work's stream."""
    src = t.reshape(-1).view(torch.uint8)
    if t.device.type == "cpu":
        torch.from_numpy(dst).copy_(src)
        return
    with span("copy.dtoh"), torch.cuda.stream(stream):
        torch.from_numpy(dst).copy_(src)
    count("copy.dtoh.calls")
    count("copy.dtoh.bytes", dst.nbytes)


def to_device(a, device):
    """Host data ``a`` (a NumPy array or a CPU tensor) as a tensor on
    ``device``: a copy in a ``copy.htod`` span, counted, for a device other
    than the CPU; on the CPU a tensor over the same memory."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type == "cpu" or t.device.type != "cpu":
        return t.to(device)
    with span("copy.htod"):
        out = t.to(device)
    count("copy.htod.calls")
    count("copy.htod.bytes", t.nbytes)
    return out


def to_device_each(arrays, device) -> list:
    """``to_device`` of each host array (one copy each), all in one
    ``copy.htod`` span: for the copies of a stage that would otherwise
    open a span a level or a plane."""
    ts = [torch.as_tensor(a) for a in arrays]
    device = torch.device(device)
    if device.type == "cpu" or not ts:
        return ts
    with span("copy.htod"):
        out = [t.to(device) for t in ts]
    count("copy.htod.calls", len(ts))
    count("copy.htod.bytes", sum(t.nbytes for t in ts))
    return out
