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
- ``copy``: host-device copies (``to_host`` / ``to_device`` below; the
  bulk ones through a device's ``PinnedRing``);
- ``kernel``: host time spent issuing device work (torch ops, the ctypes
  launches, the dense transforms);
- ``transform``: the slice path's level steps and Thomas solves
  (``ops/refactor.py``), inside a ``kernel`` stage.

Spans sit at stage granularity, never inside a per-superblock,
per-element or per-plane loop.

``count(key, n)`` bumps an always-on integer counter of one registry,
grouped by the key's first dotted part; ``counters()`` is a flat snapshot
and ``reset_counters()`` zeroes every counter. The ``launch`` group is
``kernels.LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
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
_COUNT_LOCK = threading.Lock()  # copies on several threads count at once


def group(name: str) -> dict:
    """The live dict of one counter group (created empty)."""
    return _GROUPS.setdefault(name, {})


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` ("<group>.<name>")."""
    g, _, k = key.partition(".")
    with _COUNT_LOCK:
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
# A bulk copy, of at least STAGE_MIN bytes between the host and a CUDA
# device, goes through the device's PinnedRing in CHUNK-byte chunks: the
# DMA of one chunk runs at the link's rate while the host copies the chunk
# before it between its slot and the host buffer, in one torch CPU copy_
# over the intra-op threads. A pageable copy instead runs the host leg on
# one thread of the CUDA runtime, which is also what touches a fresh
# destination's pages first. The constants come from
# scripts/h100_copy_probe.py and scripts/h100_ring_shapes.py on the card's
# host (PERF.md §5): the larger the chunk, the faster a fresh destination
# filled (4-8 MiB at about the pageable rate, two slots of 64 MiB the best
# shape tried), and the ring stays within 128 MB of pinned memory. CHUNK
# is a multiple of the page.
STAGE_MIN = 8 << 20
CHUNK = 64 * 10**6
SLOTS = 2


def chunk_plan(n: int, chunk: int = CHUNK, slots: int = SLOTS) -> list:
    """The steps of a staged copy of ``n`` bytes: (offset, size, slot) of
    chunk k at k * chunk in slot k % slots, the last one the rest."""
    return [(o, min(chunk, n - o), (o // chunk) % slots)
            for o in range(0, n, chunk)]


class PinnedRing:
    """``slots`` page-locked host buffers of ``chunk`` bytes for the copies
    of one CUDA device, each with the event of the last DMA that used it:
    no slot is written while a DMA that uses it is in flight. One copy at a
    time holds the ring; a copy that finds it held returns None, and its
    caller copies directly."""

    def __init__(self, device, chunk: int = CHUNK, slots: int = SLOTS):
        self.device = torch.device(device)
        self.chunk, self.slots = chunk, slots
        self.buf = torch.empty((slots, chunk), dtype=torch.uint8,
                               pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(slots)]
        self.lock = threading.Lock()

    def dtoh(self, src, dst):
        """Copy the device's uint8 tensor ``src`` into the CPU uint8 tensor
        ``dst`` (any alignment), ordered on the current stream; returns the
        number of chunks once every byte is in ``dst``."""
        if not self.lock.acquire(blocking=False):
            return None
        try:
            stream = torch.cuda.current_stream(self.device)
            plan = chunk_plan(src.numel(), self.chunk, self.slots)

            def issue(k):
                o, n, s = plan[k]
                stream.wait_event(self.events[s])
                self.buf[s, :n].copy_(src[o:o + n], non_blocking=True)
                self.events[s].record(stream)

            for k in range(min(self.slots, len(plan))):
                issue(k)
            for k, (o, n, s) in enumerate(plan):
                self.events[s].synchronize()
                dst[o:o + n].copy_(self.buf[s, :n])
                if k + self.slots < len(plan):
                    issue(k + self.slots)
            return len(plan)
        finally:
            self.lock.release()

    def htod(self, src, dst):
        """Copy the CPU uint8 tensor ``src`` into the device's uint8 tensor
        ``dst`` on the current stream; returns the number of chunks with
        the last DMAs queued (a slot's next user waits for its event)."""
        if not self.lock.acquire(blocking=False):
            return None
        try:
            stream = torch.cuda.current_stream(self.device)
            plan = chunk_plan(src.numel(), self.chunk, self.slots)
            for o, n, s in plan:
                self.events[s].synchronize()
                self.buf[s, :n].copy_(src[o:o + n])
                dst[o:o + n].copy_(self.buf[s, :n], non_blocking=True)
                self.events[s].record(stream)
            return len(plan)
        finally:
            self.lock.release()


_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


def pinned_ring(device) -> PinnedRing:
    """The process's ring of CUDA ``device`` (with its index), made on
    first use."""
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = PinnedRing(device)
    return ring


def pinned_bytes() -> int:
    """Page-locked bytes the rings hold (at most SLOTS * CHUNK a device)."""
    return sum(r.buf.numel() for r in _RINGS.values())


def _bulk(device, nbytes: int) -> bool:
    """Whether a copy of ``nbytes`` to or from ``device`` is staged."""
    return device.type == "cuda" and nbytes >= STAGE_MIN


def _staged(copy, device, src, dst) -> bool:
    """Whether ``copy`` (``PinnedRing.dtoh`` or ``.htod``) moved the uint8
    ``src`` of a bulk copy into ``dst`` through the ring of ``device``; one
    that finds the ring busy counts ``copy.direct.calls`` and is left to
    the caller."""
    chunks = copy(pinned_ring(device), src, dst)
    if chunks is None:
        count("copy.direct.calls")
        return False
    count("copy.staged.calls")
    count("copy.staged.bytes", src.numel())
    count("copy.staged.chunks", chunks)
    return True


SCRATCH_CAP = 256 << 20  # bytes: a 384^3 float32 level's bit planes fit
_SCRATCH_LOCK = threading.Lock()
_SCRATCH = [None]


@contextlib.contextmanager
def host_scratch(nbytes: int):
    """A host uint8 array of ``nbytes`` for a bulk copy whose bytes the
    caller uses, or copies out, inside the ``with`` block. The process
    keeps one such buffer, grown to the largest size asked for up to
    ``SCRATCH_CAP``, so its pages stay warm from one call to the next: a
    fresh buffer of this size, mapped anew by the allocator, is faulted in
    by the copy at the first touch's pace (PERF.md §5). A request above
    the cap, or one made while another thread holds the buffer, gets a
    fresh array that is dropped after the block."""
    if nbytes > SCRATCH_CAP or not _SCRATCH_LOCK.acquire(blocking=False):
        yield np.empty(nbytes, np.uint8)
        return
    try:
        if _SCRATCH[0] is None or _SCRATCH[0].size < nbytes:
            _SCRATCH[0] = None
            _SCRATCH[0] = np.empty(nbytes, np.uint8)
        yield _SCRATCH[0][:nbytes]
    finally:
        _SCRATCH_LOCK.release()


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
    that wrote ``t`` passes that work's stream. A bulk copy is staged."""
    src = t.reshape(-1).view(torch.uint8)
    out = torch.from_numpy(dst)
    if t.device.type == "cpu":
        out.copy_(src)
        return
    with span("copy.dtoh"), torch.cuda.stream(stream):
        if not (_bulk(src.device, src.numel())
                and _staged(PinnedRing.dtoh, src.device, src, out)):
            out.copy_(src)
    count("copy.dtoh.calls")
    count("copy.dtoh.bytes", dst.nbytes)


def to_device(a, device):
    """Host data ``a`` (a NumPy array or a CPU tensor) as a tensor on
    ``device``: a copy in a ``copy.htod`` span, counted, for a device other
    than the CPU (a bulk copy of a contiguous ``a`` staged, the result's
    last DMAs queued on the current stream); on the CPU a tensor over the
    same memory."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type == "cpu" or t.device.type != "cpu":
        return t.to(device)
    with span("copy.htod"):
        if not (_bulk(device, t.nbytes) and t.is_contiguous()):
            out = t.to(device)
        else:
            out = torch.empty(t.shape, dtype=t.dtype, device=device)
            if not _staged(PinnedRing.htod, out.device,
                           t.reshape(-1).view(torch.uint8),
                           out.reshape(-1).view(torch.uint8)):
                out.copy_(t)
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
