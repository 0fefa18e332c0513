"""Probe of the copies between a CUDA card and its host: what a stream's
bytes cost each way, pageable or through page-locked memory, and what the
first touch of a fresh destination's pages costs on this host.

    python3 scripts/h100_copy_probe.py [--sizes 80,150] [--runs 20] \
        [--sections 1,2,3,4,5] [--out build/copy_probe.jsonl]

For each size (MB of 10^6 bytes), the median of ``--runs`` runs of:

1. DtoH: pageable into a fresh ``bytes``, into a warm buffer, and into a
   pinned buffer;
2. the host leg "pinned -> fresh ``bytes``": one NumPy copy, one torch CPU
   ``copy_`` at the default intra-op threads, each again after
   ``madvise(MADV_HUGEPAGE)`` on the destination's page-aligned interior;
3. HtoD from a warm ``bytes``: pageable, and staged through one pinned
   buffer of its size;
4. the chunk-pipelined copies of ``utils/trace.py``'s ``PinnedRing`` at
   chunks of 4, 8, 16 and 32 MiB and 2, 3 and 4 slots: DtoH into a fresh
   ``bytes`` (with and without the advice) and HtoD from a warm one;
5. the first touch: the host leg on 1, 2, 4 and 8 threads; the
   destination faulted in first (``MADV_POPULATE_WRITE``, ``MADV_WILLNEED``,
   ``mlock``, one byte a page on 8 threads) or page-locked in place
   (``cudaHostRegister``) for a DMA straight into it; and, after a pageable
   and after a ring DtoH, the free of the ``bytes``, the next
   ``cudaMemGetInfo`` and a fixed Python loop.

It also prints what ``/sys/kernel/mm/transparent_hugepage/{enabled,defrag}``
read (it only reads them), the card, its power limit, the cores and torch's
intra-op threads. A fresh ``bytes`` is made as ``bytesink.join`` makes its
result; it is freed outside the timed region. One JSON line a measurement
(rates in GB/s of 10^9 bytes), then a summary line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mgard_tpu_torch.utils import bytesink, trace  # noqa: E402

PAGE = 4096
MADV_WILLNEED, MADV_HUGEPAGE, MADV_POPULATE_WRITE = 3, 14, 23
_libc = ctypes.CDLL(None, use_errno=True)
_libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
_libc.madvise.restype = ctypes.c_int
for _f in ("mlock", "munlock"):
    getattr(_libc, _f).argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    getattr(_libc, _f).restype = ctypes.c_int


def advise(blob, n: int, advice: int) -> int:
    """madvise(advice) on the page-aligned interior of ``blob``'s n bytes:
    0, or the errno."""
    ptr = bytesink._bytes_ptr(blob)
    lo, hi = -(-ptr // PAGE) * PAGE, (ptr + n) // PAGE * PAGE
    if _libc.madvise(lo, hi - lo, advice) != 0:
        return ctypes.get_errno()
    return 0


def fresh(n: int, huge: bool):
    """A new ``bytes`` of n bytes, as ``join`` makes one, and a writable
    uint8 view of it; with ``huge`` its page-aligned interior advised
    MADV_HUGEPAGE first (the madvise result: 0 or the errno)."""
    blob = bytesink._new_bytes(None, n)
    ptr = bytesink._bytes_ptr(blob)
    view = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,))
    return blob, view, advise(blob, n, MADV_HUGEPAGE) if huge else 0


def touch_pages(view, threads: int) -> None:
    """Write one byte a page of ``view`` on ``threads`` Python threads
    (NumPy's strided fill runs without the interpreter lock)."""
    step = -(-view.shape[0] // threads)

    def part(i):
        view[i * step:(i + 1) * step:PAGE] = 0

    ts = [threading.Thread(target=part, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable: {e}"


def timed(fn, runs: int, setup=None) -> float:
    """Median seconds of fn(ctx) over ``runs``; ``setup()`` makes ctx
    outside the timed region and is dropped after it."""
    secs = []
    for _ in range(runs):
        ctx = setup() if setup else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(ctx)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del ctx
    return statistics.median(secs)


def dtoh_probes(size_mb, n, src, warm, pinned, runs, emit):
    """1. DtoH: pageable into a fresh bytes and a warm buffer; pinned."""
    emit(size_mb, "dtoh pageable -> fresh bytes", timed(
        lambda c: torch.from_numpy(c[1]).copy_(src), runs,
        lambda: fresh(n, False)), n)
    emit(size_mb, "dtoh pageable -> warm buffer", timed(
        lambda c: torch.from_numpy(warm).copy_(src), runs), n)
    emit(size_mb, "dtoh -> pinned", timed(
        lambda c: pinned.copy_(src), runs), n)


def htod_probes(size_mb, n, host_t, pinned, dst, runs, emit):
    """3. HtoD from a warm source: pageable, and through one pinned
    buffer of its size."""
    emit(size_mb, "htod pageable (warm bytes)", timed(
        lambda c: dst.copy_(host_t), runs), n)

    def staged_whole(c):
        pinned.copy_(host_t)
        dst.copy_(pinned, non_blocking=True)

    emit(size_mb, "htod staged through one pinned buffer", timed(
        staged_whole, runs), n)


def first_touch_probes(size_mb, n, src, pinned, dev, runs, emit, lines):
    """5. The host leg's first touch: torch copy_ on 1-8 threads; the
    destination faulted in first (madvise POPULATE_WRITE or WILLNEED,
    mlock, one byte a page on 8 threads), that step timed with the copy;
    and what a 150 MB bytes filled each way costs after the copy: its free,
    the next cudaMemGetInfo, and a fixed Python loop."""
    base = torch.get_num_threads()
    for k in (1, 2, 4, 8):
        torch.set_num_threads(k)
        emit(size_mb, f"host pinned -> fresh bytes, torch copy_ on {k} "
             f"threads", timed(lambda c: torch.from_numpy(c[1]).copy_(
                 pinned), runs, lambda: fresh(n, False)), n)
    torch.set_num_threads(base)
    rcs = {}
    for adv, name in ((MADV_POPULATE_WRITE, "MADV_POPULATE_WRITE"),
                      (MADV_WILLNEED, "MADV_WILLNEED")):
        def prefaulted(c, adv=adv, name=name):
            rcs[name] = advise(c[0], n, adv)
            torch.from_numpy(c[1]).copy_(pinned)

        emit(size_mb, f"host pinned -> fresh bytes after {name}, torch "
             f"copy_", timed(prefaulted, runs, lambda: fresh(n, False)), n)

    def locked(c):
        ptr = bytesink._bytes_ptr(c[0])
        rcs["mlock"] = _libc.mlock(ptr, n) and ctypes.get_errno()
        torch.from_numpy(c[1]).copy_(pinned)
        _libc.munlock(ptr, n)

    emit(size_mb, "host pinned -> fresh bytes after mlock, torch copy_",
         timed(locked, runs, lambda: fresh(n, False)), n)

    def touched(c):
        touch_pages(c[1], 8)
        torch.from_numpy(c[1]).copy_(pinned)

    emit(size_mb, "host pinned -> fresh bytes after a touch a page on 8 "
         "threads, torch copy_", timed(touched, runs,
                                       lambda: fresh(n, False)), n)
    cudart = torch.cuda.cudart()

    def registered(c):
        ptr = bytesink._bytes_ptr(c[0])
        rcs["cudaHostRegister"] = int(cudart.cudaHostRegister(ptr, n, 0))
        torch.from_numpy(c[1]).copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        cudart.cudaHostUnregister(ptr)

    emit(size_mb, "dtoh -> fresh bytes registered (cudaHostRegister, "
         "DMA, unregister)", timed(registered, runs,
                                   lambda: fresh(n, False)), n)
    up = bytes(pinned.numpy())
    dst = torch.empty(n, dtype=torch.uint8, device=dev)

    def registered_up(c):
        ptr = bytesink._bytes_ptr(up)
        cudart.cudaHostRegister(ptr, n, 0)
        dst.copy_(torch.frombuffer(up, dtype=torch.uint8), non_blocking=True)
        torch.cuda.synchronize()
        cudart.cudaHostUnregister(ptr)

    emit(size_mb, "htod from a warm bytes registered (cudaHostRegister, "
         "DMA, unregister)", timed(registered_up, runs), n)
    print(json.dumps({"MB": size_mb, "rc": rcs}), flush=True)
    ring = trace.PinnedRing(dev)
    fills = {"pageable DtoH": lambda v: torch.from_numpy(v).copy_(src),
             "ring DtoH": lambda v: ring.dtoh(src, torch.from_numpy(v))}
    for name, fill in fills.items():
        free_s, info_s, loop_s = [], [], []
        for _ in range(runs):
            blob, view, _ = fresh(n, False)
            fill(view)
            torch.cuda.synchronize()
            del view
            t0 = time.perf_counter()
            del blob
            t1 = time.perf_counter()
            torch.cuda.mem_get_info(dev)
            t2 = time.perf_counter()
            sum(range(200_000))
            t3 = time.perf_counter()
            free_s.append(t1 - t0)
            info_s.append(t2 - t1)
            loop_s.append(t3 - t2)
        rec = {"MB": size_mb, "what": f"after a {name} into a fresh bytes",
               "free_ms": statistics.median(free_s) * 1e3,
               "mem_get_info_ms": statistics.median(info_s) * 1e3,
               "python_loop_ms": statistics.median(loop_s) * 1e3}
        print(json.dumps(rec), flush=True)
        lines.append(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="80,150")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", default="")
    ap.add_argument("--sections", default="1,2,3,4,5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the probe measures the card's host",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {
        "card": torch.cuda.get_device_name(dev), "nvidia_smi": smi.strip(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "cpu_count": os.cpu_count(),
        "affinity": len(os.sched_getaffinity(0)),
        "torch_threads": torch.get_num_threads(),
        "thp_enabled": _read("/sys/kernel/mm/transparent_hugepage/enabled"),
        "thp_defrag": _read("/sys/kernel/mm/transparent_hugepage/defrag"),
        "runs": args.runs}
    lines = [head]
    print(json.dumps(head), flush=True)

    def emit(size_mb, what, secs, n):
        rec = {"MB": size_mb, "what": what, "ms": round(secs * 1e3, 4),
               "GBps": round(n / secs / 1e9, 4)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    runs = args.runs
    secs = {int(x) for x in args.sections.split(",")}
    for size_mb in (int(s) for s in args.sizes.split(",")):
        n = size_mb * 10**6
        gen = torch.Generator(device=dev).manual_seed(size_mb)
        src = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                            generator=gen)
        want = src.cpu().numpy()
        warm = np.empty(n, np.uint8)
        warm[:] = 1
        pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        pinned.copy_(src)
        host_blob = want.tobytes()  # a warm bytes of the same content
        host_t = torch.from_numpy(np.frombuffer(host_blob, np.uint8).copy())
        dst = torch.empty(n, dtype=torch.uint8, device=dev)

        rc = None
        if 1 in secs:
            dtoh_probes(size_mb, n, src, warm, pinned, runs, emit)
        # 2. the host leg
        pin_np = pinned.numpy()
        for huge in (False, True) if 2 in secs else ():
            tag = " +MADV_HUGEPAGE" if huge else ""
            emit(size_mb, "host pinned -> fresh bytes, numpy" + tag, timed(
                lambda c: np.copyto(c[1], pin_np), runs,
                lambda h=huge: fresh(n, h)), n)
            emit(size_mb, "host pinned -> fresh bytes, torch copy_" + tag,
                 timed(lambda c: torch.from_numpy(c[1]).copy_(pinned), runs,
                       lambda h=huge: fresh(n, h)), n)
        if 2 in secs:
            _, _, rc = fresh(n, True)
            emit(size_mb, "host pinned -> warm buffer, torch copy_", timed(
                lambda c: torch.from_numpy(warm).copy_(pinned), runs), n)
        if 3 in secs:
            htod_probes(size_mb, n, host_t, pinned, dst, runs, emit)
        # 4. the ring, chunk-pipelined
        for chunk_mib in (4, 8, 16, 32) if 4 in secs else ():
            for slots in (2, 3, 4):
                ring = trace.PinnedRing(dev, chunk_mib << 20, slots)
                # check once that the ring moves the bytes unchanged
                blob, view, _ = fresh(n, False)
                ring.dtoh(src, torch.from_numpy(view))
                if not np.array_equal(view, want):
                    raise AssertionError(f"ring dtoh {chunk_mib} MiB x "
                                         f"{slots}: bytes differ")
                ring.htod(host_t, dst)
                if not torch.equal(dst, src):
                    raise AssertionError(f"ring htod {chunk_mib} MiB x "
                                         f"{slots}: bytes differ")
                del blob, view
                tag = f"chunk {chunk_mib} MiB x {slots} slots"
                for huge in (False, True):
                    adv = " +MADV_HUGEPAGE" if huge else ""
                    emit(size_mb, f"ring dtoh -> fresh bytes{adv}, {tag}",
                         timed(lambda c: ring.dtoh(src, torch.from_numpy(
                             c[1])), runs, lambda h=huge: fresh(n, h)), n)
                emit(size_mb, f"ring htod (warm bytes), {tag}", timed(
                    lambda c: ring.htod(host_t, dst), runs), n)
                del ring
        if 5 in secs:
            first_touch_probes(size_mb, n, src, pinned, dev, runs, emit,
                               lines)
        del src, pinned, dst, host_t
        torch.cuda.empty_cache()
        lines.append({"MB": size_mb, "madvise_rc": rc})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    print(json.dumps({"ok": True, "measurements": len(lines) - 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
