"""Leveled logging + stage timers.

Mirrors the reference's log/Timer utilities (reference:
include/mgard-x/RuntimeX/Utilities/Log.h:13-48 — bitmask levels
ERR/INFO/TIME/DBG with ANSI prefixes, csv append — and Timer.hpp:28-45 —
print(name, bytes) -> wall time + GB/s). Config.log_level drives the mask
via Config.apply()-equivalent assignment to `log.level`.
"""

from __future__ import annotations

import sys
import time


class _Log:
    ERR = 1
    INFO = 2
    TIME = 4
    DBG = 8

    def __init__(self):
        self.level = self.ERR

    def err(self, msg: str):
        if self.level & self.ERR:
            print(f"\x1b[31m[err]\x1b[0m {msg}", file=sys.stderr)

    def warn(self, msg: str):
        if self.level & self.ERR:
            print(f"\x1b[33m[warn]\x1b[0m {msg}", file=sys.stderr)

    def info(self, msg: str):
        if self.level & self.INFO:
            print(f"\x1b[32m[info]\x1b[0m {msg}")

    def time(self, msg: str):
        if self.level & self.TIME:
            print(f"\x1b[34m[time]\x1b[0m {msg}")

    def dbg(self, msg: str):
        if self.level & self.DBG:
            print(f"\x1b[36m[dbg]\x1b[0m {msg}")

    def csv(self, path: str, values):
        with open(path, "a") as f:
            f.write(",".join(str(v) for v in values) + "\n")


log = _Log()


class Timer:
    """Stage timer printing throughput like the reference Timer::print."""

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.time()

    def end(self):
        if self._t0 is not None:
            self._elapsed += time.time() - self._t0
            self._t0 = None

    def get(self) -> float:
        return self._elapsed

    def clear(self):
        self._t0 = None
        self._elapsed = 0.0

    def print(self, name: str, nbytes: int | None = None):
        if nbytes:
            log.time(
                f"{name}: {self._elapsed*1e3:.2f} ms "
                f"({nbytes/max(self._elapsed,1e-12)/1e9:.3f} GB/s)"
            )
        else:
            log.time(f"{name}: {self._elapsed*1e3:.2f} ms")
