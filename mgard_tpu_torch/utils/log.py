"""Leveled logging.

Mirrors the reference's log utility (reference:
include/mgard-x/RuntimeX/Utilities/Log.h:13-48 — bitmask levels
ERR/INFO/TIME/DBG with ANSI prefixes). Config.log_level drives the mask
via Config.apply()-equivalent assignment to `log.level`. Stage timing is
``utils/trace.py``'s spans.
"""

from __future__ import annotations

import sys


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


log = _Log()

