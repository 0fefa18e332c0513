"""The yardstick of the kernel rooflines: the card's published peak and the
bytes a call has to move.

A call's least device time is the field's bytes plus the stream's bytes,
each moved once, over the HBM peak. These bytes depend only on the call's
inputs and outputs, not on which kernels compute it, so a fused or split
kernel cannot make the count stale. Every share is printed with the card's
power limit beside it: a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12


def call_bytes(field_bytes: int, stream_bytes: int) -> int:
    """Bytes a write or read call moves at the least: the field and the
    stream (an MDR refactor's stored bytes, an MDR read's fetched bytes)."""
    return int(field_bytes) + int(stream_bytes)


def least_seconds(field_bytes: int, stream_bytes: int) -> float:
    return call_bytes(field_bytes, stream_bytes) / HBM_BYTES_PER_S


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or a note
    that it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power.limit not read ({e})"
    line = out.stdout.strip().splitlines()
    return line[0] if line and out.returncode == 0 else (
        f"power.limit not read (rc {out.returncode})")
