"""Streams written by the reference MGARD-X library (port of the signature
check of ``mgard_tpu/formats/ref_stream.py``).

A reference stream starts ``b"MGARD" | header_size: u64 LE | ...``; this
package's own streams start with ``b"MGARDTPU"`` (``metadata.MAGIC``). Only
the check is ported so far: ``decompress`` raises ``NotImplementedError``
for a reference stream (ROADMAP queue 1 item 12 ports the decoder) instead
of reading it as a corrupt header of its own.
"""

from __future__ import annotations

SIGNATURE = b"MGARD"


def sniff(blob: bytes) -> bool:
    """True when the bytes start with the reference MGARD signature (and not
    this framework's MGARDTPU magic)."""
    return blob[:5] == SIGNATURE and blob[5:8] != b"TPU"
