"""Lossless section framing: ``<BQ`` (backend id, inner payload size)
followed by the backend's blob (port of ``mgard_tpu/lossless/registry.py``
for the BFP and BFX backends; the others, the zstd second stage included,
are ROADMAP queue 1 item 11)."""

from __future__ import annotations

import struct

from ..dtypes import lossless_type
from ..utils.trace import traced
from . import bfp, bfx

_HDR = "<BQ"  # backend id, inner payload size


def section_parts(lt: lossless_type, blob_parts) -> list:
    """Frame a backend blob (bytesink parts) as one lossless section."""
    from ..utils.bytesink import parts_size

    return [struct.pack(_HDR, int(lt), parts_size(blob_parts))] + blob_parts


@traced("codec.lossless")
def lossless_decompress(data: bytes, offset: int = 0, device="cpu"):
    """Returns (int32 symbols on device, bytes consumed)."""
    bt, inner_size = struct.unpack_from(_HDR, data, offset)
    lt = lossless_type(bt)
    p = offset + struct.calcsize(_HDR)
    if p + inner_size > len(data):
        raise ValueError("truncated lossless payload")
    consumed = struct.calcsize(_HDR) + inner_size
    codec = {lossless_type.BFP: bfp, lossless_type.BFX: bfx}.get(lt)
    if codec is None:
        raise NotImplementedError(
            f"lossless backend {lt.name} is not ported yet (ROADMAP queue 1 "
            "item 11)")
    syms, _ = codec.decode(data, p, device)
    return syms, consumed
