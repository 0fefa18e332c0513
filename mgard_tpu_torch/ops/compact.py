"""Stream compaction (port of ``mgard_tpu/ops/compact.py::masked_indices``)."""

from __future__ import annotations

import torch


def masked_indices(mask, cap: int, fill: int):
    """Indices of the first `cap` True entries of a flat bool mask, padded
    with `fill` (ascending order, deterministic): one exclusive-rank cumsum
    plus one scatter, as in the JAX package."""
    n = mask.shape[0]
    m32 = mask.to(torch.int32)
    rank = torch.cumsum(m32, 0, dtype=torch.int32) - m32
    slot = torch.where(mask & (rank < cap), rank, torch.full_like(rank, cap))
    idx = torch.full((cap + 1,), fill, dtype=torch.int32, device=mask.device)
    # slots are unique among the True entries; every dropped entry lands on
    # the extra slot `cap`, which is cut off below
    sel = slot < cap
    idx[slot[sel].long()] = torch.arange(n, dtype=torch.int32,
                                         device=mask.device)[sel]
    return idx[:cap]
