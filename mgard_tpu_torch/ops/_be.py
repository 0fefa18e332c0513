"""Slicing primitives of the multigrid transform on torch tensors.

The port of the pieces of ``mgard_tpu/ops/_be.py`` that the dense-matrix
fast path of ``ops/refactor.py`` uses. The JAX module also dispatches to
NumPy for its host oracle; the port runs on torch tensors only.
"""

from __future__ import annotations

import torch


def sl(v, axis: int, start: int, stop: int, stride: int = 1):
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(start, stop, stride)
    return v[tuple(idx)]


def concat(parts, axis: int):
    return torch.cat(parts, dim=axis)


def update_box(v, box, ndim: int):
    """Write `box` into the leading corner of a copy of `v`."""
    out = v.clone()
    out[tuple(slice(0, s) for s in box.shape)] = box
    return out


def zeros(shape, dtype, like):
    return torch.zeros(shape, dtype=dtype, device=like.device)
