"""Slicing primitives of the multigrid transform.

The port of ``mgard_tpu/ops/_be.py``. ``sl``, ``concat``, ``update_box``
and ``zeros`` serve the dense-matrix path of ``ops/refactor.py`` on torch
tensors (``sl`` also slices NumPy arrays). ``pad_zero`` and ``linrec`` are
the host NumPy oracle that ``ops/axis.py``'s mass/restriction and
tridiagonal solve run on, which ``refactor._corr_matrix`` probes with
identity columns; they have no torch branch, as the JAX module's NumPy
branch has no JAX one.
"""

from __future__ import annotations

import numpy as np
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


# ----------------------------------------------------------------------
# Host NumPy oracle
# ----------------------------------------------------------------------
def pad_zero(v: np.ndarray, axis: int, before: int, after: int):
    if before == 0 and after == 0:
        return v
    cfg = [(0, 0)] * v.ndim
    cfg[axis] = (before, after)
    return np.pad(v, cfg)


def linrec(d: np.ndarray, f, axis: int, reverse: bool):
    """First-order linear recurrence along `axis`, a sequential sweep:
    y_i = d_i + f_i * y_{i-1} (or i+1 when reversed)."""
    n = d.shape[axis]
    y = np.array(d)  # copy
    ysw = np.moveaxis(y, axis, 0)
    fsw = np.moveaxis(np.broadcast_to(f, d.shape), axis, 0)
    rng = range(n - 2, -1, -1) if reverse else range(1, n)
    step = 1 if reverse else -1
    for i in rng:
        ysw[i] = ysw[i] + fsw[i] * ysw[i + step]
    return y
