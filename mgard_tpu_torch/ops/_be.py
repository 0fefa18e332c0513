"""Dual-backend primitive shim: NumPy (host oracle) / torch (device path).

The port of ``mgard_tpu/ops/_be.py``. The per-axis operators of
``ops/axis.py`` and the split/lerp/merge ("slice") transform of
``ops/refactor.py`` are written once against this small op set: with NumPy
inputs they run eagerly on the host (the correctness oracle, which
``refactor._corr_matrix`` also probes with identity columns), with torch
tensors they run on the tensor's own device in the tensor's own type.

``linrec`` is the one operator whose two branches differ in kind: NumPy
sweeps sequentially; torch has no associative scan, so the tensor branch
is a log-depth doubling scan over the (f, d) pairs, which counts each of
its steps in ``transform.scan_passes`` as it runs. ``asarray_like`` counts
the bytes of a table it puts on a device other than the CPU in
``transform.put_bytes``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import count


def is_np(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def sl(v, axis: int, start: int, stop: int, stride: int = 1):
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(start, stop, stride)
    return v[tuple(idx)]


def pad_zero(v, axis: int, before: int, after: int):
    if before == 0 and after == 0:
        return v
    if is_np(v):
        cfg = [(0, 0)] * v.ndim
        cfg[axis] = (before, after)
        return np.pad(v, cfg)
    parts = []
    for n in (before, after):
        shape = list(v.shape)
        shape[axis] = n
        parts.append(torch.zeros(shape, dtype=v.dtype, device=v.device))
    return torch.cat([parts[0], v, parts[1]], dim=axis)


def concat(parts, axis: int):
    if is_np(parts[0]):
        return np.concatenate(parts, axis=axis)
    return torch.cat(parts, dim=axis)


def stack2_reshape(a, b, axis: int):
    """Interleave two equal-shaped arrays along `axis`:
    returns shape with axis doubled, entries a0,b0,a1,b1,..."""
    if is_np(a):
        stacked = np.stack([a, b], axis=axis + 1)
    else:
        stacked = torch.stack([a, b], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = 2 * a.shape[axis]
    return stacked.reshape(shape)


def update_box(v, box, ndim: int):
    """Write `box` into the leading corner of a copy of `v`."""
    out = v.copy() if is_np(v) else v.clone()
    out[tuple(slice(0, s) for s in box.shape)] = box
    return out


def zeros(shape, dtype, like):
    if is_np(like):
        return np.zeros(shape, dtype)
    return torch.zeros(tuple(shape), dtype=dtype, device=like.device)


def asarray_like(table, like, shape=None):
    """Bring a host table into the computation; reshape for broadcasting."""
    if is_np(like):
        arr = np.asarray(table)
    else:
        arr = torch.as_tensor(np.ascontiguousarray(table), device=like.device)
        if like.device.type != "cpu":
            count("transform.put_bytes", arr.nbytes)
    if shape is not None:
        arr = arr.reshape(shape)
    return arr


def linrec(d, f, axis: int, reverse: bool):
    """First-order linear recurrence along `axis`:
    y_i = d_i + f_i * y_{i-1} (or i+1 when reversed); f_0 is not read.

    NumPy: a sequential sweep (the host oracle). torch: a doubling scan.
    Element i carries the affine map y_i = D_i + F_i * y_{i-k} over the k
    elements before it; one step composes it with the map k places back,
    (F_i, D_i) <- (F_i * F_{i-k}, D_i + F_i * D_{i-k}), and doubles k, so
    ceil(log2 n) steps finish every element (20 at 2^20). F depends on the
    table alone, so it stays a vector along the axis. |f| < 1 for the mass
    matrix's Thomas factors: the products of F underflow toward 0, which
    is their true value to working precision. Runs in d's own type.
    """
    if is_np(d):
        n = d.shape[axis]
        y = np.array(d)  # copy
        ysw = np.moveaxis(y, axis, 0)
        fsw = np.moveaxis(np.broadcast_to(f, d.shape), axis, 0)
        rng = range(n - 2, -1, -1) if reverse else range(1, n)
        step = 1 if reverse else -1
        for i in rng:
            ysw[i] = ysw[i] + fsw[i] * ysw[i + step]
        return y
    n = d.shape[axis]
    D = d.movedim(axis, 0)
    F = f.reshape(-1).to(d.dtype)
    if F.shape[0] != n:
        raise ValueError(f"linrec: {F.shape[0]} factors for an axis of {n}")
    if reverse:
        D, F = D.flip(0), F.flip(0)
    D, F = D.clone(), F.clone()
    bshape = (-1,) + (1,) * (D.ndim - 1)
    k = 1
    while k < n:
        # the right-hand sides are whole new tensors, so writing them back
        # into D and F in place reads only values of the step before
        D[k:] = D[k:] + F[k:].reshape(bshape) * D[:-k]
        F[k:] = F[k:] * F[:-k]
        count("transform.scan_passes")
        k *= 2
    if reverse:
        D = D.flip(0)
    return D.movedim(0, axis)
