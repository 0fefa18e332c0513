"""Multilevel decompose / recompose (the MGARD multigrid transform).

Port of the dense-operator fast path of ``mgard_tpu/ops/refactor.py``
(``decompose_level_fast`` / ``recompose_level_fast``) for float32 and
float64, in the hierarchical basis and the L2-orthogonal one. Each level
applies one (nf x nf) interpolation matrix and one 0/1 reorder matrix per
axis, and for the orthogonal basis one (nc x nf) correction matrix per
axis, each a ``torch.tensordot`` in the field's type; the JAX package ran
the same operators as XLA matmuls outside any Pallas kernel. (It runs
float64 through its slice path instead: the same linear map, rounded in
another order.) The package sets float32 matmuls to full precision
(``mgard_tpu_torch/__init__.py``): TF32 would cost a large share of a 1e-3
error budget.

Output layout is the reference's nested-box ("reo") layout: after the full
decomposition the level-l data occupies the leading box level_shape[l].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..hierarchy import Hierarchy
from . import _be
from .axis import mass_restrict_axis, split_axis, tridiag_solve_axis

# Largest finest-level axis the dense operators are built for (an nf x nf
# matrix per level and axis), as in the JAX package.
_FAST_MAX_AXIS = 4096


def _box(v, shape: Sequence[int]):
    return v[tuple(slice(0, s) for s in shape)]


def _rot(v):
    """Move axis 0 to the end: (0,1,...,D-1) -> (1,...,D-1,0)."""
    if v.ndim <= 1:
        return v
    return v.permute(tuple(range(1, v.ndim)) + (0,))


def _cached(hier: Hierarchy, name: str, key, build):
    cache = hier.__dict__.setdefault(name, {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _fast_axis_tables(hier: Hierarchy, l: int, d: int):
    """Lerp weights (wl, wr) at the odd positions and the odd-position mask
    of the level-l step on axis d."""
    def build():
        al = hier.axis[l - 1][d]
        nf, nc = al.n_fine, al.n_coarse
        t = al.lerp_t.astype(np.float64)
        wl = np.zeros(nf)
        wr = np.zeros(nf)
        mask = np.zeros(nf, bool)
        idx = 2 * np.arange(nf - nc) + 1
        wl[idx] = 1.0 - t
        wr[idx] = t
        mask[idx] = True
        return wl.astype(hier.dtype), wr.astype(hier.dtype), mask

    return _cached(hier, "_fast_tables", (l, d), build)


def _interp_matrix(hier: Hierarchy, l: int, d: int) -> np.ndarray:
    """(nf x nf) interpolation pass: identity at coarse rows, (wl, wr) lerp
    rows at the coefficient positions."""
    def build():
        wl, wr, mask = _fast_axis_tables(hier, l, d)
        P = np.eye(len(mask), dtype=np.float64)
        idx = np.nonzero(mask)[0]
        P[idx] = 0.0
        P[idx, idx - 1] = wl[idx]
        P[idx, idx + 1] = wr[idx]
        return P.astype(hier.dtype)

    return _cached(hier, "_interp_mats", (l, d), build)


def _reorder_matrix(hier: Hierarchy, l: int, d: int,
                    inverse: bool = False) -> np.ndarray:
    """(nf x nf) split/merge permutation: rows = [evens (+ last node when nf
    even), odds], the per-axis piece of the nested-box reorder."""
    def build():
        nf = hier.axis[l - 1][d].n_fine
        if nf % 2 == 1:
            order = list(range(0, nf, 2)) + list(range(1, nf, 2))
        else:
            order = (list(range(0, nf - 1, 2)) + [nf - 1]
                     + list(range(1, nf - 2, 2)))
        S = np.zeros((nf, nf), hier.dtype)
        S[np.arange(nf), order] = 1.0
        return S.T.copy() if inverse else S

    return _cached(hier, "_reorder_mats", (l, d, inverse), build)


def _corr_matrix(hier: Hierarchy, l: int, d: int) -> np.ndarray:
    """Dense per-(level, axis) correction operator A = M_c^-1 R M_f
    (nc x nf), built in float64 by probing the NumPy-oracle
    mass/restriction and tridiagonal solve with identity columns, then cast
    to the hierarchy's type."""
    def build():
        al = hier.axis[l - 1][d]
        eye = np.eye(al.n_fine, dtype=np.float64)
        rm = mass_restrict_axis(eye, 0, al)  # (nc, nf) columns = responses
        return tridiag_solve_axis(rm, 0, al).astype(hier.dtype)

    return _cached(hier, "_corr_mats", (l, d), build)


def _correction_mm(resid, hier: Hierarchy, l: int):
    """L2 projection of the residual onto the coarse grid: one dense
    correction matmul per axis."""
    corr = resid
    for d in range(hier.D):
        corr = _apply_axis0_mm(_corr_matrix(hier, l, d), corr)
    return corr


def _apply_axis0_mm(A: np.ndarray, x):
    """y = A @ x along axis 0, result axis rotated to the end: composing D
    of these cycles back to the original axis order."""
    At = torch.as_tensor(A, device=x.device)
    return _rot(torch.tensordot(At, x, dims=([1], [0])))


_TYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _check(v, hier: Hierarchy):
    if _TYPES.get(v.dtype) != hier.dtype:
        raise TypeError(f"a {v.dtype} field with a {hier.dtype} hierarchy: "
                        "the transform takes float32 or float64, matching")
    if max(hier.level_shape[hier.l_target]) > _FAST_MAX_AXIS:
        raise NotImplementedError(
            f"the port's transform covers axes up to {_FAST_MAX_AXIS} "
            "(ROADMAP queue 1 item 9 brings longer ones)")


def decompose_level(v, hier: Hierarchy, l: int, orthogonal: bool = False):
    D = hier.D
    interp = v
    for d in range(D):
        interp = _apply_axis0_mm(_interp_matrix(hier, l, d), interp)
    resid = v - interp
    coarse = v
    for d, al in enumerate(hier.axis[l - 1]):
        coarse, _ = split_axis(coarse, d, al.n_fine)
    if orthogonal:
        coarse = coarse + _correction_mm(resid, hier, l)
    reo = resid
    for d in range(D):
        reo = _apply_axis0_mm(_reorder_matrix(hier, l, d), reo)
    return _be.update_box(reo, coarse, D)


def recompose_level(reo, hier: Hierarchy, l: int, orthogonal: bool = False):
    axes = hier.axis[l - 1]
    D = hier.D
    coarse_shape = hier.level_shape[l - 1]
    coarse_box = _box(reo, coarse_shape)
    resid = _be.update_box(reo, _be.zeros(coarse_shape, reo.dtype, reo), D)
    for d in range(D):
        resid = _apply_axis0_mm(_reorder_matrix(hier, l, d, inverse=True),
                                resid)
    if orthogonal:
        coarse_box = coarse_box - _correction_mm(resid, hier, l)
    # scatter the coarse values to their physical (even) positions: the
    # (nf x nc) left block of the inverse reorder permutation
    field = coarse_box
    for d in range(D):
        E = _reorder_matrix(hier, l, d, inverse=True)[:, : axes[d].n_coarse]
        field = _apply_axis0_mm(np.ascontiguousarray(E), field)
    interp = field
    for d in range(D):
        interp = _apply_axis0_mm(_interp_matrix(hier, l, d), interp)
    return interp + resid


def decompose(v, hier: Hierarchy, orthogonal: bool = False):
    """Full multilevel decomposition, finest to coarsest, nested-box output."""
    _check(v, hier)
    for l in range(hier.l_target, 0, -1):
        if l == hier.l_target:
            v = decompose_level(v, hier, l, orthogonal)
        else:
            reo = decompose_level(_box(v, hier.level_shape[l]), hier, l,
                                  orthogonal)
            v = _be.update_box(v, reo, hier.D)
    return v


def recompose(v, hier: Hierarchy, orthogonal: bool = False):
    """Full multilevel recomposition, coarsest to finest."""
    _check(v, hier)
    for l in range(1, hier.l_target + 1):
        if l == hier.l_target:
            v = recompose_level(v, hier, l, orthogonal)
        else:
            rec = recompose_level(_box(v, hier.level_shape[l]), hier, l,
                                  orthogonal)
            v = _be.update_box(v, rec, hier.D)
    return v
