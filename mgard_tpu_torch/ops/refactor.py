"""Multilevel decompose / recompose (the MGARD multigrid transform).

Port of ``mgard_tpu/ops/refactor.py``, float32 and float64, in the
hierarchical basis and the L2-orthogonal one, on uniform and non-uniform
grids (the hierarchy's tables carry the coordinates). Three routes
compute the same linear map:

- K14 (``ops/multidim.py``, ``csrc/multidim.cu``) for a 3D field on a
  CUDA device, whatever its type, basis or coordinates: per level one
  kernel call of O(n) stencils and Thomas sweeps on O(n) tables that stay
  on the device. The two routes below are its plain versions;

- the dense-operator path (``decompose_level_fast`` /
  ``recompose_level_fast``) for every other field while no finest-level
  axis passes
  ``_FAST_MAX_AXIS``: per level one (nf x nf) interpolation matrix and one
  0/1 reorder matrix per axis, and for the orthogonal basis one (nc x nf)
  correction matrix per axis, each a ``torch.tensordot`` in the field's
  type (the JAX package ran the same operators as XLA matmuls outside any
  Pallas kernel, for float32 only; the port serves both types this way).
  The host builds the matrices once per hierarchy; a transform on a card
  copies every matrix it applies up before its first level
  (``_device_ops``);
- the split/lerp/merge "slice" path (``decompose_level`` /
  ``recompose_level``) for longer axes (1D signals, anisotropic grids),
  where a dense operator would be an O(n^2) matrix: per-axis slices,
  lerps and the tridiagonal solve of ``ops/axis.py``.

The package sets float32 matmuls to full precision
(``mgard_tpu_torch/__init__.py``): TF32 would cost a large share of a 1e-3
error budget. ``decompose_single`` / ``recompose_single`` are the SingleDim
variant (one dimension coarsened at a time per level).

``decompose`` and ``recompose`` count the level steps each route runs:
``transform.kernel_levels`` (K14), ``transform.dense_levels`` (the dense
operators) and ``transform.slice_levels`` (the slice path, one a level
step, each step in a ``transform.slice_level`` span). The slice path also
counts its Thomas solves, each in a ``transform.solve`` span:
``transform.scan_passes``, the steps of its doubling scans, counted by
``_be.linrec`` as each runs (2 ceil(log2 n) for a solve over n coarse
nodes), and ``transform.solve_elems``, the elements of the solve's box,
counted by ``axis.tridiag_solve_axis``. ``transform.put_bytes`` counts the
operators or tables a transform puts on its device, where they go up: the
dense operators every call, K14's tables on the first call per hierarchy
and device, and the slice path's per-axis tables (``_be.asarray_like``)
every call on a device other than the CPU.

Output layout is the reference's nested-box ("reo") layout: after the full
decomposition the level-l data occupies the leading box level_shape[l].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..hierarchy import Hierarchy
from ..utils.trace import count, span, to_device_each, traced
from . import _be, multidim
from .axis import (
    mass_restrict_axis,
    merge_axis,
    prolong_axis,
    split_axis,
    tridiag_solve_axis,
)

# Largest finest-level axis the dense operators are built for (an nf x nf
# matrix per level and axis: 4096^2 float32 = 64 MB), as in the JAX
# package; a 2^20-sample axis would be a terabyte matrix. Longer axes take
# the split/lerp/merge path.
_FAST_MAX_AXIS = 4096


def _box(v, shape: Sequence[int]):
    return v[tuple(slice(0, s) for s in shape)]


def _rot(v):
    """Move axis 0 to the end: (0,1,...,D-1) -> (1,...,D-1,0). All per-axis
    work of the slice path runs on axis 0 of the rotated array."""
    if v.ndim <= 1:
        return v
    return v.permute(tuple(range(1, v.ndim)) + (0,))


def _rot_inv(v):
    """Move the last axis to the front (inverse of _rot)."""
    if v.ndim <= 1:
        return v
    return v.permute((v.ndim - 1,) + tuple(range(0, v.ndim - 1)))


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


def _scatter_matrix(hier: Hierarchy, l: int, d: int) -> np.ndarray:
    """(nf x nc) left block of the inverse reorder: the coarse values to
    their physical (even) positions."""
    def build():
        nc = hier.axis[l - 1][d].n_coarse
        return np.ascontiguousarray(
            _reorder_matrix(hier, l, d, inverse=True)[:, :nc])

    return _cached(hier, "_scatter_mats", (l, d), build)


def _level_ops(hier: Hierarchy, l: int, orthogonal: bool, inverse: bool):
    """(name, host matrix) of every operator one level step applies."""
    ops = []
    for d in range(hier.D):
        ops.append((("interp", d), _interp_matrix(hier, l, d)))
        ops.append((("reorder", d), _reorder_matrix(hier, l, d, inverse)))
        if inverse:
            ops.append((("scatter", d), _scatter_matrix(hier, l, d)))
        if orthogonal:
            ops.append((("corr", d), _corr_matrix(hier, l, d)))
    return ops


def operator_bytes(hier: Hierarchy, orthogonal: bool, inverse: bool) -> int:
    """Bytes of the dense operators a full ``decompose_plain``
    (``recompose_plain`` with ``inverse``) of ``hier`` puts on its device
    (``_device_ops``); 0 on the slice path."""
    if not _use_fast(hier):
        return 0
    return sum(A.nbytes for l in range(1, hier.l_target + 1)
               for _, A in _level_ops(hier, l, orthogonal, inverse))


def _device_ops(hier: Hierarchy, levels, orthogonal: bool, inverse: bool,
                device) -> dict:
    """{level: {(name, axis): matrix}} of a transform over ``levels`` on
    ``device``, every matrix copied up before the first level runs (on the
    CPU, tensors over the host matrices' memory)."""
    items = [(l, k, A) for l in levels
             for k, A in _level_ops(hier, l, orthogonal, inverse)]
    ops = {l: {} for l in levels}
    for (l, k, _), t in zip(items, to_device_each([A for *_, A in items],
                                                   device)):
        ops[l][k] = t
    return ops


def _count_put(ops: dict) -> None:
    """``transform.put_bytes`` of the operators a dense transform holds on
    its device (on the CPU, the host matrices it runs on)."""
    count("transform.put_bytes", sum(t.nbytes for d in ops.values()
                                     for t in d.values()))


def _correction_mm(resid, ops: dict, D: int):
    """L2 projection of the residual onto the coarse grid: one dense
    correction matmul per axis."""
    corr = resid
    for d in range(D):
        corr = _apply_axis0_mm(ops[("corr", d)], corr)
    return corr


def _apply_axis0_mm(A, x):
    """y = A @ x along axis 0 (A a tensor on x's device), result axis
    rotated to the end: composing D of these cycles back to the original
    axis order."""
    return _rot(torch.tensordot(A, x, dims=([1], [0])))


_TYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _check(v, hier: Hierarchy):
    if _TYPES.get(v.dtype) != hier.dtype:
        raise TypeError(f"a {v.dtype} field with a {hier.dtype} hierarchy: "
                        "the transform takes float32 or float64, matching")


def decompose_level_fast(v, hier: Hierarchy, l: int, orthogonal: bool,
                         ops: dict):
    """One level by dense operators; ``ops`` are the level's matrices on
    v's device (``_device_ops``)."""
    D = hier.D
    interp = v
    for d in range(D):
        interp = _apply_axis0_mm(ops[("interp", d)], interp)
    resid = v - interp
    coarse = v
    for d, al in enumerate(hier.axis[l - 1]):
        coarse, _ = split_axis(coarse, d, al.n_fine)
    if orthogonal:
        coarse = coarse + _correction_mm(resid, ops, D)
    reo = resid
    for d in range(D):
        reo = _apply_axis0_mm(ops[("reorder", d)], reo)
    return _be.update_box(reo, coarse, D)


def recompose_level_fast(reo, hier: Hierarchy, l: int, orthogonal: bool,
                         ops: dict):
    D = hier.D
    coarse_shape = hier.level_shape[l - 1]
    coarse_box = _box(reo, coarse_shape)
    resid = _be.update_box(reo, _be.zeros(coarse_shape, reo.dtype, reo), D)
    for d in range(D):
        resid = _apply_axis0_mm(ops[("reorder", d)], resid)
    if orthogonal:
        coarse_box = coarse_box - _correction_mm(resid, ops, D)
    # scatter the coarse values to their physical (even) positions
    field = coarse_box
    for d in range(D):
        field = _apply_axis0_mm(ops[("scatter", d)], field)
    interp = field
    for d in range(D):
        interp = _apply_axis0_mm(ops[("interp", d)], interp)
    return interp + resid


# ----------------------------------------------------------------------
# The split/lerp/merge ("slice") path: O(n) work per axis, no dense
# operator. Runs on torch tensors and, as the oracle, on NumPy arrays.
# ----------------------------------------------------------------------
def _correction(resid, axes):
    """L2 projection of the residual field onto the coarse grid:
    per-axis mass+restriction, then per-axis tridiagonal solve
    (reference: CalcCorrection3D.hpp:27-185, Lpk1..3 then Ipk1..3).
    Axis-d work is done on axis 0 of the rotated array."""
    corr = resid
    for al in axes:
        corr = _rot(mass_restrict_axis(corr, 0, al))
    for al in axes:
        with span("transform.solve"):
            corr = _rot(tridiag_solve_axis(corr, 0, al))
    return corr


def _extract_coarse(v, axes):
    coarse = v
    for al in axes:
        c, _ = split_axis(coarse, 0, al.n_fine)
        coarse = _rot(c)
    return coarse


@traced("transform.slice_level")
def decompose_level(v, hier: Hierarchy, l: int, orthogonal: bool = True):
    """One coarsening step on the compact level-l box.

    Returns the fine box in reordered layout: coarse values (+ correction if
    orthogonal) in the leading coarse box, multilinear-interpolation
    coefficients in the complementary slabs.
    """
    count("transform.slice_levels")
    axes = hier.axis[l - 1]
    D = hier.D

    # Multilinear interpolant at every non-coarse node (coarse positions keep
    # their original values, so v - interp is exactly 0 there). The per-axis
    # interpolation passes commute, so rotating through the axes is exact.
    interp = v
    for al in axes:
        interp = _rot(prolong_axis(interp, 0, al))
    resid = v - interp

    coarse = _extract_coarse(v, axes)
    if orthogonal:
        coarse = coarse + _correction(resid, axes)

    # Reorder each axis into [coarse | coefficients]; composed over axes this
    # produces the nested-box layout. The all-even class lands in the leading
    # box holding zeros (resid is 0 there) and is overwritten by the coarse
    # values.
    reo = resid
    for al in axes:
        c_part, x_part = split_axis(reo, 0, al.n_fine)
        reo = _rot(_be.concat([c_part, x_part], 0))
    return _be.update_box(reo, coarse, D)


@traced("transform.slice_level")
def recompose_level(reo, hier: Hierarchy, l: int, orthogonal: bool = True):
    """Inverse of decompose_level."""
    count("transform.slice_levels")
    axes = hier.axis[l - 1]
    D = hier.D
    coarse_shape = hier.level_shape[l - 1]

    coarse_box = _box(reo, coarse_shape)
    resid_reo = _be.update_box(reo, _be.zeros(coarse_shape, reo.dtype, reo), D)
    # Un-reorder back to physical (interleaved) positions.
    resid = resid_reo
    for d in reversed(range(D)):
        al = axes[d]
        resid = _rot_inv(resid)
        c_part = _be.sl(resid, 0, 0, al.n_coarse)
        x_part = _be.sl(resid, 0, al.n_coarse, al.n_fine)
        resid = merge_axis(c_part, x_part, 0, al.n_fine)

    coarse_vals = coarse_box
    if orthogonal:
        coarse_vals = coarse_vals - _correction(resid, axes)

    # Scatter coarse values back to their physical positions (zeros at the
    # coefficient positions), then re-run the interpolation passes; they read
    # only already-final values, reproducing decompose's interpolant exactly.
    field = coarse_vals
    for al in axes:
        coeff_shape = list(field.shape)
        coeff_shape[0] = al.n_fine - al.n_coarse
        field = _rot(
            merge_axis(
                field, _be.zeros(tuple(coeff_shape), field.dtype, field), 0,
                al.n_fine
            )
        )
    interp = field
    for al in axes:
        interp = _rot(prolong_axis(interp, 0, al))
    return interp + resid


def _use_fast(hier: Hierarchy) -> bool:
    """Dense operators while every finest-level axis allows them; the JAX
    package adds "float32 only" (its float64 runs the slice path), the
    port's tensordots serve both types."""
    return max(hier.level_shape[hier.l_target]) <= _FAST_MAX_AXIS


def _levels(v, hier: Hierarchy, levels, step, orthogonal: bool):
    """Apply `step` to the level boxes of v in the order `levels`."""
    for l in levels:
        if l == hier.l_target:
            v = step(v, hier, l, orthogonal)
        else:
            box = step(_box(v, hier.level_shape[l]), hier, l, orthogonal)
            v = _be.update_box(v, box, hier.D)
    return v


def _fast_step(step, ops):
    return lambda v, hier, l, orthogonal: step(v, hier, l, orthogonal,
                                               ops[l])


def decompose(v, hier: Hierarchy, orthogonal: bool = False):
    """Full multilevel decomposition, finest to coarsest, nested-box output."""
    _check(v, hier)
    if multidim.takes(hier, v.device):
        count("transform.kernel_levels", hier.l_target)
        return multidim.decompose(v, hier, orthogonal)
    return decompose_plain(v, hier, orthogonal)


def decompose_plain(v, hier: Hierarchy, orthogonal: bool = False):
    """K14's plain version, on v's device: the dense operators, or the
    slice path for long axes."""
    levels = range(hier.l_target, 0, -1)
    if not _use_fast(hier):
        return _levels(v, hier, levels, decompose_level, orthogonal)
    count("transform.dense_levels", hier.l_target)
    ops = _device_ops(hier, levels, orthogonal, False, v.device)
    _count_put(ops)
    return _levels(v, hier, levels, _fast_step(decompose_level_fast, ops),
                   orthogonal)


def recompose(v, hier: Hierarchy, orthogonal: bool = False):
    """Full multilevel recomposition, coarsest to finest."""
    _check(v, hier)
    if multidim.takes(hier, v.device):
        count("transform.kernel_levels", hier.l_target)
        return multidim.recompose(v, hier, orthogonal)
    return recompose_plain(v, hier, orthogonal)


def recompose_plain(v, hier: Hierarchy, orthogonal: bool = False):
    """Inverse of ``decompose_plain``, on v's device."""
    levels = range(1, hier.l_target + 1)
    if not _use_fast(hier):
        return _levels(v, hier, levels, recompose_level, orthogonal)
    count("transform.dense_levels", hier.l_target)
    ops = _device_ops(hier, levels, orthogonal, True, v.device)
    _count_put(ops)
    return _levels(v, hier, levels, _fast_step(recompose_level_fast, ops),
                   orthogonal)


# ----------------------------------------------------------------------
# SingleDim decomposition (reference: DataRefactoring/SingleDimension/
# DataRefactoring.hpp:23-120: one dimension coarsened at a time per level;
# lower memory, a different error constant in the quantizer)
# ----------------------------------------------------------------------
def _correction_axis(resid, d, al):
    return tridiag_solve_axis(mass_restrict_axis(resid, d, al), d, al)


def _sd_bshape(ndim, axis, n):
    s = [1] * ndim
    s[axis] = n
    return tuple(s)


def _lerp_pair(coarse, al, like):
    """Interpolant of the coefficient nodes from their coarse neighbours
    along axis 0."""
    n_coeff = al.n_fine - al.n_coarse
    left = _be.sl(coarse, 0, 0, n_coeff)
    right = _be.sl(coarse, 0, 1, n_coeff + 1)
    t = _be.asarray_like(al.lerp_t, like, _sd_bshape(like.ndim, 0, n_coeff))
    return (left - left * t) + t * right


def decompose_level_single(v, hier: Hierarchy, l: int,
                           orthogonal: bool = True):
    """One level, coarsening each axis in sequence with per-axis 1D
    coefficients and corrections (axis-d work on axis 0 of the rotated
    array, see _rot)."""
    for al in hier.axis[l - 1]:
        coarse, odd = split_axis(v, 0, al.n_fine)
        coeff = odd - _lerp_pair(coarse, al, v)
        if orthogonal:
            resid = merge_axis(_be.zeros(coarse.shape, v.dtype, v), coeff, 0,
                               al.n_fine)
            coarse = coarse + _correction_axis(resid, 0, al)
        v = _rot(_be.concat([coarse, coeff], 0))
    return v


def recompose_level_single(reo, hier: Hierarchy, l: int,
                           orthogonal: bool = True):
    axes = hier.axis[l - 1]
    for d in reversed(range(hier.D)):
        al = axes[d]
        reo = _rot_inv(reo)
        coarse = _be.sl(reo, 0, 0, al.n_coarse)
        coeff = _be.sl(reo, 0, al.n_coarse, al.n_fine)
        if orthogonal:
            resid = merge_axis(_be.zeros(coarse.shape, reo.dtype, reo), coeff,
                               0, al.n_fine)
            coarse = coarse - _correction_axis(resid, 0, al)
        odd = coeff + _lerp_pair(coarse, al, reo)
        reo = merge_axis(coarse, odd, 0, al.n_fine)
    return reo


def decompose_single(v, hier: Hierarchy, orthogonal: bool = True):
    _check(v, hier)
    return _levels(v, hier, range(hier.l_target, 0, -1),
                   decompose_level_single, orthogonal)


def recompose_single(v, hier: Hierarchy, orthogonal: bool = True):
    _check(v, hier)
    return _levels(v, hier, range(1, hier.l_target + 1),
                   recompose_level_single, orthogonal)


def _mass_trans_single_x(coeff, d, al):
    """The REFERENCE SingleDim mass-transfer along axis d (reference:
    SingleDimension/Correction/MassTransKernel.hpp:66-112 + the LPK
    mass_trans formula with a=c=e=0). Differs from mass_restrict_axis in
    its boundary guards: the last coarse node takes NO contribution (b
    requires j < n_coeff, and the h windows stop at n_coeff+nc-1), a
    reference quirk that is self-consistent between its decompose and
    recompose, so a cross-decoder must reproduce it exactly. The tables
    are host NumPy; the coefficients stay where they are (NumPy, or a
    float64 tensor on its device)."""
    nf, nc = al.n_fine, al.n_coarse
    ncf = nf - nc
    h = np.zeros(2 * nc + 2, np.float64)
    hsrc = np.asarray(al.h_ext, np.float64)
    h[: hsrc.size] = hsrc
    j = np.arange(nc)
    lim = ncf + nc - 1
    c1 = (j > 0) & (2 * j < lim)
    c2 = 2 * j < lim
    h1 = np.where(c1, h[np.maximum(2 * j - 2, 0)], 0.0)
    h2 = np.where(c1, h[np.maximum(2 * j - 1, 0)], 0.0)
    h3 = np.where(c2, h[2 * j], 0.0)
    h4 = np.where(c2, h[2 * j + 1], 0.0)
    bsel = (j > 0) & (j < ncf)
    dsel = j < ncf

    if _be.is_np(coeff):
        cm = np.moveaxis(np.asarray(coeff, np.float64), d, -1)
        b = np.zeros(cm.shape[:-1] + (nc,), np.float64)
        dd = np.zeros_like(b)
        b[..., bsel] = cm[..., (j[bsel] - 1)]
        dd[..., dsel] = cm[..., j[dsel]]
    else:
        cm = coeff.to(torch.float64).movedim(d, -1)
        tab = lambda a: torch.as_tensor(a, device=cm.device)  # noqa: E731
        h1, h2, h3, h4 = map(tab, (h1, h2, h3, h4))
        b = torch.zeros(cm.shape[:-1] + (nc,), dtype=torch.float64,
                        device=cm.device)
        dd = torch.zeros_like(b)
        b[..., tab(bsel)] = cm[..., tab(j[bsel] - 1)]
        dd[..., tab(dsel)] = cm[..., tab(j[dsel])]
    out = 2 * b * (h1 / 6) + (b * h2 + dd * h3) / 6 + 2 * dd * (h4 / 6)
    return (np.moveaxis(out, -1, d) if _be.is_np(out)
            else out.movedim(-1, d))


def recompose_single_x(u, hier: Hierarchy):
    """Inverse of the REFERENCE library's SingleDim decomposition in its
    own nested-box layout (reference: DataRefactoring/SingleDimension/
    DataRefactoring.hpp:110-185: per (level, dim) step the fine box has
    dims > curr_dim still at the coarse level; coefficients sit at offset
    level_shape(l, curr_dim) along curr_dim; the correction and lerp are
    the same per-axis 1D operators as ours). For reference-written
    SingleDim streams, on a NumPy array or a tensor on its own device; the
    port's own SingleDim streams keep the rotated-concat layout of
    decompose_single."""
    v = np.asarray(u).copy() if _be.is_np(u) else u.clone()
    D = hier.D
    for l in range(hier.l_target):
        for d in range(D):
            fine_shape = tuple(
                hier.level_shape[l][dd] if dd > d else hier.level_shape[l + 1][dd]
                for dd in range(D)
            )
            al = hier.axis[l][d]
            nf, nc = al.n_fine, al.n_coarse
            box = v[tuple(slice(0, s) for s in fine_shape)]
            coarse = _be.sl(box, d, 0, nc)
            coeff = _be.sl(box, d, nc, nf)
            corr = tridiag_solve_axis(
                _mass_trans_single_x(coeff, d, al), d, al
            )
            coarse = coarse - corr
            n_coeff = nf - nc
            left = _be.sl(coarse, d, 0, n_coeff)
            right = _be.sl(coarse, d, 1, n_coeff + 1)
            t = _be.asarray_like(al.lerp_t, box,
                                 _sd_bshape(box.ndim, d, n_coeff))
            odd = coeff + ((left - left * t) + t * right)
            fine = merge_axis(coarse, odd, d, nf)
            v[tuple(slice(0, s) for s in fine_shape)] = fine
    return v
