"""Per-axis primitive operators of the multigrid transform (port of
``mgard_tpu/ops/axis.py``).

Each operator is a whole-array vectorized function along one axis, written
once against the op set of ``_be.py``: on torch tensors it runs on the
tensor's device in the tensor's type (the split/lerp/merge "slice" path of
``ops/refactor.py``, for axes too long for dense operators, and the
SingleDim transform); on NumPy arrays the same code is the host oracle
that ``refactor._corr_matrix`` probes with identity columns to build the
dense correction operator, so the ghost-node and non-uniform-spacing logic
is inherited exactly. The tridiagonal solve is two first-order linear
recurrences (``_be.linrec``: a log-depth doubling scan on tensors, a
sequential sweep in NumPy), mirroring the reference's IPK sweeps.

Axis-size conventions (see hierarchy.py): a size-n axis coarsens to
n//2 + 1 nodes = the even indices plus, for even n, the last node. Even axes
use a zero-valued virtual ghost node at the midpoint of the last cell for the
mass/restriction stencils.
"""

from __future__ import annotations

import numpy as np

from ..hierarchy import AxisLevel
from ..utils.trace import count
from . import _be


def _bshape(arr_ndim: int, axis: int, n: int):
    s = [1] * arr_ndim
    s[axis] = n
    return tuple(s)


def split_axis(v, axis: int, nf: int):
    """Fine axis -> (coarse part, coefficient part).

    coarse = even indices (+ last node when nf even); coeff = the rest.
    This is the per-axis piece of the reference GPK's reordered ("reo")
    output layout (GridProcessingKernel3D.hpp:1181).
    """
    if nf % 2 == 1:
        coarse = _be.sl(v, axis, 0, nf, 2)
        coeff = _be.sl(v, axis, 1, nf, 2)
    else:
        coarse = _be.concat(
            [_be.sl(v, axis, 0, nf - 1, 2), _be.sl(v, axis, nf - 1, nf)], axis
        )
        coeff = _be.sl(v, axis, 1, nf - 2, 2)
    return coarse, coeff


def merge_axis(coarse, coeff, axis: int, nf: int):
    """Inverse of split_axis: interleave coarse/coefficient parts."""
    nc = nf // 2 + 1
    if nf % 2 == 1:
        x = _be.pad_zero(coeff, axis, 0, 1)  # to nc
        merged = _be.stack2_reshape(coarse, x, axis)
        return _be.sl(merged, axis, 0, nf)
    body_c = _be.sl(coarse, axis, 0, nc - 1)
    x = _be.pad_zero(coeff, axis, 0, 1)  # to nc-1 == nf//2
    merged = _be.stack2_reshape(body_c, x, axis)
    return _be.concat(
        [_be.sl(merged, axis, 0, nf - 1), _be.sl(coarse, axis, nc - 1, nc)], axis
    )


def _lerp(v0, v1, t):
    # Matches reference lerp (GPKFunctor.h:13-25): (v0 - v0*t) + t*v1.
    return (v0 - v0 * t) + t * v1


def prolong_axis(v, axis: int, al: AxisLevel):
    """Replace the coefficient positions along `axis` with the linear
    interpolant of their coarse neighbors; coarse positions unchanged.

    Sequential application over all axes yields the exact multilinear
    interpolant at every non-coarse node class (the reference computes the
    same quantity inside the fused GPK kernel)."""
    nf = al.n_fine
    coarse, _ = split_axis(v, axis, nf)
    n_coeff = nf - al.n_coarse
    left = _be.sl(coarse, axis, 0, n_coeff)
    right = _be.sl(coarse, axis, 1, n_coeff + 1)
    t = _be.asarray_like(al.lerp_t, v, _bshape(v.ndim, axis, n_coeff))
    interped = _lerp(left, right, t)
    return merge_axis(coarse, interped, axis, nf)


def mass_restrict_axis(r, axis: int, al: AxisLevel):
    """Apply the 1D fine mass matrix then restriction along `axis`.

    Computes (R M r) along the axis: fine size nf -> coarse size nc.
    Mirrors the reference LPK mass_trans math (LPKFunctor.h:49-66):
      m_i = h_{i-1}/6 r_{i-1} + (h_{i-1}+h_i)/3 r_i + h_i/6 r_{i+1}
      out_j = m_{2j} + rw_left_j m_{2j-1} + rw_right_j m_{2j+1}
    on the *extended* grid (zero ghost node inserted before the last node for
    even nf)."""
    nf, nc = al.n_fine, al.n_coarse
    ndim = r.ndim
    if nf % 2 == 0 and nf != 2:
        r = _be.concat(
            [
                _be.sl(r, axis, 0, nf - 1),
                _be.zeros(_bshape_full(r, axis, 1), r.dtype, r),
                _be.sl(r, axis, nf - 1, nf),
            ],
            axis,
        )
    n_ext = r.shape[axis]
    h = al.h_ext  # (n_ext - 1,)
    hl = np.concatenate([[0.0], h]).astype(h.dtype)  # h_{i-1}, len n_ext
    hr = np.concatenate([h, [0.0]]).astype(h.dtype)  # h_i,     len n_ext
    hl_t = _be.asarray_like(hl / 6.0, r, _bshape(ndim, axis, n_ext))
    hr_t = _be.asarray_like(hr / 6.0, r, _bshape(ndim, axis, n_ext))
    hc_t = _be.asarray_like(((hl + hr) / 3.0).astype(h.dtype), r, _bshape(ndim, axis, n_ext))
    r_prev = _be.pad_zero(_be.sl(r, axis, 0, n_ext - 1), axis, 1, 0)
    r_next = _be.pad_zero(_be.sl(r, axis, 1, n_ext), axis, 0, 1)
    m = hl_t * r_prev + hc_t * r + hr_t * r_next

    m_even = _be.sl(m, axis, 0, n_ext, 2)  # m_{2j}, length nc
    m_left = _be.pad_zero(_be.sl(m, axis, 1, 2 * (nc - 1), 2), axis, 1, 0)  # m_{2j-1}
    m_right = _be.pad_zero(_be.sl(m, axis, 1, n_ext, 2), axis, 0, 1)  # m_{2j+1}
    rw_l = _be.asarray_like(al.rw_left, r, _bshape(ndim, axis, nc))
    rw_r = _be.asarray_like(al.rw_right, r, _bshape(ndim, axis, nc))
    return m_even + rw_l * m_left + rw_r * m_right


def _bshape_full(r, axis: int, n: int):
    s = list(r.shape)
    s[axis] = n
    return tuple(s)


def tridiag_solve_axis(d, axis: int, al: AxisLevel):
    """Solve the coarse-grid mass-matrix tridiagonal system along `axis`.

    Pre-factored Thomas sweeps expressed as two first-order linear
    recurrences (see _be.linrec). Mirrors reference IPK tridiag_forward2/backward2
    (IPKFunctor.h:13-55):
      forward:  y_i = d_i + fwd_f_i * y_{i-1}
      backward: x_i = (y_i * bwd_binv_i) + bwd_g_i * x_{i+1}

    A tensor solve counts the elements of ``d`` in ``transform.solve_elems``
    (the NumPy oracle counts nothing).
    """
    if not _be.is_np(d):
        count("transform.solve_elems", d.numel())
    ndim = d.ndim
    nc = al.n_coarse
    f = _be.asarray_like(al.fwd_f, d, _bshape(ndim, axis, nc))
    y = _be.linrec(d, f, axis, reverse=False)
    binv = _be.asarray_like(al.bwd_binv, d, _bshape(ndim, axis, nc))
    g = _be.asarray_like(al.bwd_g, d, _bshape(ndim, axis, nc))
    return _be.linrec(y * binv, g, axis, reverse=True)
