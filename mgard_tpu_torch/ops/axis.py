"""Per-axis operators of the multigrid transform (port of
``mgard_tpu/ops/axis.py``).

``split_axis`` serves the dense-matrix path on torch tensors.
``mass_restrict_axis`` and ``tridiag_solve_axis`` are the host NumPy
oracle of the L2-projection correction (mirroring the reference's LPK
mass_trans and IPK tridiagonal sweeps); ``refactor._corr_matrix`` probes
them with identity columns to build the dense correction operator, so the
ghost-node and non-uniform-spacing logic is inherited exactly.

Axis-size convention (see hierarchy.py): a size-n axis coarsens to
n//2 + 1 nodes = the even indices plus, for even n, the last node. Even axes
use a zero-valued virtual ghost node at the midpoint of the last cell for
the mass/restriction stencils.
"""

from __future__ import annotations

import numpy as np

from ..hierarchy import AxisLevel
from . import _be


def _bshape(arr_ndim: int, axis: int, n: int):
    s = [1] * arr_ndim
    s[axis] = n
    return tuple(s)


def split_axis(v, axis: int, nf: int):
    """Fine axis -> (coarse part, coefficient part).

    coarse = even indices (+ last node when nf even); coeff = the rest."""
    if nf % 2 == 1:
        coarse = _be.sl(v, axis, 0, nf, 2)
        coeff = _be.sl(v, axis, 1, nf, 2)
    else:
        coarse = _be.concat(
            [_be.sl(v, axis, 0, nf - 1, 2), _be.sl(v, axis, nf - 1, nf)], axis
        )
        coeff = _be.sl(v, axis, 1, nf - 2, 2)
    return coarse, coeff


def mass_restrict_axis(r: np.ndarray, axis: int, al: AxisLevel):
    """Apply the 1D fine mass matrix then restriction along `axis`.

    Computes (R M r) along the axis: fine size nf -> coarse size nc:
      m_i = h_{i-1}/6 r_{i-1} + (h_{i-1}+h_i)/3 r_i + h_i/6 r_{i+1}
      out_j = m_{2j} + rw_left_j m_{2j-1} + rw_right_j m_{2j+1}
    on the *extended* grid (zero ghost node inserted before the last node for
    even nf)."""
    nf, nc = al.n_fine, al.n_coarse
    ndim = r.ndim
    if nf % 2 == 0 and nf != 2:
        ghost = np.zeros_like(_be.sl(r, axis, 0, 1))
        r = np.concatenate(
            [_be.sl(r, axis, 0, nf - 1), ghost, _be.sl(r, axis, nf - 1, nf)],
            axis)
    n_ext = r.shape[axis]
    h = al.h_ext  # (n_ext - 1,)
    hl = np.concatenate([[0.0], h]).astype(h.dtype)  # h_{i-1}, len n_ext
    hr = np.concatenate([h, [0.0]]).astype(h.dtype)  # h_i,     len n_ext
    hl_t = np.reshape(hl / 6.0, _bshape(ndim, axis, n_ext))
    hr_t = np.reshape(hr / 6.0, _bshape(ndim, axis, n_ext))
    hc_t = np.reshape(((hl + hr) / 3.0).astype(h.dtype),
                      _bshape(ndim, axis, n_ext))
    r_prev = _be.pad_zero(_be.sl(r, axis, 0, n_ext - 1), axis, 1, 0)
    r_next = _be.pad_zero(_be.sl(r, axis, 1, n_ext), axis, 0, 1)
    m = hl_t * r_prev + hc_t * r + hr_t * r_next

    m_even = _be.sl(m, axis, 0, n_ext, 2)  # m_{2j}, length nc
    m_left = _be.pad_zero(_be.sl(m, axis, 1, 2 * (nc - 1), 2), axis, 1, 0)
    m_right = _be.pad_zero(_be.sl(m, axis, 1, n_ext, 2), axis, 0, 1)
    rw_l = np.reshape(al.rw_left, _bshape(ndim, axis, nc))
    rw_r = np.reshape(al.rw_right, _bshape(ndim, axis, nc))
    return m_even + rw_l * m_left + rw_r * m_right


def tridiag_solve_axis(d: np.ndarray, axis: int, al: AxisLevel):
    """Solve the coarse-grid mass-matrix tridiagonal system along `axis`:
    pre-factored Thomas sweeps as two first-order linear recurrences
      forward:  y_i = d_i + fwd_f_i * y_{i-1}
      backward: x_i = (y_i * bwd_binv_i) + bwd_g_i * x_{i+1}."""
    ndim = d.ndim
    nc = al.n_coarse
    f = np.reshape(al.fwd_f, _bshape(ndim, axis, nc))
    y = _be.linrec(d, f, axis, reverse=False)
    binv = np.reshape(al.bwd_binv, _bshape(ndim, axis, nc))
    g = np.reshape(al.bwd_g, _bshape(ndim, axis, nc))
    return _be.linrec(y * binv, g, axis, reverse=True)
