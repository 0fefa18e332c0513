"""Function-space norms on a mesh hierarchy.

Port of ``mgard_tpu/ops/norms.py``: parity with the reference CPU
library's public norm API (`mgard::norm` /
`orthogonal_component_square_norms`, include/mgard/TensorNorms.hpp:20-40,
algorithm in TensorNorms.tpp): s = +inf gives the supremum norm, s = 0 the integral
L2 norm (through the tensor-product mass matrix), and finite s the
multilevel '`s` norm'

    ||u||_s^2 = sum_l 2^(2 s l) * ||(P_l - P_{l-1}) u||_L2^2

where P_l is the L2 projection onto mesh level l. The component norms
follow the reference's dual recursion: f = M_L u once, then per level
restrict the dual (R = P^T, the same restriction the decomposition's
correction uses) and evaluate <M_l^{-1} f_l, f_l>.

Host-side float64 NumPy. Masses are the REAL tridiagonal masses of each
level's actual mesh (the hierarchy's ghost extension is a transition-
stencil device; the L2 inner product lives on the real mesh), and the
dual restriction is the EXACT adjoint of the framework's prolongation —
so by the Galerkin identity (P^T M_fine P = M_coarse for nested linear
elements) the recursion computes true L2 projections for the transform's
own interpolation operators. Throughput is irrelevant here (tests, error
reports, the oracle the s-norm bounds are measured with); the compression
pipeline never calls it. A torch tensor is brought to the host first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..hierarchy import Hierarchy, _calc_am_bm


def _level_positions(hier: Hierarchy, d: int) -> list:
    """TRUE node coordinates of every level along axis d, coarsest first.

    The levels are the node SUBSETS of the input mesh (evens, plus the
    last node for even sizes — split_axis's convention), so the linear
    element spaces are exactly nested and the Galerkin identity holds.
    (MGARD-X's uniform mode re-spreads coarse spacing evenly — a
    transition-stencil approximation; the norm must use real geometry,
    like the reference CPU hierarchy that mgard::norm is defined on.)"""
    x = np.asarray(hier.coords[d], np.float64)
    pos = [x]
    for l in range(hier.l_target, 0, -1):
        n = x.shape[0]
        if n % 2 == 0 and n != 2:
            x = np.concatenate([x[0 : n - 1 : 2], x[n - 1 :]])
        else:
            x = x[0:n:2]
        assert x.shape[0] == hier.level_shape[l - 1][d]
        pos.append(x)
    return pos[::-1]


def _real_h(hier: Hierarchy, l: int, d: int) -> np.ndarray:
    """REAL level-l node distances along axis d."""
    return np.diff(_level_positions(hier, d)[l])


def _mass_axis(u: np.ndarray, axis: int, h: np.ndarray) -> np.ndarray:
    """Real tridiagonal mass apply along one axis:
    m_i = h_{i-1}/6 u_{i-1} + (h_{i-1}+h_i)/3 u_i + h_i/6 u_{i+1}
    (reference TensorMassMatrix.hpp semantics on the actual mesh)."""
    n = u.shape[axis]
    assert h.shape[0] == n - 1
    hl = np.concatenate([[0.0], h])
    hr = np.concatenate([h, [0.0]])
    ue = np.moveaxis(u, axis, 0)
    up = np.concatenate([np.zeros_like(ue[:1]), ue[:-1]])
    un = np.concatenate([ue[1:], np.zeros_like(ue[:1])])
    bshape = (n,) + (1,) * (ue.ndim - 1)
    m = (
        (hl / 6.0).reshape(bshape) * up
        + ((hl + hr) / 3.0).reshape(bshape) * ue
        + (hr / 6.0).reshape(bshape) * un
    )
    return np.moveaxis(m, 0, axis)


def _lerp_t(hier: Hierarchy, l: int, d: int) -> np.ndarray:
    """f64 interpolation parameters of the transition l -> l-1 along axis
    d, from TRUE node positions: coefficient k at fine node 2k+1 between
    coarse neighbors at fine nodes 2k / 2k+2."""
    x = _level_positions(hier, d)[l]
    nf = hier.level_shape[l][d]
    n_coeff = nf - hier.level_shape[l - 1][d]
    left = x[0 : 2 * n_coeff : 2]
    mid = x[1 : 2 * n_coeff : 2]
    right = x[2 : 2 * n_coeff + 1 : 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (mid - left) / (right - left)
    return np.nan_to_num(t, nan=0.5)


def _restrict_dual_axis(f: np.ndarray, hier: Hierarchy, l: int,
                        d: int) -> np.ndarray:
    """EXACT adjoint P^T of the prolongation along one axis (transition
    level l -> l-1): coarse j collects its own fine slot plus the lerp
    weights of the coefficient nodes it interpolates into
    ((P c)|coeff_k = (1-t_k) c_k + t_k c_{k+1}). Independent of the ghost
    conventions, so the Galerkin identity P^T M_fine P = M_coarse holds
    exactly on the real mesh."""
    nf = hier.level_shape[l][d]
    nc = hier.level_shape[l - 1][d]
    n_coeff = nf - nc
    t = _lerp_t(hier, l, d)
    fm = np.moveaxis(f, d, 0)
    if nf % 2 == 1:
        coarse = fm[0:nf:2].copy()
        coeff = fm[1:nf:2]
    else:
        coarse = np.concatenate([fm[0 : nf - 1 : 2], fm[nf - 1 : nf]])
        coeff = fm[1 : nf - 2 : 2]
    bshape = (n_coeff,) + (1,) * (fm.ndim - 1)
    if n_coeff:
        w = (1.0 - t).reshape(bshape) * coeff
        coarse[:n_coeff] += w
        coarse[1 : n_coeff + 1] += t.reshape(bshape) * coeff
    return np.moveaxis(coarse, 0, d)


def _mass_solve_axis(g: np.ndarray, axis: int, h: np.ndarray) -> np.ndarray:
    """Solve the level mass system M x = g along one axis (pre-factored
    Thomas sweeps, f64; same am/bm factorization the IPK-equivalent
    tridiag_solve_axis uses)."""
    n = g.shape[axis]
    am, bm = _calc_am_bm(n, h)
    y = np.moveaxis(g, axis, 0).astype(np.float64).copy()
    for i in range(1, n):
        y[i] -= (am[i] / bm[i]) * y[i - 1]
    x = y * (1.0 / bm[1 : n + 1]).reshape((n,) + (1,) * (y.ndim - 1))
    for i in range(n - 2, -1, -1):
        x[i] -= (am[i + 1] / bm[i + 1]) * x[i + 1]
    return np.moveaxis(x, 0, axis)


def _mass_apply(u: np.ndarray, hier: Hierarchy, l: int) -> np.ndarray:
    for d in range(hier.D):
        u = _mass_axis(u, d, _real_h(hier, l, d))
    return u


def orthogonal_component_square_norms(u: np.ndarray,
                                      hier: Hierarchy) -> np.ndarray:
    """Square L2 norms of the orthogonal multilevel components of ``u``,
    coarsest (level 0) to finest (level L). Reference:
    TensorNorms.tpp orthogonal_component_square_norms."""
    L = hier.l_target
    u = np.asarray(u, np.float64).reshape(hier.shape)
    sq = np.zeros(L + 1)
    f = _mass_apply(u, hier, L)
    sq[L] = float(np.vdot(u, f))
    for l in range(L - 1, -1, -1):
        # exact-adjoint dual restriction through transition l+1 -> l; the
        # projection then solves the level-l real mass system
        for d in range(hier.D):
            f = _restrict_dual_axis(f, hier, l + 1, d)
        proj = f
        for d in range(hier.D):
            proj = _mass_solve_axis(proj, d, _real_h(hier, l, d))
        sq[l] = float(np.vdot(proj, f))
    # projection norms are nested; successive differences are the
    # orthogonal components (clamped like the reference: near-zero
    # components can come out slightly negative)
    comp = np.empty_like(sq)
    comp[0] = sq[0]
    comp[1:] = np.maximum(0.0, sq[1:] - sq[:-1])
    return comp


def norm_hier(u: np.ndarray, hier: Hierarchy, s: float) -> float:
    """The reference's mgard::norm on an existing hierarchy."""
    u = np.asarray(u, np.float64)
    if math.isinf(s):
        return float(np.max(np.abs(u))) if u.size else 0.0
    comp = orthogonal_component_square_norms(u, hier)
    if s == 0:
        return float(math.sqrt(comp.sum()))
    w = np.exp2(2.0 * s * np.arange(comp.shape[0]))
    return float(math.sqrt(float(w @ comp)))


def norm(u, s: float, coords: Optional[Sequence[np.ndarray]] = None,
         config=None) -> float:
    """Compute ||u||_s on u's natural uniform (or given) mesh.

    Public counterpart of the reference's `mgard::norm(hierarchy, u, s)`
    (include/mgard/TensorNorms.hpp:36-38): s=inf -> supremum norm,
    s=0 -> integral L2 norm, finite s -> multilevel s-norm."""
    from ..hierarchy import get_hierarchy

    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    u = np.asarray(u)
    hier = get_hierarchy(
        tuple(int(x) for x in u.shape), np.float64,
        [np.asarray(c, np.float64) for c in coords] if coords else None,
        config,
    )
    return norm_hier(u, hier, s)
