"""Plain reference of the s = 0 (L2) round trip, in float64 torch.

It imports nothing of the program and no kernel; ``reference.py`` gives the
hierarchy (``level_chain``, ``coarse_positions``, ``num_levels``). It
follows MGARD's multilevel L2 decomposition (Ainsworth, Tugluk, Whitney,
Klasky: "Multilevel techniques for compression and reduction of
scientific data", the quantized L2-orthogonal decomposition) on a uniform
grid over the unit cube (``normalize_coordinates``), as MGARD-X computes it:

- the hierarchy: an axis of n nodes coarsens to its even positions plus,
  for even n, the last one, until 2 nodes remain; all axes coarsen together;
- per level, finest first: the residual of the level's values from the
  multilinear interpolant of its coarse nodes (every weight 1/2), then the
  coarse values corrected by the L2 projection of that residual onto the
  coarse piecewise-multilinear space: per axis the fine mass matrix and the
  restriction, then per axis the solve of the coarse mass matrix, each an
  O(n) stencil or a Thomas sweep along the axis;
- the s = 0 quantizer of level l: step q / sqrt(vol_l), with
  q = 2 tol / sqrt(N) for N nodes and vol_l the volume of a level-l cell,
  the symbol rounded half away from zero; then the inverse: dequantize and
  recompose, coarsest first;
- the REL norm, and the error norm in which the s = 0 bound is stated.

Departures from the published definition, each MGARD-X's and kept so that
the reference computes the numbers the program must give:

- a level's grid is taken as uniform, spacing 1 / (n_l - 1), though on an
  axis of even size its last cell is half as wide (``hierarchy.py``'s
  uniform ``dist``): the interpolation weights stay 1/2, the coarse mass
  matrix is the uniform one, and vol_l is the product of those spacings;
- on an axis of even size the fine mass stencil runs on an extended grid
  with a zero ghost node before the last node, at no distance from it: the
  last node's own mass vanishes, the ghost passes h/6 of its left
  neighbour's value to the last coarse node, and the last-but-one coarse
  node takes nothing from the ghost;
- the REL norm is the root mean square of the values (MGARD-X's L2 norm
  with normalized coordinates), not the L2 norm of the function; the error
  is measured in the function's L2 norm, sqrt(e^T M e) with M the tensor
  product of each axis's mass matrix on the real (uniform) mesh.

Every function works on the device of its input.
"""

from __future__ import annotations

import math

import torch

from reference import coarse_positions, level_chain, num_levels

F64 = torch.float64


def level_shapes(shape) -> list:
    """Each level's shape, coarsest (0) to finest (num_levels)."""
    L = num_levels(shape)
    chains = [level_chain(n) for n in shape]
    return [tuple(c[L - l] for c in chains) for l in range(L + 1)]


def _move(a, dim: int):
    return a.movedim(dim, 0)


def _back(a, dim: int):
    return a.movedim(0, dim)


def _interpolant(g):
    """Multilinear interpolant of the coarse nodes of the level array g at
    every node (coarse nodes keep their value): one pass per axis, each
    fine position the mean of its two neighbours."""
    a = g
    for d in range(g.ndim):
        n = a.shape[d]
        m = _move(a, d).clone()
        stop = n - 2 if n % 2 == 0 else n  # even n: last two both coarse
        m[1:stop:2] = 0.5 * (m[0:stop - 1:2] + m[2:stop + 1:2])
        a = _back(m, d)
    return a


def _coarse(g):
    """The coarse nodes of the level array g (coarse_positions on each
    axis)."""
    for d in range(g.ndim):
        idx = torch.tensor(coarse_positions(g.shape[d]), device=g.device)
        g = g.index_select(d, idx)
    return g


def _scatter_coarse(c, fine_shape):
    """The level array of fine_shape holding c at its coarse nodes and 0
    elsewhere."""
    out = c
    for d, nf in enumerate(fine_shape):
        shape = list(out.shape)
        shape[d] = nf
        idx = torch.tensor(coarse_positions(nf), device=c.device)
        out = torch.zeros(shape, dtype=c.dtype, device=c.device).index_copy_(
            d, idx, out)
    return out


def _mass_restrict(r, dim: int):
    """R M r along ``dim`` (nf -> nf // 2 + 1 nodes): the fine level's mass
    matrix at spacing h = 1 / (nf - 1), then the restriction (the coarse
    node's own mass value and half of each fine neighbour's), on MGARD-X's
    extended grid for even nf."""
    m = _move(r, dim)
    nf = m.shape[0]
    h = 1.0 / (nf - 1)
    if nf % 2 == 0:
        # extended grid: nodes 0..nf-2, a zero ghost, the last node; the
        # ghost-to-last segment is 0, so the last node's mass is 0 and the
        # ghost's is h/6 of node nf-2 (nothing from itself or the last)
        body = m[: nf - 1]
        mass = torch.empty((nf + 1,) + tuple(m.shape[1:]), dtype=m.dtype,
                           device=m.device)
        _tri_apply(body, h, mass[: nf - 1], right_open=True)
        mass[nf - 1] = (h / 6.0) * body[nf - 2]
        mass[nf] = 0.0
        n_ext = nf + 1
    else:
        mass = torch.empty_like(m)
        _tri_apply(m, h, mass, right_open=False)
        n_ext = nf
    nc = nf // 2 + 1
    out = mass[0:n_ext:2].clone()  # the coarse nodes' own mass values
    odd = mass[1:n_ext:2]          # the fine nodes between them
    if nf % 2 == 0:
        # odd holds nodes 1, 3, ..., nf-3 and the ghost (the last entry):
        # the ghost goes whole to the last coarse node, nothing to its left
        out[: nc - 2] += 0.5 * odd[: nc - 2]
        out[1: nc - 1] += 0.5 * odd[: nc - 2]
        out[nc - 1] += odd[nc - 2]
    else:
        out[:-1] += 0.5 * odd
        out[1:] += 0.5 * odd
    return _back(out, dim)


def _tri_apply(m, h: float, out, right_open: bool):
    """out = (h/6) [1 4 1] m along axis 0, with [2 1] at the left end and
    [1 2] at the right end; with ``right_open`` the right end is an interior
    node whose right neighbour is 0 (the ghost of an even axis)."""
    n = m.shape[0]
    out.copy_(m).mul_(4.0 * h / 6.0)
    out[0] = (2.0 * h / 6.0) * m[0]
    if not right_open:
        out[n - 1] = (2.0 * h / 6.0) * m[n - 1]
    out[1:] += (h / 6.0) * m[:-1]
    out[:-1] += (h / 6.0) * m[1:]


def _mass_solve(b, dim: int):
    """Solve M_c x = b along ``dim``, M_c the mass matrix of nc uniformly
    spaced nodes (spacing 1 / (nc - 1)): a Thomas sweep, one node at a
    time."""
    x = _move(b, dim).clone()
    n = x.shape[0]
    h = 1.0 / (n - 1)
    diag = [4.0 * h / 6.0] * n
    diag[0] = diag[-1] = 2.0 * h / 6.0
    off = h / 6.0
    piv = [diag[0]]
    for i in range(1, n):
        w = off / piv[i - 1]
        piv.append(diag[i] - w * off)
        x[i] -= w * x[i - 1]
    x[n - 1] /= piv[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (x[i] - off * x[i + 1]) / piv[i]
    return _back(x, dim)


def correction(r):
    """The L2 projection of the residual r (a level array, zero at its
    coarse nodes) onto the coarse level: M_c^-1 R M_f on each axis."""
    c = r
    for d in range(r.ndim):
        c = _mass_restrict(c, d)
    for d in range(r.ndim):
        c = _mass_solve(c, d)
    return c


def decompose(x):
    """The multilevel L2 decomposition of x (float64): [coarsest values,
    residual of level 1, ..., residual of the finest level]; a residual is
    its level's array, zero at the level's coarse nodes."""
    cur = x.to(F64)
    parts = []
    for _ in range(num_levels(x.shape)):
        r = cur - _interpolant(cur)
        cur = _coarse(cur) + correction(r)
        parts.append(r)
    return [cur] + parts[::-1]


def recompose(parts):
    """Inverse of decompose."""
    cur = parts[0]
    for r in parts[1:]:
        coarse = cur - correction(r)
        cur = _interpolant(_scatter_coarse(coarse, tuple(r.shape))) + r
    return cur


def rel_norm(x) -> float:
    """The norm a REL bound scales by: the root mean square of x."""
    x = x.to(F64)
    return math.sqrt(float((x * x).sum()) / x.numel())


def steps(shape, tol: float) -> list:
    """The s = 0 quantization step of each level's coefficients, coarsest
    first, for an absolute tolerance tol: q / sqrt(vol_l)."""
    q = 2.0 * tol / math.sqrt(math.prod(shape))
    return [q / math.sqrt(math.prod(1.0 / (k - 1) for k in ls))
            for ls in level_shapes(shape)]


def quantize(c, step: float):
    """Round half away from zero of c / step (float64 integers)."""
    t = c * (1.0 / step)
    return torch.trunc(t + 0.5 * torch.sign(t))


def roundtrip(x, tol: float, mode: str = "REL"):
    """The field the raw codec returns for x at s = 0 under (tol, mode),
    its absolute tolerance and the finest level's step. Returns (float64
    tensor on x's device, abs tol, finest step)."""
    x = x.to(F64)
    abs_tol = tol * rel_norm(x) if mode == "REL" else tol
    st = steps(tuple(x.shape), abs_tol)
    parts = decompose(x)
    deq = [quantize(p, q) * q for p, q in zip(parts, st)]
    del parts
    return recompose(deq), abs_tol, st[-1]


def mass_apply(e):
    """M e, M the tensor product of each axis's mass matrix on the real
    uniform mesh of the unit cube (spacing 1 / (n - 1))."""
    for d in range(e.ndim):
        m = _move(e, d)
        out = torch.empty_like(m)
        _tri_apply(m, 1.0 / (m.shape[0] - 1), out, right_open=False)
        e = _back(out, d)
    return e


def l2_norm(e) -> float:
    """sqrt(e^T M e): the L2 norm of the piecewise-multilinear function
    with nodal values e."""
    e = e.to(F64)
    return math.sqrt(max(float((e * mass_apply(e)).sum()), 0.0))
