"""Plain reference of what the cells compute, in float64 torch.

It imports nothing of the program. It follows MGARD's definitions at s = inf
(no L2 correction, so every coarse node keeps its value and a coefficient is
the node's value minus the multilinear interpolant of the next coarser grid):

- the uniform multilevel hierarchy: an axis of n nodes coarsens to the even
  positions plus, for even n, the last one, until 2 nodes remain; all axes
  coarsen together. On a uniform grid every interpolation weight is 1/2,
  taken on the positions of the level's grid;
- the Hybrid front end: each 8^3 block runs three local levels over the
  in-block chains (0..7) -> (0,2,4,6,7) -> (0,4,7) -> (0,7) with geometric
  weights, and the block corners (positions 0 and 7) form the remainder,
  which runs the multilevel hierarchy; every coefficient is quantized by one
  step q = 2 tol / (levels + 1), rounded half away from zero;
- the MDR sign-magnitude bitplanes: per level the exponent
  e = ceil(log2(max |c|)), the magnitude round(|c| 2^(31 - e)) on 32 bits,
  and a read of b planes keeps its top b bits and adds half of the first
  plane dropped.

Every function works on the device of its input.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64

# In-block chains of the Hybrid local levels (the block corners remain).
CHAINS = [(0, 1, 2, 3, 4, 5, 6, 7), (0, 2, 4, 6, 7), (0, 4, 7), (0, 7)]


def level_chain(n: int) -> list:
    """Axis sizes from finest to coarsest: n, n // 2 + 1, ..., 2."""
    chain = []
    while n > 2:
        chain.append(n)
        n = n // 2 + 1
    return chain + [2]


def coarse_positions(n: int) -> list:
    """Positions of an n-node level grid that the next coarser grid keeps."""
    keep = list(range(0, n, 2))
    if n % 2 == 0:
        keep.append(n - 1)
    return keep


def num_levels(shape) -> int:
    """l_target: the number of coarsening steps (all axes together)."""
    return min(len(level_chain(n)) for n in shape) - 1


def level_grids(shape, device) -> list:
    """grids[l][d]: natural indices of axis d's level-l nodes, l = 0 the
    coarsest, l = num_levels(shape) every node."""
    L = num_levels(shape)
    grids = [[torch.arange(n, device=device) for n in shape]]
    for _ in range(L):
        grids.append([g[coarse_positions(len(g))] for g in grids[-1]])
    return grids[::-1]


def _lerp_pass(a, dim: int, pos, left, right, t):
    """a[pos] = (1 - t) a[left] + t a[right] along ``dim`` (t per position)."""
    shape = [1] * a.ndim
    shape[dim] = -1
    t = t.reshape(shape)
    val = (1.0 - t) * a.index_select(dim, left) + t * a.index_select(dim,
                                                                     right)
    return a.index_copy(dim, pos, val)


def _uniform_fine(n: int, device):
    """Fine positions of an n-node level grid with their neighbours."""
    keep = set(coarse_positions(n))
    pos = torch.tensor([p for p in range(n) if p not in keep],
                       dtype=torch.long, device=device)
    return pos, pos - 1, pos + 1, torch.full(pos.shape, 0.5, dtype=F64,
                                             device=device)


def _interpolant(g, dims, specs):
    """Multilinear interpolant of the coarse nodes at every node of g
    (one lerp pass per axis; coarse nodes keep their value)."""
    a = g
    for dim, spec in zip(dims, specs):
        if spec[0].numel():
            a = _lerp_pass(a, dim, *spec)
    return a


def _fine_any(sizes, fine_sets, device):
    """Mask of the nodes fine on at least one axis (broadcast shape)."""
    m = None
    for d, (n, fine) in enumerate(zip(sizes, fine_sets)):
        v = torch.zeros(n, dtype=torch.bool, device=device)
        v[fine] = True
        shape = [1] * len(sizes)
        shape[d] = n
        v = v.reshape(shape)
        m = v if m is None else (m | v)
    return m


def _sub(x, idx):
    for d, i in enumerate(idx):
        x = x.index_select(d, i)
    return x


def _put(x, idx, val):
    x[tuple(torch.meshgrid(*idx, indexing="ij"))] = val


def decompose(x):
    """Multilevel coefficients in natural layout (float64) and each node's
    level (int8, 0 = the coarsest grid, whose nodes keep their value)."""
    x = x.to(F64)
    dev = x.device
    grids = level_grids(x.shape, dev)
    out = x.clone()
    level = torch.zeros(x.shape, dtype=torch.int8, device=dev)
    for l in range(len(grids) - 1, 0, -1):
        idx = grids[l]
        g = _sub(x, idx)
        specs = [_uniform_fine(len(i), dev) for i in idx]
        a = _interpolant(g, range(x.ndim), specs)
        fine = _fine_any(g.shape, [s[0] for s in specs], dev)
        _put(out, idx, torch.where(fine, g - a, g))
        _put(level, idx, torch.where(fine, l, 0).to(torch.int8))
    return out, level


def recompose(c):
    """Inverse of decompose: nodal values from coefficients (float64)."""
    c = c.to(F64)
    dev = c.device
    grids = level_grids(c.shape, dev)
    out = torch.zeros_like(c)
    _put(out, grids[0], _sub(c, grids[0]))
    for l in range(1, len(grids)):
        idx = grids[l]
        g = _sub(out, idx)
        specs = [_uniform_fine(len(i), dev) for i in idx]
        a = _interpolant(g, range(c.ndim), specs)
        fine = _fine_any(g.shape, [s[0] for s in specs], dev)
        _put(out, idx, torch.where(fine, _sub(c, idx) + a, g))
    return out


def quantize(c, q: float):
    """Round half away from zero of c / q (float64 integers)."""
    t = c / q
    return torch.trunc(t + 0.5 * torch.sign(t))


# -- Hybrid --------------------------------------------------------------
def _local_specs(lvl: int, device):
    fine_chain, coarse = CHAINS[lvl], set(CHAINS[lvl + 1])
    pos, left, right, t = [], [], [], []
    for i, p in enumerate(fine_chain):
        if p in coarse:
            continue
        li = max(j for j in range(i) if fine_chain[j] in coarse)
        ri = min(j for j in range(i + 1, len(fine_chain))
                 if fine_chain[j] in coarse)
        lp, rp = fine_chain[li], fine_chain[ri]
        pos.append(p)
        left.append(lp)
        right.append(rp)
        t.append((p - lp) / (rp - lp))
    as_long = lambda v: torch.tensor(v, dtype=torch.long, device=device)
    return (as_long(pos), as_long(left), as_long(right),
            torch.tensor(t, dtype=F64, device=device))


def _local_mask(D: int, lvl: int, device):
    """Nodes of the level's chain on every axis and fine on one or more."""
    in_grid = torch.zeros(8, dtype=torch.bool, device=device)
    in_grid[list(CHAINS[lvl])] = True
    fine = in_grid.clone()
    fine[list(CHAINS[lvl + 1])] = False
    m_grid = m_fine = None
    for d in range(D):
        shape = [1] * (2 * D)
        shape[2 * d + 1] = 8
        g, f = in_grid.reshape(shape), fine.reshape(shape)
        m_grid = g if m_grid is None else (m_grid & g)
        m_fine = f if m_fine is None else (m_fine | f)
    return m_grid & m_fine


def _blocks(x):
    shape = []
    for n in x.shape:
        shape += [n // 8, 8]
    return x.reshape(shape)


def _corner_mask(D: int, device):
    c = torch.zeros(8, dtype=torch.bool, device=device)
    c[list(CHAINS[3])] = True
    m = None
    for d in range(D):
        shape = [1] * (2 * D)
        shape[2 * d + 1] = 8
        m = c.reshape(shape) if m is None else (m & c.reshape(shape))
    return m


def hybrid_levels(shape, nl: int = 3) -> int:
    """Levels of the Hybrid hierarchy: nl local ones and the remainder's."""
    return nl + num_levels(tuple(n // 8 * 2 for n in shape))


def hybrid_roundtrip(x, tol: float):
    """The field the Hybrid codec (three local levels) returns at s = inf
    under an absolute tolerance: every coefficient quantized by one step.
    Axes must be multiples of 8. Returns float64 on x's device."""
    shape = tuple(x.shape)
    if any(n % 8 for n in shape):
        raise ValueError(f"axes must be multiples of 8, got {shape}")
    D, dev = x.ndim, x.device
    q = 2.0 * tol / (hybrid_levels(shape) + 1)
    b = _blocks(x.to(F64))
    dims = [2 * d + 1 for d in range(D)]
    corners = _corner_mask(D, dev)
    # local coefficients, from the field's values
    coef = b.clone()
    for lvl in range(3):
        specs = [_local_specs(lvl, dev)] * D
        a = _interpolant(b, dims, specs)
        coef = torch.where(_local_mask(D, lvl, dev), b - a, coef)
    deq = torch.where(corners, coef, quantize(coef, q) * q)
    del coef
    # remainder: the corners, through the multilevel hierarchy
    cols = torch.tensor(CHAINS[3], device=dev)
    rem = b
    for d in dims:
        rem = rem.index_select(d, cols)
    rem = rem.reshape(tuple(n // 8 * 2 for n in shape))
    rem_c, _ = decompose(rem)
    rem_r = recompose(quantize(rem_c, q) * q)
    full = list(deq.shape)
    r = rem_r.reshape([s for n in shape for s in (n // 8, 2)])
    for d in dims:
        full_d = list(r.shape)
        full_d[d] = 8
        r = torch.zeros(full_d, dtype=F64, device=dev).index_copy_(d, cols, r)
    out = torch.where(corners, r.reshape(full), deq)
    del deq, r
    # local recompose, coarsest local level first
    for lvl in range(2, -1, -1):
        specs = [_local_specs(lvl, dev)] * D
        a = _interpolant(out, dims, specs)
        out = torch.where(_local_mask(D, lvl, dev), out + a, out)
    return out.reshape(shape)


# -- MDR -----------------------------------------------------------------
def level_exponent(amax: float) -> int:
    """ceil(log2(amax)), 0 for amax == 0."""
    if amax <= 0.0:
        return 0
    m, e = math.frexp(amax)
    return e - 1 if m == 0.5 else e


def truncate_planes(c, b: int, B: int = 32):
    """The values a sign-magnitude read of b of B planes gives for one
    level's coefficients c (float64)."""
    if b <= 0:
        return torch.zeros_like(c)
    e = level_exponent(float(c.abs().max()))
    frac = B - 1 - e
    mag = torch.clamp(torch.floor(c.abs() * 2.0 ** frac + 0.5),
                      max=2.0 ** (B - 1) - 1)
    drop = 2.0 ** (B - b)
    kept = torch.floor(mag / drop) * drop
    if b < B:
        kept = kept + (kept > 0).to(F64) * (drop / 2)
    return torch.sign(c) * kept * 2.0 ** (-frac)


def mdr_read(coeffs, levels, counts, B: int = 32):
    """Reconstruction from counts[l] magnitude planes of level l."""
    kept = torch.zeros_like(coeffs)
    for l, b in enumerate(counts):
        m = levels == l
        kept[m] = truncate_planes(coeffs[m], int(b), B)
    return recompose(kept)
