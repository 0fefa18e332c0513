"""PyTorch port, K14 thread schedule: a NumPy emulation of what each thread
of csrc/multidim.cu reads and writes (no card).

K14 runs one MultiDim level step of a 3D field. Its launches, as the
emulation follows them:

- resid_kernel / interp_kernel: blocks of (bx, 128 / bx) threads, bx the
  power of two from 32 to 128 that covers the (nf2 + 1) / 2 pairs of a
  row; thread x takes the pair (2t, 2t + 1) of the contiguous axis, thread
  y walks the rows (i, j) in steps of gridDim.y * by (grid.y at most
  65535). Residuals go to their reordered positions of the output (t and
  nc + t), coarse values to the coarse box;
- restrict_kernel: the same shape of block, a thread per output element;
  the 5-point stencil of a coarse node over the extended axis (the ghost
  of an even axis skipped), the first pass reading the nested box with
  the all-coarse corner as 0;
- thomas_kernel: 128 threads, a warp per 32 lines, chunks of 32 positions
  through a 32 x 33 tile (tl[position][line]), loaded and stored as rows;
  the contiguous axis transposes through it and adds its result into the
  coarse box.

The emulation runs the Python host side (ops/multidim.py: its buffers,
strides and tables) with the two level wrappers replaced by these
emulated launches, checks that every output element of every pass is
written exactly once and every read stays in its buffer, and holds the
result against the dense operators (refactor.decompose on the CPU:
_interp_matrix, _reorder_matrix, _corr_matrix, _scatter_matrix) and the
slice path: to 1e-13 of the largest value in float64 and 1e-6 in
float32, on odd axes, even axes with the ghost node (500 -> 251,
18 -> 10), axes of 3 and 2, uniform and non-uniform coordinates, both
bases, decompose, recompose and the round trip."""

import math

import numpy as np
import pytest
import torch

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import multidim as MD, refactor as R

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

NT, GRID_Y_MAX = 128, 65535


class Axis:
    """csrc/multidim.cu axis_at(): one axis of a level's table."""

    def __init__(self, tab, off, nf):
        self.nf, self.nc = nf, nf // 2 + 1
        self.ncoef = nf - self.nc
        self.ghost = int(nf % 2 == 0 and nf != 2)
        k, c = self.ncoef, self.nc
        self.wl = tab[off:off + k]
        self.wr = tab[off + k:off + 2 * k]
        self.W = tab[off + 2 * k:off + 2 * k + 5 * c].reshape(c, 5)
        o = off + 2 * k + 5 * c
        self.f, self.binv, self.g = (tab[o:o + c], tab[o + c:o + 2 * c],
                                     tab[o + 2 * c:o + 3 * c])
        self.end = o + 3 * c


def _axes(tab, nf):
    out, off = [], 0
    for n in nf:
        a = Axis(tab, off, n)
        out.append(a)
        off = a.end
    assert off == tab.size, "the table holds exactly the three axes"
    return out


def is_coef(i, nf):
    return ((i & 1) == 1) & (i < nf - 1)


def reo(i, nf, nc):
    return np.where(is_coef(i, nf), nc + (i >> 1),
                    np.where(i == nf - 1, nc - 1, i >> 1))


def phys(e, nf, ghost):
    bad = (e < 0) | (e >= nf + ghost) | ((ghost == 1) & (e == nf - 1))
    return np.where(bad, -1, np.where((ghost == 1) & (e == nf), nf - 1, e))


def block_for(nx):
    bx = 32
    while bx < nx and bx < NT:
        bx *= 2
    return bx, NT // bx


def grid_for(nx, rows, b):
    return -(-nx // b[0]), min(-(-rows // b[1]), GRID_Y_MAX)


def _threads(nx, rows):
    """The (row, x) pairs of one launch, from its grid: x = blockIdx.x * bx
    + threadIdx.x below nx; each thread y walks r = blockIdx.y * by +
    threadIdx.y, then steps of gridDim.y * by. Checks that every row is
    walked exactly once."""
    b = block_for(nx)
    g = grid_for(nx, rows, b)
    xs = np.arange(g[0] * b[0])
    xs = xs[xs < nx]
    starts = np.arange(g[1] * b[1])
    walked = np.concatenate([np.arange(s, rows, g[1] * b[1])
                             for s in starts]) if rows else np.zeros(0, int)
    assert np.array_equal(np.sort(walked), np.arange(rows))
    return np.arange(rows)[:, None], xs[None, :]


class Mem:
    """A flat buffer with its bounds checked on every read and a count of
    the writes to each element."""

    def __init__(self, t):
        self.a = t.reshape(-1).numpy() if isinstance(t, torch.Tensor) else t
        self.hits = np.zeros(self.a.size, np.int64)

    def read(self, idx, mask=None):
        idx = np.asarray(idx)
        if mask is None:
            mask = np.ones(idx.shape, bool)
        idx, mask = np.broadcast_arrays(idx, mask)
        assert ((idx[mask] >= 0) & (idx[mask] < self.a.size)).all()
        return self.a[np.where(mask, idx, 0)]

    def write(self, idx, val, mask):
        idx, val, mask = np.broadcast_arrays(idx, val, mask)
        self.a[idx[mask]] = val[mask]
        np.add.at(self.hits, idx[mask], 1)


def _lerp(wl, a, wr, b):
    return wl * a + wr * b


def emu_resid(v, out, S, cd, C, a0, a1, a2):
    """resid_kernel; returns the written element counts of out and cd."""
    r, t = _threads((a2.nf + 1) // 2, a0.nf * a1.nf)
    i, j = r // a1.nf, r % a1.nf
    ci, cj = is_coef(i, a0.nf), is_coef(j, a1.nf)
    i2, j2 = np.where(ci, i >> 1, 0), np.where(cj, j >> 1, 0)
    z = v.a.dtype.type(0)
    wl0, wr0 = np.where(ci, a0.wl[i2], z), np.where(ci, a0.wr[i2], z)
    wl1, wr1 = np.where(cj, a1.wl[j2], z), np.where(cj, a1.wr[j2], z)
    P0, P1 = a1.nf * a2.nf, a2.nf
    row = i * P0 + j * P1

    def A(p, m):
        return np.where(ci, _lerp(wl0, v.read(p - P0, m & ci), wr0,
                                  v.read(p + P0, m & ci)), v.read(p, m))

    def X(k, m):
        p = row + k
        return np.where(cj, _lerp(wl1, A(p - P1, m & cj), wr1,
                                  A(p + P1, m & cj)), A(p, m))

    corner = ~ci & ~cj
    ri, rj = reo(i, a0.nf, a0.nc), reo(j, a1.nf, a1.nc)
    o, oc = ri * S[0] + rj * S[1], ri * C[0] + rj * C[1]
    all_ = np.ones(corner.shape[0:1] + t.shape[1:], bool)
    k0 = 2 * t
    x0, v0 = X(k0, all_), v.read(row + k0, all_)
    cd.write(oc + t, v0, corner & all_)
    out.write(o + t, v0 - x0, ~corner & all_)
    has1 = k0 + 1 < a2.nf
    v1 = v.read(row + k0 + 1, has1 & all_)
    cf = has1 & (t < a2.ncoef)
    tt = np.where(cf, t, 0)
    x1c = _lerp(a2.wl[tt], x0, a2.wr[tt], X(k0 + 2, cf & all_))
    out.write(o + a2.nc + t, v1 - x1c, cf & all_)
    last = has1 & ~cf
    cd.write(oc + a2.nc - 1, v1, last & corner)
    out.write(o + a2.nc - 1, v1 - X(k0 + 1, last & all_), last & ~corner)


def emu_interp(dec, S, c, dst, a0, a1, a2):
    """interp_kernel."""
    r, t = _threads((a2.nf + 1) // 2, a0.nf * a1.nf)
    i, j = r // a1.nf, r % a1.nf
    ci, cj = is_coef(i, a0.nf), is_coef(j, a1.nf)
    i2, j2 = np.where(ci, i >> 1, 0), np.where(cj, j >> 1, 0)
    z = dst.a.dtype.type(0)
    wl0, wr0 = np.where(ci, a0.wl[i2], z), np.where(ci, a0.wr[i2], z)
    wl1, wr1 = np.where(cj, a1.wl[j2], z), np.where(cj, a1.wr[j2], z)
    i0 = np.where(ci, i >> 1, reo(i, a0.nf, a0.nc))
    j0 = np.where(cj, j >> 1, reo(j, a1.nf, a1.nc))
    Q0, Q1 = a1.nc * a2.nc, a2.nc
    crow = i0 * Q0 + j0 * Q1

    def A(p, m):
        return np.where(ci, _lerp(wl0, c.read(p, m & ci), wr0,
                                  c.read(p + Q0, m & ci)), c.read(p, m))

    def X(kc, m):
        p = crow + kc
        return np.where(cj, _lerp(wl1, A(p, m & cj), wr1, A(p + Q1, m & cj)),
                        A(p, m))

    corner = ~ci & ~cj
    o = reo(i, a0.nf, a0.nc) * S[0] + reo(j, a1.nf, a1.nc) * S[1]
    drow = i * a1.nf * a2.nf + j * a2.nf
    all_ = np.ones(corner.shape[0:1] + t.shape[1:], bool)
    x0 = X(t, all_)
    dst.write(drow + 2 * t, np.where(corner, x0, x0 + dec.read(
        o + t, ~corner & all_)), all_)
    has1 = 2 * t + 1 < a2.nf
    cf = has1 & (t < a2.ncoef)
    tt = np.where(cf, t, 0)
    x1c = _lerp(a2.wl[tt], x0, a2.wr[tt], X(t + 1, cf & all_))
    dst.write(drow + 2 * t + 1, x1c + dec.read(o + a2.nc + t, cf & all_), cf)
    last = has1 & ~cf
    x1 = X(np.full_like(t, a2.nc - 1), last & all_)
    dst.write(drow + 2 * t + 1, np.where(corner, x1, x1 + dec.read(
        o + a2.nc - 1, last & ~corner)), last & all_)


def emu_restrict(src, S, outp, n, ax, AX, reo_in, b1=None, b2=None):
    """restrict_kernel<AX, REO>: input shape n (compact unless reo_in),
    output n with axis AX shrunk to ax.nc."""
    o = list(n)
    o[AX] = ax.nc
    r, z = _threads(o[2], o[0] * o[1])
    a, b = r // o[1], r % o[1]
    jc = (a, b, z)[AX] + 0 * (a + z)
    acc = np.zeros(jc.shape, outp.a.dtype)
    if reo_in:
        cbz = ~is_coef(b, b1.nf) & ~is_coef(z, b2.nf)
        oyz = reo(b, b1.nf, b1.nc) * S[1] + reo(z, b2.nf, b2.nc)
    for q in range(5):
        e = phys(2 * jc + q - 2, ax.nf, ax.ghost)
        ok = e >= 0
        if reo_in:
            zero = cbz & ~is_coef(e, ax.nf)
            x = np.where(zero, 0, src.read(reo(e, ax.nf, ax.nc) * S[0] + oyz,
                                           ok & ~zero))
        else:
            idx = ((a * n[1] + e) * n[2] + z if AX == 1
                   else (a * n[1] + b) * n[2] + e)
            x = src.read(idx, ok)
        acc = np.where(ok, acc + ax.W[jc, q] * x.astype(acc.dtype), acc)
    outp.write((a * o[1] + b) * o[2] + z, acc, np.ones(acc.shape, bool))


def emu_thomas(x, nlines, n, inner, outer, stride, ax, contig, c=None,
               C=(0, 0), nb=1, sign=1):
    """thomas_kernel<CONTIG>: every warp of the grid, its 32 lanes and its
    32 x 33 tile, vectorized over the warps. Returns the per-phase write
    counts of x (each element stored once a phase) and the hits of c."""
    dt = x.a.dtype.type
    nw = -(-nlines // 32)
    L0 = 32 * np.arange(nw)[:, None]  # (warps, 1)
    lane = np.arange(32)[None, :]
    nch = -(-n // 32)
    live = L0 + lane < nlines  # (warps, 32 lines)
    if not contig:
        q = (L0 + lane) // inner
        base = q * outer + (L0 + lane - q * inner)
    tl = np.full((nw, 32, 33), np.nan, x.a.dtype)  # [warp, position, line]
    phase_hits = []

    def load(c0):
        p = np.arange(32)
        if contig:  # lane reads position c0 + lane of line L0 + l
            pos = c0 + lane[:, :, None]  # (1, 32 lanes, 1)
            ln = L0[:, :, None] + np.arange(32)[None, None, :]
            m = (ln < nlines) & (pos < n)
            tl[:, :32, :32] = np.where(m, x.read(ln * n + pos, m),
                                       tl[:, :32, :32])
        else:  # lane reads its line at positions c0 + p
            pos = c0 + p[None, :, None]
            m = live[:, None, :] & (pos < n)
            tl[:, :32, :32] = np.where(m, x.read(base[:, None, :] + pos
                                                 * stride, m),
                                       tl[:, :32, :32])

    def store(c0):
        p = np.arange(32)
        if contig:
            pos = c0 + lane[:, :, None]
            ln = L0[:, :, None] + np.arange(32)[None, None, :]
            m = (ln < nlines) & (pos < n)
            x.write(ln * n + pos, tl[:, :32, :32], m)
        else:
            pos = c0 + p[None, :, None]
            m = live[:, None, :] & (pos < n)
            x.write(base[:, None, :] + pos * stride, tl[:, :32, :32], m)

    def phase_done():
        phase_hits.append(x.hits.copy())
        x.hits[:] = 0

    y = np.zeros((nw, 32), x.a.dtype)
    for ch in range(nch):
        c0 = 32 * ch
        load(c0)
        for p in range(min(32, n - c0)):
            col = c0 + p
            d = tl[:, p, :32]
            y = d if col == 0 else d + ax.f[col] * y
            tl[:, p, :32] = y
        if nch > 1:
            store(c0)
    if nch > 1:
        phase_done()
    xn = np.zeros((nw, 32), x.a.dtype)
    for ch in range(nch - 1, -1, -1):
        c0 = 32 * ch
        if nch > 1:
            load(c0)
        for p in range(min(31, n - 1 - c0), -1, -1):
            col = c0 + p
            d = tl[:, p, :32] * ax.binv[col]
            xn = d if col == n - 1 else d + ax.g[col] * xn
            tl[:, p, :32] = xn
        if contig:
            pos = c0 + lane[:, :, None]  # (1, 32 lanes, 1)
            ln = L0[:, :, None] + np.arange(32)[None, None, :]
            aa, bb = ln // nb, ln % nb
            m = (ln < nlines) & (pos < n)
            idx = aa * C[0] + bb * C[1] + pos
            c.write(idx, c.read(idx, m) + dt(sign) * tl[:, :32, :32], m)
        else:
            store(c0)
    if not contig:
        phase_done()
    return phase_hits


def emu_correction(r, S, c, C, sign, scr, a0, a1, a2):
    f = (a0.nf, a1.nf, a2.nf)
    n1 = a0.nc * f[1] * f[2]
    n2 = a0.nc * a1.nc * f[2]
    n3 = a0.nc * a1.nc * a2.nc
    t1, t2, t3 = (Mem(scr.a[o:o + n]) for o, n in (
        (0, n1), (n1, n2), (n1 + n2, n3)))
    emu_restrict(r, S, t1, f, a0, 0, True, a1, a2)
    emu_restrict(t1, None, t2, (a0.nc, f[1], f[2]), a1, 1, False)
    emu_restrict(t2, None, t3, (a0.nc, a1.nc, f[2]), a2, 2, False)
    for t in (t1, t2, t3):
        assert (t.hits == 1).all(), "every restricted element written once"
    plane = a1.nc * a2.nc
    t3.hits[:] = 0
    for hits in (emu_thomas(t3, plane, a0.nc, plane, 0, plane, a0, False)
                 + emu_thomas(t3, a0.nc * a2.nc, a1.nc, a2.nc, plane, a2.nc,
                              a1, False)):
        assert (hits == 1).all(), "a sweep stores every element once"
    t3.hits[:] = 0
    for hits in emu_thomas(t3, a0.nc * a1.nc, a2.nc, 0, 0, 1, a2, True, c,
                           C, a1.nc, sign):
        assert (hits == 1).all()


def emu_decompose_level(src, out, cd, cstr, tab, scr, nf, orthogonal):
    """What multidim.decompose_level launches, on CPU tensors."""
    a0, a1, a2 = _axes(tab.numpy(), nf)
    v, o, c = Mem(src), Mem(out), Mem(cd)
    emu_resid(v, o, out.stride()[:2], c, cstr, a0, a1, a2)
    # every element of the level box but the coarse corner, and every
    # element of the coarse box, written once
    box = np.zeros(out.shape, bool)
    box[:nf[0], :nf[1], :nf[2]] = True
    box[:a0.nc, :a1.nc, :a2.nc] = False
    assert (o.hits[box.ravel()] == 1).all() and not o.hits[~box.ravel()].any()
    want = np.zeros(c.a.size, bool)
    idx = (np.arange(a0.nc)[:, None, None] * cstr[0]
           + np.arange(a1.nc)[None, :, None] * cstr[1]
           + np.arange(a2.nc)[None, None, :])
    want[idx.ravel()] = True
    assert (c.hits[want] == 1).all() and not c.hits[~want].any()
    if orthogonal:
        c.hits[:] = 0
        emu_correction(o, out.stride()[:2], c, cstr, 1, Mem(scr), a0, a1, a2)
        assert (c.hits[want] == 1).all() and not c.hits[~want].any()


def emu_recompose_level(dec, c, dst, tab, scr, nf, orthogonal):
    a0, a1, a2 = _axes(tab.numpy(), nf)
    d, cm, out = Mem(dec), Mem(c), Mem(dst)
    nc = (a0.nc, a1.nc, a2.nc)
    if orthogonal:
        emu_correction(d, dec.stride()[:2], cm, (nc[1] * nc[2], nc[2]), -1,
                       Mem(scr), a0, a1, a2)
        assert (cm.hits[:math.prod(nc)] == 1).all()
    emu_interp(d, dec.stride()[:2], cm, out, a0, a1, a2)
    n = math.prod(nf)
    assert (out.hits[:n] == 1).all() and not out.hits[n:].any()


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(MD, "decompose_level", emu_decompose_level)
    monkeypatch.setattr(MD, "recompose_level", emu_recompose_level)


def _coords(shape, seed):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.uniform(0.3, 1.7, n)) for n in shape]


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    v = np.sin(3 * g[0]) * np.cos(2 * g[1]) + g[2] ** 2 + 0.1 * (
        rng.standard_normal(shape))
    return torch.from_numpy(v.astype(dtype))


TOL = {np.float64: 1e-13, np.float32: 1e-6}


def _close(got, want, dtype):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (err, scale)


SHAPES = [
    (9, 17, 5),  # odd axes, two levels
    (18, 10, 12),  # even axes: 18 -> 10 -> 6 -> 4 -> 3, ghost nodes
    (3, 4, 500),  # 500 -> 251 on the contiguous axis (eight tile chunks)
    (500, 3, 4),  # 500 -> 251 on axis 0
    (4, 500, 3),  # and on axis 1
    (3, 3, 3),  # one level, every axis 3 -> 2
    (2, 9, 9),  # an axis of 2: no level, the identity
    (33, 18, 40),  # several levels, mixed parities
]
CASES = [(s, d, u, o) for s in SHAPES for d in (np.float64, np.float32)
         for u in (True, False) for o in (True, False)]


def _ids(c):
    s, d, u, o = c
    return (f"{'x'.join(map(str, s))}-{np.dtype(d).name}-"
            f"{'uniform' if u else 'coords'}-{'L2' if o else 'hier'}")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_schedule_matches_dense_and_slice_paths(case, emulated):
    shape, dtype, uniform, orth = case
    coords = None if uniform else _coords(shape, sum(shape))
    hier = Hierarchy(shape, dtype, coords)
    v = _field(shape, dtype, len(shape) + shape[0])
    dec = MD.decompose(v, hier, orth)
    dense = R.decompose(v, hier, orth)
    _close(dec, dense, dtype)
    if hier.l_target:
        sl = R._levels(v, hier, range(hier.l_target, 0, -1),
                       R.decompose_level, orth)
        _close(dec, sl, dtype)
    # recompose of an arbitrary nested-box array, and the round trip
    w = _field(shape, dtype, 7)
    _close(MD.recompose(w, hier, orth), R.recompose(w, hier, orth), dtype)
    _close(MD.recompose(dec, hier, orth), v, dtype)
    assert torch.equal(v, _field(shape, dtype, len(shape) + shape[0]))


def test_tables_match_the_axis_operators():
    """The 5-point stencil of axis_table is mass_restrict_axis, and the
    table's layout is the kernel's (axis_at)."""
    from mgard_tpu_torch.ops.axis import mass_restrict_axis

    for shape in ((18, 9, 500), (7, 4, 3)):
        hier = Hierarchy(shape, np.float64, _coords(shape, 3))
        for l in range(1, hier.l_target + 1):
            tab = MD.level_table(hier, l)
            axes = _axes(tab, hier.level_shape[l])
            for al, ax in zip(hier.axis[l - 1], axes):
                eye = np.eye(al.n_fine)
                want = mass_restrict_axis(eye, 0, al)
                got = np.zeros_like(want)
                for j in range(al.n_coarse):
                    for q in range(5):
                        e = int(phys(np.array(2 * j + q - 2), al.n_fine,
                                     ax.ghost))
                        if e >= 0:
                            got[j] += ax.W[j, q] * eye[e]
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
                np.testing.assert_array_equal(ax.f, al.fwd_f)
