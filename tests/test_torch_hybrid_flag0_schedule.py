"""PyTorch port, hybrid flag-0 front end: the lane schedule of K7/K8
(csrc/hybrid.cu on csrc/line8.cuh), emulated in NumPy float32 and held bit
for bit against the plain versions ``local_transform`` / ``local_inverse``;
no JAX.

The emulation follows the kernels step by step: the host's grid plan (8x8
columns of 8-blocks, or groups of eight y-blocks in 2D; segments of whole
tiles where the columns are too few), each warp's z-block of each tile,
the lanes' two z lines, the x and y passes as shuffles from the source
lanes the kernels compute (no x pass in 2D), the z pass along the line,
the output tile staged with line8.cuh's swizzle and stored as rows under
the kernels' line and chunk masks, and K7's corner values staged as rows
of the remainder. Lanes that hold no block (a y-block past a 2D field's
end, a warp past the end of a ragged last tile) carry NaN or random
symbols, so a value of theirs that reached a stored element would show;
every output element must be stored exactly once."""

import numpy as np
import pytest
import torch

from mgard_tpu_torch import highlevel as HL
from mgard_tpu_torch.ops import hybrid as TH

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

_CHAIN = (0xFF, 0xD5, 0x91, 0x81)
NB = 8       # z-blocks a tile of K7 and of K8 (hybrid.cu FWD_NB, INV_NB)
BPS = 2      # blocks an SM (FWD_BPS, INV_BPS)
WAVES = 2
SMS = 132    # an H100's SMs
CH = 2 * NB  # 16-byte chunks of a staged line
LANE = np.arange(32)
XI, J = LANE >> 2, LANE & 3


def _in(lvl, p):
    return (np.right_shift(_CHAIN[lvl], p) & 1).astype(bool)


def _fine(lvl, p):
    return (np.right_shift(_CHAIN[lvl] & ~_CHAIN[lvl + 1], p) & 1).astype(
        bool)


def _rule(lvl, p):
    """local8.cuh::lerp_rule of fine position p: (lp, rp, wl, wr)."""
    if lvl == 0:
        return p - 1, p + 1, np.float32(0.5), np.float32(0.5)
    if lvl == 1 and p == 2:
        return 0, 4, np.float32(0.5), np.float32(0.5)
    if lvl == 1:
        return 4, 7, np.float32(1.0 - 2.0 / 3.0), np.float32(2.0 / 3.0)
    return 0, 7, np.float32(1.0 - 4.0 / 7.0), np.float32(4.0 / 7.0)


def _lane_rules(lvl, pos):
    """Per lane, the rule at its position pos[lane]: (fine, lp, rp, wl,
    wr); a position that is not fine keeps lp = rp = pos (its own lane)."""
    fine = _fine(lvl, pos)
    lp, rp = pos.copy(), pos.copy()
    wl = np.zeros(32, np.float32)
    wr = np.zeros(32, np.float32)
    for i in np.flatnonzero(fine):
        lp[i], rp[i], wl[i], wr[i] = _rule(lvl, int(pos[i]))
    return fine, lp, rp, wl, wr


def _corners(nl):
    return bin(_CHAIN[nl]).count("1")


def _rem_col(nl, p):
    return bin(_CHAIN[nl] & ((1 << p) - 1)).count("1")


def plan(shape, want=None):
    """hybrid.cu plan(): the field as (Xl, Yl, Z), its 8x8 columns (groups
    of eight y-blocks in 2D), tiles of the z walk, and the segments a
    column is split into so that the grid holds `want` blocks (two waves of
    BPS blocks on SMS SMs) where the tiles allow: (Xl, Yl, Z, columns,
    tiles, segments, tiles a segment)."""
    if len(shape) == 2:
        Xl, Yl, Z = shape[0] // 8, 8, shape[1]
    else:
        Xl, Yl, Z = shape
    cols = (Xl + 7) // 8 * (Yl // 8)
    tiles = -(-(Z // 8) // NB)
    want = WAVES * SMS * BPS if want is None else want
    split = 1 if cols >= want else -(-want // cols)
    segt = tiles // min(split, tiles)
    return Xl, Yl, Z, cols, tiles, -(-tiles // segt), segt


class Schedule:
    """The kernels' grid and lane walk of one field (hybrid.cu plan(),
    Walk), with the shuffle sources each pass reads."""

    def __init__(self, shape, nl, want=None):
        self.D2 = len(shape) == 2
        (self.Xl, self.Yl, Z, cols, tiles, self.nseg,
         self.segt) = plan(shape, want)
        self.Z, self.nl, self.K = Z, nl, _corners(nl)
        self.nyc = self.Yl // 8
        self.g = Z // 8
        # every (block, tile): column, segment, tile; then per unit
        # (block, tile, warp) and lane
        units = [(c, s, t) for b in range(cols * self.nseg)
                 for c, s in [divmod(b, self.nseg)]
                 for t in range(s * self.segt,
                                min(tiles, (s + 1) * self.segt))]
        self.tiles_run = units
        col = np.array([u[0] for u in units])
        self.t = np.array([u[2] for u in units])
        self.x0 = col // self.nyc * 8
        self.y0 = col % self.nyc * 8
        P = len(units)
        warp = np.tile(np.arange(NB), P)
        pu = np.repeat(np.arange(P), NB)
        self.pu, self.warp = pu, warp
        x0, y0, t = self.x0[pu, None], self.y0[pu, None], self.t[pu, None]
        live = np.ones((P * NB, 32), bool) if not self.D2 else \
            (x0 + XI < self.Xl)
        self.jz = t * NB + warp[:, None]
        self.has = live & (self.jz < self.g)
        self.live = live
        self.row = ((x0 + XI) * self.Yl + y0 + 2 * J) * Z  # line a, z = 0
        self.col0 = (self.x0 * self.Yl + self.y0) * Z
        self.nlines = (np.minimum(64, 8 * (self.Xl - self.x0)) if self.D2
                       else np.full(P, 64))
        self.nz = np.minimum(NB, self.g - self.t * NB)
        px = 0 if self.D2 else XI
        self.ca = _in(nl, np.broadcast_to(px, 32)) & _in(nl, 2 * J)
        self.cb = _in(nl, np.broadcast_to(px, 32)) & _in(nl, 2 * J + 1)
        rcx = XI if self.D2 else np.array([_rem_col(nl, x) for x in XI])
        rx = rcx * self.K
        self.ra = rx + np.array([_rem_col(nl, 2 * j) for j in J])
        self.rb = rx + np.array([_rem_col(nl, 2 * j + 1) for j in J])
        self.sources = []  # (pass, lane, source lane) of each shuffle

    def rem_row(self, p, r):
        """Walk::rem_row for the columns of tiles p and corner rows r."""
        K, x0, y0 = self.K, self.x0[p], self.y0[p]
        if self.D2:
            return x0 * K + r
        return ((x0 // 8) * K + r // K) * (self.Yl // 8 * K) + \
            (y0 // 8) * K + r % K

    # -- the passes of line8.cuh on lines {"a", "b"}: (units, 32, 8) ------
    def _shfl(self, arr, src, what):
        self.sources.append((what, LANE, src))
        return arr[:, src]

    def xpass(self, w, lvl):
        fine, lp, rp, wl, wr = _lane_rules(lvl, XI)
        sl, sr = 4 * lp + J, 4 * rp + J
        for z in range(8):
            if not _in(lvl, z):
                continue
            for s in "ab":
                left = self._shfl(w[s][..., z], sl, "x")
                right = self._shfl(w[s][..., z], sr, "x")
                w[s][..., z] = np.where(fine, wl * left + wr * right,
                                        w[s][..., z])

    def ypass(self, w, lvl):
        y = 2 * J + (1 if lvl == 0 else 0)
        fine, lp, rp, wl, wr = _lane_rules(lvl, y)
        sl, sr = 4 * XI + (lp >> 1), 4 * XI + (rp >> 1)
        r_own = (rp >> 1) == J
        for z in range(8):
            if not _in(lvl, z):
                continue
            a, b = w["a"][..., z], w["b"][..., z]
            left = a if lvl == 0 else self._shfl(a, sl, "y")
            right = self._shfl(b if lvl == 2 else a, sr, "y")
            right = np.where(r_own, np.where(rp & 1, b, a), right)
            val = wl * left + wr * right
            tgt = "b" if lvl == 0 else "a"
            w[tgt][..., z] = np.where(fine, val, w[tgt][..., z])

    @staticmethod
    def zpass(line, lvl):
        for z in range(8):
            if _fine(lvl, z):
                lp, rp, wl, wr = _rule(lvl, z)
                line[..., z] = wl * line[..., lp] + wr * line[..., rp]

    def interp(self, w, lvl):
        if not self.D2:
            self.xpass(w, lvl)
        self.ypass(w, lvl)
        self.zpass(w["a"], lvl)
        self.zpass(w["b"], lvl)

    def coeff(self, lvl):
        """Per lane and z, is the lane's line a / b value a level-lvl
        coefficient (line8.cuh coeff_at)?"""
        px = np.zeros(32, int) if self.D2 else XI
        out = {}
        for s, y in (("a", 2 * J), ("b", 2 * J + 1)):
            inxy = _in(lvl, px) & _in(lvl, y)
            fxy = _fine(lvl, px) | _fine(lvl, y)
            zz = np.arange(8)
            out[s] = inxy[:, None] & _in(lvl, zz)[None] & \
                (fxy[:, None] | _fine(lvl, zz)[None])
        return out

    def decompose(self, v):
        for lvl in range(self.nl):
            w = {s: a.copy() for s, a in v.items()}
            self.interp(w, lvl)
            m = self.coeff(lvl)
            for s in "ab":
                v[s] = np.where(m[s], v[s] - w[s], v[s])

    def recompose(self, x):
        for lvl in range(self.nl - 1, -1, -1):
            m = self.coeff(lvl)
            y = {s: np.where(m[s], np.float32(0), x[s]) for s in "ab"}
            self.interp(y, lvl)
            for s in "ab":
                x[s] = np.where(m[s], x[s] + y[s], x[s])

    # -- loads, the staged output tile, the staged remainder rows ---------
    def load(self, flat, fill):
        """The lanes' lines of every unit; fill where a lane has no block."""
        out = {}
        for s, off in (("a", 0), ("b", self.Z)):
            idx = (self.row + off + 8 * self.jz)[..., None] + np.arange(8)
            got = flat[np.where(self.has[..., None], idx, 0)]
            out[s] = np.where(self.has[..., None], got, fill)
        return out

    def store_tile(self, lines, out_flat, count):
        """stage_tile into each tile's stage, then store_rows: float4 q of
        line L at q ^ (L/2 mod 8); lines below nlines, chunks below 2*nz."""
        P = len(self.tiles_run)
        ob = np.zeros((P, 64 * CH, 4), lines["a"].dtype)
        sw = LANE & 7
        for s, line_off in (("a", 0), ("b", CH)):
            for half in range(2):
                slot = (2 * LANE)[None] * CH + line_off + \
                    ((2 * self.warp[:, None] + half) ^ sw[None])
                ob[self.pu[:, None], slot] = \
                    lines[s][..., 4 * half:4 * half + 4]
        e = np.arange(64 * CH)
        L, c = e // CH, e % CH
        ok = (L[None] < self.nlines[:, None]) & (c[None] < 2 *
                                                 self.nz[:, None])
        dest = (self.col0[:, None] + ((L >> 3) * self.Yl + (L & 7))[None]
                * self.Z + 8 * NB * self.t[:, None] + 4 * c[None])
        src = ob[:, L * CH + (c ^ ((L >> 1) & 7))]
        pi, ei = np.nonzero(ok)
        d = dest[pi, ei][:, None] + np.arange(4)
        out_flat[d] = src[pi, ei]
        np.add.at(count, d.ravel(), 1)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


def emulate_fwd(v, inv_q, nl, want=None):
    """K7's schedule: (sym int32, rem float32), and the Schedule."""
    S = Schedule(v.shape, nl, want)
    lines = S.load(v.reshape(-1), np.float32(np.nan))
    S.decompose(lines)
    # line_syms: corners to the staged remainder rows, others quantized
    K, P = S.K, len(S.tiles_run)
    RW = NB * K
    R = (8 if S.D2 else K) * K
    rs = np.full((P, R * RW), np.nan, np.float32)
    cm = np.array([bool((_CHAIN[nl] >> z) & 1) for z in range(8)])
    idx = np.array([_rem_col(nl, z) for z in range(8)])
    syms = {}
    for s, corner, rr in (("a", S.ca, S.ra), ("b", S.cb, S.rb)):
        l = lines[s]
        c = (S.has & corner[None])[..., None] & cm[None, None]
        t = l * np.float32(inv_q)
        h = np.where(t < 0, t - np.float32(0.5), t + np.float32(0.5))
        with np.errstate(invalid="ignore"):
            q = np.trunc(np.nan_to_num(h)).astype(np.int32)
        syms[s] = np.where(c, 0, q).astype(np.int32)
        ui, li, zi = np.nonzero(c)
        rs[S.pu[ui], rr[li] * RW + S.warp[ui] * K + idx[zi]] = l[ui, li, zi]
    n = int(np.prod(v.shape))
    sym = np.zeros(n, np.int32)
    count = np.zeros(n, np.int64)
    S.store_tile(syms, sym, count)
    assert (count == 1).all(), "an element stored more or less than once"
    # the remainder rows: row r, float c < nz*K, of present y-blocks
    rshape = TH.remainder_shape(v.shape, nl)
    rem = np.full(int(np.prod(rshape)), np.nan, np.float32)
    rcount = np.zeros(rem.size, np.int64)
    e = np.arange(R * RW)
    r, c = e // RW, e % RW
    ok = c[None] < S.nz[:, None] * K
    if S.D2:
        ok &= (S.x0[:, None] + r[None] // K) < S.Xl
    pi, ei = np.nonzero(ok)
    RZ = S.g * K
    dest = S.rem_row(pi, r[ei]) * RZ + S.t[pi] * RW + c[ei]
    rem[dest] = rs[pi, ei]
    np.add.at(rcount, dest, 1)
    assert (rcount == 1).all(), "a corner stored more or less than once"
    return sym.reshape(v.shape), rem.reshape(rshape), S


def emulate_inv(sym, rem, q, nl, want=None):
    """K8's schedule: the recomposed float32 field, and the Schedule."""
    S = Schedule(sym.shape, nl, want)
    rng = np.random.default_rng(5)
    junk = rng.integers(-2**20, 2**20, (len(S.pu), 32, 8)).astype(np.int32)
    raw = S.load(sym.reshape(-1), junk)
    K = S.K
    RZ = S.g * K
    cm = np.array([bool((_CHAIN[nl] >> z) & 1) for z in range(8)])
    idx = np.array([_rem_col(nl, z) for z in range(8)])
    rflat = rem.reshape(-1)
    lines = {}
    for s, corner, rr in (("a", S.ca, S.ra), ("b", S.cb, S.rb)):
        # line_corners: on && corner at the chain positions, 0 elsewhere
        at = S.rem_row(S.pu[:, None], rr[None]) * RZ + \
            S.warp[:, None] * K + S.t[S.pu][:, None] * NB * K
        on = (S.has & corner[None])[..., None] & cm[None, None]
        cr = np.where(on, rflat[np.where(on, at[..., None] + idx, 0)],
                      np.float32(0))
        deq = raw[s].astype(np.float32) * np.float32(q)
        lines[s] = np.where(corner[None, :, None] & cm[None, None], cr, deq)
    S.recompose(lines)
    n = int(np.prod(sym.shape))
    out = np.full(n, np.nan, np.float32)
    count = np.zeros(n, np.int64)
    S.store_tile(lines, out, count)
    assert (count == 1).all(), "an element stored more or less than once"
    return out.reshape(sym.shape), S


SHAPES = [(64, 200), (24, 40, 56), (8, 1024), (40, 16, 136), (16, 16, 128),
          (72, 64), (64, 256)]


@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_flag0_lane_schedule_matches_plain(shape, nl):
    v = _field(shape, sum(shape) + nl)
    inv_q = float(np.float32(1.0 / 3e-3))
    q = float(np.float32(3e-3))
    sym, rem, S = emulate_fwd(v, inv_q, nl)
    ref_sym, ref_rem = TH.local_transform(torch.from_numpy(v), inv_q, nl)
    assert torch.equal(torch.from_numpy(sym), ref_sym)
    assert torch.equal(torch.from_numpy(rem), ref_rem)
    if S.D2:  # a 2D y pass reads only lanes of the lane's own y-block
        for what, lane, src in S.sources:
            assert what == "y" and ((src >> 2) == (lane >> 2)).all()
    else:  # x shuffles stay on the lane's j, y shuffles on its xi
        for what, lane, src in S.sources:
            same = (src & 3) == (lane & 3) if what == "x" else \
                (src >> 2) == (lane >> 2)
            assert same.all(), what
    out, _ = emulate_inv(ref_sym.numpy(), ref_rem.numpy(), q, nl)
    want = TH.local_inverse(ref_sym, ref_rem, q, nl)
    assert torch.equal(torch.from_numpy(out).view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.parametrize("shape", [(8, 1024), (40, 16, 136), (64, 200)])
def test_flag0_segments_keep_each_warps_blocks(shape):
    """The z walk split into segments (the card's grid) and the whole walk
    in one block a column (want = 1) store the same symbols and remainder,
    and a warp owns z-block t*NB + w of tile t in both."""
    v = _field(shape, 9)
    inv_q = float(np.float32(1.0 / 3e-3))
    seg = emulate_fwd(v, inv_q, 3)
    one = emulate_fwd(v, inv_q, 3, want=1)
    assert seg[2].nseg > 1 and one[2].nseg == 1
    for a, b in zip(seg[:2], one[:2]):
        np.testing.assert_array_equal(a, b)
    for S in (seg[2], one[2]):
        assert (S.jz == S.t[S.pu][:, None] * NB + S.warp[:, None]).all()
        # each column's z-blocks, each walked by exactly one warp
        u = np.flatnonzero(S.jz[:, 0] < S.g)
        pairs = set(zip(S.x0[S.pu[u]], S.y0[S.pu[u]], S.jz[u, 0]))
        cols = len(set(zip(S.x0, S.y0)))
        assert len(pairs) == len(u) == cols * S.g


@pytest.mark.parametrize("shape,blocks,nseg", [
    ((512, 512, 512), 4096, 1), ((8192, 8192), 768, 6),
    ((8, 8, 65536), 1024, 1024), ((72, 8192), 256, 128),
    ((64, 200), 4, 4), ((24, 40, 56), 15, 1)])
def test_flag0_grid_fills_the_card(shape, blocks, nseg):
    """plan(): at least two waves of BPS blocks on each of 132 SMs wherever
    the z axis has the tiles for it (8192^2: 128 groups; (8, 8, 65536): one
    column); the ragged last tile of (64, 200) and (24, 40, 56) (Z/8 = 25
    and 7) is a tile of its own."""
    _, _, _, cols, tiles, got_nseg, segt = plan(shape)
    assert (cols * got_nseg, got_nseg) == (blocks, nseg)
    assert cols * got_nseg >= min(WAVES * SMS * BPS, cols * tiles)
    assert (got_nseg - 1) * segt < tiles <= got_nseg * segt


def test_front_input_copies_only_a_misaligned_view():
    """highlevel._front_input: the front ends' kernels load 16-byte
    vectors, so a caller's view at another offset is copied; an aligned
    contiguous subdomain is handed over as it is."""
    base = torch.arange(4 + 8 * 8 * 16, dtype=torch.float32)
    view = base[1:1 + 8 * 8 * 16].view(8, 8, 16)
    got = HL._front_input(view, (8, 8, 16))
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    whole = torch.zeros((8, 8, 16))
    assert HL._front_input(whole, (8, 8, 16)).data_ptr() == whole.data_ptr()
