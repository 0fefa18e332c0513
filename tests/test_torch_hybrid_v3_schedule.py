"""PyTorch port, K10/K11 thread schedule: a NumPy emulation of what each
thread of csrc/hybrid_v3.cu computes (no JAX, no card).

A cluster of 16 thread blocks is one (8, 128, Z) tile; block r owns the 8x8
(x, y) column at y = 8r of the tile, chunk rows xi*128 + 8r + yi of the
superblock, and keeps their codes in a row buffer in shared memory, row R =
8*xi + yi, 4-byte word w at w ^ swz(R). K10: each lane of the line walk
stores the codes of its rows 2*lane and 2*lane + 1 (u16 stores, one
grouped slot a store instruction) and ORs them for the row's width, its
corners going to rem; a thread per (row, slot b of 32 codes) of the block's
own rows reads the slot's four 16-byte quads, undoes the word order inside
each quad, pairs symbols k and k+16, runs the 16x16 butterfly and writes the
first nq = ceil((K+E)/4) plane quads back in place; every block reads the
tile's 1024 widths from the 16 buffers, poisons the tile if one is over 16,
ranks crl (the counting sort of sb_rank) and packs its 64 sorted columns: a
thread per (column, slot b) reads the nq plane quads of slot b of the chunk
inv[column] from its owner's buffer and stores one word per plane. K11 is
the mirror: it reads the base words and the residual words under the crl
guard (garbage above a chunk's width must not leak) and stores them as nq
plane quads into the owners' buffers; each block turns its own slots back
into codes (planes from nq*4 up read as 0), and its line walk loads each
code where K10 stored it. The stencil itself is K1's/K4's register line walk,
which tests/test_torch_hybrid_v2.py emulates; here the plain
local_decompose / local_recompose give the lines' values.

The emulation checks that the swizzle is a bijection of every row, that the
line walk's stores and loads and the quarter warps' 16-byte accesses over
consecutive chunks (local and remote) are free of bank conflicts, that each
block's 64 sorted columns are owned exactly once, that every base and
residual word and every plane quad of every slot is written exactly once,
and holds base, resid, cw, rem and the field back bit for bit against
transform_pack_v3 / unpack_inverse_v3_plain."""

import functools

import numpy as np
import pytest
import torch

from mgard_tpu_torch.ops import hybrid as TH

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

SBC, CLUSTER, ROWS = 1024, 16, 64
Q = 1e-3
_MASKS = {8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333, 1: 0x55555555}


def swz(R):
    """hybrid_v3.cu swz: the word swizzle of row R of a row buffer."""
    return ((R >> 1) ^ (R << 2)) & 31


def _owner(c):
    return (c >> 3) & 15


def _row_in_owner(c):
    return ((c >> 7) << 3) | (c & 7)


def _butterfly16(z):
    """bits.cuh bit_transpose<16> on a list of 16 uint32 arrays, in place."""
    s = 8
    while s:
        for i in range(16):
            if not i & s:
                t = ((z[i] >> np.uint32(s)) ^ z[i + s]) & np.uint32(_MASKS[s])
                z[i] ^= t << np.uint32(s)
                z[i + s] ^= t
        s //= 2


def _lo(x):
    return x & np.uint32(0xFFFF)


def _hi(x):
    return x >> np.uint32(16)


def _quad_perm(x, p):
    """quad_perm on (..., 4) words with p (...,): word e comes from e ^ p."""
    e = np.arange(4)
    return np.take_along_axis(x, e ^ p[..., None], axis=-1)


class Geom:
    def __init__(self, shape):
        self.X, self.Y, self.Z = shape
        self.g, self.C, self.RW = self.Z // 8, self.Z // 32, self.Z // 2
        self.TY = self.Y // 128
        self.NSB = self.X // 8 * self.TY
        self.BY = self.Y // 8
        assert self.RW % 32 == 0  # a row is whole bank cycles of words

    def block(self, s, r):
        """Grid block (row-major over (X/8, Y/8)) of rank r of tile s."""
        return (s // self.TY) * self.BY + 16 * (s % self.TY) + r

    def slots(self):
        """Buffer block, row R and u16 index of every element's code."""
        x, y, z = np.meshgrid(np.arange(self.X), np.arange(self.Y),
                              np.arange(self.Z), indexing="ij")
        blk = (x // 8) * self.BY + y // 8
        R = 8 * (x % 8) + y % 8
        col = (z % 8) * self.g + z // 8
        word = R * self.RW + ((col >> 1) ^ swz(R))
        return blk, 2 * word + (col & 1)

    def rem_index(self, nl):
        """rem_index of every corner, and the corner mask."""
        cols = list(TH._rem_cols(nl))
        k = len(cols)
        rc = np.full(8, -1)
        rc[cols] = np.arange(k)
        x, y, z = np.meshgrid(np.arange(self.X), np.arange(self.Y),
                              np.arange(self.Z), indexing="ij")
        cm = (rc[x % 8] >= 0) & (rc[y % 8] >= 0) & (rc[z % 8] >= 0)
        RY, RZ = self.Y // 8 * k, self.Z // 8 * k
        idx = (((x // 8) * k + rc[x % 8]) * RY + (y // 8) * k
               + rc[y % 8]) * RZ + (z // 8) * k + rc[z % 8]
        return np.where(cm, idx, -1), cm


def _check_walk_banks(G):
    """The line walk's u16 stores (K10) and loads (K11): instruction (s, c,
    jz) of a warp touches rows 2*lane + s at grouped slot c*g + jz; the 32
    lanes must hit 32 distinct banks."""
    lane = np.arange(32)
    col = (np.arange(8)[:, None] * G.g + np.arange(G.g)[None, :])
    for s in (0, 1):
        R = 2 * lane + s
        bank = ((col[..., None] >> 1) ^ swz(R)) % 32  # R * RW is 0 mod 32
        srt = np.sort(bank, axis=-1)
        assert (np.diff(srt, axis=-1) > 0).all()


def _check_quad_banks(own, qd, chunks):
    """16-byte accesses (quad index qd, owner own, chunk of each lane;
    (..., 32) lanes a warp): in a quarter warp whose 8 chunks are
    consecutive, lanes at one owner hit distinct quad banks (qd mod 8; a
    row is whole bank cycles of quads)."""
    own, qd, ch = (a.reshape(-1, 4, 8) for a in (own, qd, chunks))
    consec = (np.diff(ch, axis=-1) == 1).all(-1)
    key = own * 8 + qd % 8
    srt = np.sort(key, axis=-1)
    distinct = (np.diff(srt, axis=-1) > 0).all(-1)
    assert distinct[consec].all()


def _sb_rank(crl, E):
    """sb_rank on (NSB, 1024) crl: per bucket and group of 32 the count,
    its exclusive prefix over groups, then the rank of each chunk."""
    NSB = crl.shape[0]
    grp = crl.reshape(NSB, 32, 32)
    rank = np.zeros_like(grp)
    wtot = np.stack([(grp == k).sum(-1) for k in range(E + 1)], 1)
    excl = np.cumsum(wtot, -1) - wtot  # (NSB, E+1, 32 groups)
    tot = wtot.sum(-1)  # (NSB, E+1)
    above = np.cumsum(tot[:, ::-1], 1)[:, ::-1] - tot  # sum over k > r
    for k in range(E + 1):
        same = grp == k
        before = np.cumsum(same, -1) - same  # lanes before, same bucket
        val = excl[:, k, :, None] + before + above[:, k, None, None]
        rank = np.where(same, val, rank)
    return rank.reshape(NSB, SBC)


def _inv(rank):
    """inv[s, r, i]: the chunk at sorted column 64r + i, each set once."""
    NSB = rank.shape[0]
    inv = np.full((NSB, CLUSTER, ROWS), -1)
    hits = np.zeros((NSB, SBC), int)
    s = np.repeat(np.arange(NSB), SBC)
    cs = rank.reshape(-1)
    inv[s, cs >> 6, cs & 63] = np.tile(np.arange(SBC), NSB)
    np.add.at(hits, (s, cs), 1)
    assert (hits == 1).all()
    return inv


def _threads(G, inv):
    """(s, r, task, lane) of every pack/unpack thread: its slot b, sorted
    column cs, chunk c, the owner's grid block, the row there and the
    row's swizzle."""
    s, r, task, lane = np.meshgrid(np.arange(G.NSB), np.arange(CLUSTER),
                                   np.arange(2 * G.C), np.arange(32),
                                   indexing="ij")
    b, col = task >> 1, ((task & 1) << 5) | lane
    c = inv[s, r, col]
    cs = (r << 6) | col
    assert (cs.reshape(-1, 32) == cs.reshape(-1, 32)[:, :1]
            + np.arange(32)).all() and (cs[..., 0] % 32 == 0).all()
    R = _row_in_owner(c)
    return s, b, cs, c, G.block(s, _owner(c)), R, swz(R)


@functools.lru_cache(maxsize=None)
def _field(shape, poison=False):
    rng = np.random.default_rng(sum(shape) + 7)
    X, Y, Z = shape
    x = np.linspace(0, 1, X, dtype=np.float32)[:, None, None]
    z = np.linspace(0, 1, Z, dtype=np.float32)[None, None, :]
    amp = (10.0 ** rng.uniform(-3.5, 0.3, (X, Y, 1))).astype(np.float32)
    v = (np.sin(2 * np.pi * x) * np.cos(3 * z)
         + amp * rng.standard_normal(shape).astype(np.float32))
    v = v.astype(np.float32)
    if poison:  # tile (gx, gy) = (1, 1): superblock 3 of 4
        v[9, 130, 77] = np.float32(1e3)
    return v


def _slot_quads(R, b):
    """quad_at: the four quads of slot b of row R, in the row's quads."""
    return [(4 * b + i) ^ (swz(R) >> 2) for i in range(4)]


def _pair(w):
    """16 words (symbols 2m | 2m+1 << 16; words 8-15: symbols 16-31) ->
    z[q] = symbol q | symbol q+16 << 16, as __byte_perm pairs them."""
    sh = np.uint32(16)
    return [(_lo(w[..., q >> 1]) | (_lo(w[..., 8 + (q >> 1)]) << sh))
            if q % 2 == 0 else
            (_hi(w[..., q >> 1]) | (_hi(w[..., 8 + (q >> 1)]) << sh))
            for q in range(16)]


def _unpair(z):
    sh = np.uint32(16)
    w = [_lo(z[2 * i]) | (_lo(z[2 * i + 1]) << sh) for i in range(8)]
    w += [_hi(z[2 * i]) | (_hi(z[2 * i + 1]) << sh) for i in range(8)]
    return np.stack(w, -1)


def _local_slots(G):
    """A thread per (row, slot) of each block's own buffer, t = row + 64 *
    slot: (block, R, b) arrays of shape (blocks, 64 * C), and the local
    16-byte accesses checked (a quarter warp: 8 rows of one xi, i.e. 8
    consecutive chunks)."""
    NBLK = G.X // 8 * G.BY
    t = np.arange(ROWS * G.C)
    blk = np.repeat(np.arange(NBLK)[:, None], t.size, 1)
    R, b = np.broadcast_to(t & 63, blk.shape), np.broadcast_to(t >> 6,
                                                               blk.shape)
    for qd in _slot_quads(R, b):
        _check_quad_banks(blk, qd, R)
    return blk, R, b


def codes_to_planes(rows, G, nq):
    """K10 step 2 in every block: slot codes -> nq plane quads, in place."""
    blk, R, b = _local_slots(G)
    qds, sw = _slot_quads(R, b), swz(R)
    w = np.concatenate([_quad_perm(rows[blk, R, qd], sw & 3) for qd in qds],
                       -1)
    z = _pair(w)
    _butterfly16(z)
    z = np.stack(z, -1)
    for i in range(nq):
        rows[blk, R, qds[i]] = _quad_perm(z[..., 4 * i:4 * i + 4], sw & 3)


def planes_to_codes(rows, G, nq):
    """K11 step 3: nq plane quads (planes above read as 0) -> codes."""
    blk, R, b = _local_slots(G)
    qds, sw = _slot_quads(R, b), swz(R)
    z = np.zeros(blk.shape + (16,), np.uint32)
    for i in range(nq):
        z[..., 4 * i:4 * i + 4] = _quad_perm(rows[blk, R, qds[i]], sw & 3)
    z = [z[..., p] for p in range(16)]
    _butterfly16(z)
    w = _unpair(z)
    for i in range(4):
        rows[blk, R, qds[i]] = _quad_perm(w[..., 4 * i:4 * i + 4], sw & 3)


def emulate_pack(v, inv_q, nl, K, E):
    """K10, thread by thread: (base, resid, cw, rem) as the kernel writes
    them, int32/float32 arrays of the wrapper's shapes."""
    G = Geom(v.shape)
    nq = (K + E + 3) // 4
    dec = TH.local_decompose(torch.from_numpy(v), nl).numpy()
    ridx, cm = G.rem_index(nl)
    k = len(TH._rem_cols(nl))
    rem = np.zeros((G.X // 8 * k) * (G.Y // 8 * k) * (G.Z // 8 * k),
                   np.float32)
    rhits = np.bincount(ridx[cm], minlength=rem.size)
    assert (rhits == 1).all()  # every remainder value stored once
    rem[ridx[cm]] = dec[cm]
    # quantize_zigzag, a corner's code 0
    t = (dec * np.float32(inv_q)).astype(np.float32)
    h = np.where(t < 0, t - np.float32(0.5), t + np.float32(0.5))
    sym = np.where(cm, 0, np.trunc(h)).astype(np.int32)
    zz = ((sym << 1) ^ (sym >> 31)).view(np.uint32)
    # 1. the line walk's stores into the row buffers
    _check_walk_banks(G)
    NBLK = G.X // 8 * G.BY
    blk, u16 = G.slots()
    hits = np.zeros((NBLK, ROWS * G.RW * 2), int)
    np.add.at(hits, (blk, u16), 1)
    assert (hits == 1).all()  # the swizzle is a bijection of every row
    rows = np.zeros((NBLK, ROWS * G.RW * 2), np.uint16)
    rows[blk, u16] = zz & 0xFFFF
    rows = rows.view(np.uint32).reshape(NBLK, ROWS, G.Z // 8, 4)
    # widths: each lane ORs its rows' codes; bit length of the OR
    orr = np.bitwise_or.reduce(zz, axis=2).reshape(G.X // 8, 8, G.BY, 8)
    wor = orr.transpose(0, 2, 1, 3).reshape(NBLK, ROWS)
    wid = np.frexp(wor.astype(np.float64))[1]
    # 2. each block's slots to planes, in place
    codes_to_planes(rows, G, nq)
    # 3. every block reads the tile's 1024 widths from their owners
    c = np.arange(SBC)
    s = np.arange(G.NSB)[:, None]
    w = wid[G.block(s, _owner(c)), _row_in_owner(c)]
    over = (w > 16).any(1, keepdims=True)
    cw = np.where(over, 32, w)
    crl = np.clip(cw - K, 0, E)
    inv = _inv(_sb_rank(crl, E))
    # 4. pack: nq plane quads from the owner's buffer
    s, b, cs, c, ob, R, sw = _threads(G, inv)
    z = np.zeros(ob.shape + (16,), np.uint32)
    for i, qd in enumerate(_slot_quads(R, b)[:nq]):
        _check_quad_banks(ob, qd, c)
        z[..., 4 * i:4 * i + 4] = _quad_perm(rows[ob, R, qd], sw & 3)
    plane = G.C * SBC
    base = np.zeros(G.NSB * K * plane, np.uint32)
    resid = np.zeros(G.NSB * E * plane, np.uint32)
    nb, nr = np.zeros(base.size, int), np.zeros(resid.size, int)
    at = b * SBC + cs
    for p in range(K + E):
        if p < K:
            idx = (s * K * plane + p * plane + at).ravel()
            base[idx] = z[..., p].ravel()
            np.add.at(nb, idx, 1)
        else:
            idx = (s * E * plane + (p - K) * plane + at).ravel()
            resid[idx] = z[..., p].ravel()
            np.add.at(nr, idx, 1)
    assert (nb == 1).all() and (nr == 1).all()  # each word exactly once
    return (base.view(np.int32).reshape(G.NSB, K, G.C, SBC),
            resid.view(np.int32).reshape(-1, 128),
            cw.astype(np.int32), rem.reshape(TH.remainder_shape(v.shape, nl)))


def emulate_unpack(base, crl, resid, rem, q, nl, K, E, shape):
    """K11, thread by thread: the float32 field."""
    G = Geom(shape)
    nq = (K + E + 3) // 4
    inv = _inv(_sb_rank(crl, E))
    # 2. unpack: each (column, slot)'s plane words, the residual ones under
    # the crl guard, to nq plane quads in the owner's buffer
    s, b, cs, c, ob, R, sw = _threads(G, inv)
    cr = crl[s, c]
    plane = G.C * SBC
    bf = base.reshape(-1).view(np.uint32)
    rf = resid.reshape(-1).view(np.uint32)
    at = b * SBC + cs
    z = np.zeros(at.shape + (16,), np.uint32)
    for p in range(K + E):
        if p < K:
            z[..., p] = bf[s * K * plane + p * plane + at]
        else:
            ok = cr > p - K  # the crl guard
            z[..., p][ok] = rf[(s * E * plane + (p - K) * plane + at)[ok]]
    NBLK = G.X // 8 * G.BY
    rows = np.zeros((NBLK, ROWS, G.Z // 8, 4), np.uint32)
    hits = np.zeros(rows.shape[:3], int)
    for i, qd in enumerate(_slot_quads(R, b)[:nq]):
        _check_quad_banks(ob, qd, c)
        rows[ob, R, qd] = _quad_perm(z[..., 4 * i:4 * i + 4], sw & 3)
        np.add.at(hits, (ob, R, qd), 1)
    # every slot (an aligned group of 4 quads) gets its nq plane quads,
    # each stored once
    assert hits.max() <= 1
    assert (hits.reshape(NBLK, ROWS, G.C, 4).sum(-1) == nq).all()
    # 3. each block's slots back to codes; 4. the line walk loads each code
    # where K10 stored it
    planes_to_codes(rows, G, nq)
    _check_walk_banks(G)
    blk, u16 = G.slots()
    code = rows.reshape(NBLK, -1).view(np.uint16)[blk, u16].astype(np.uint32)
    sym = ((code >> 1) ^ (-(code & 1).astype(np.int64)).astype(np.uint32)
           ).view(np.int32)
    val = (sym.astype(np.float32) * np.float32(q)).astype(np.float32)
    ridx, cm = G.rem_index(nl)
    val[cm] = rem.reshape(-1)[ridx[cm]]
    return TH.local_recompose(torch.from_numpy(val), nl).numpy()


def _garbage_above_width(resid, crl, K, E, shape, seed):
    """resid with random words wherever a sorted column's chunk has crl <=
    the plane's index (zeros there in a stream K10 wrote)."""
    G = Geom(shape)
    inv = _inv(_sb_rank(crl, E))
    sorted_crl = np.take_along_axis(crl, inv.reshape(G.NSB, SBC), 1)
    out = resid.reshape(G.NSB, E, G.C, SBC).copy()
    dead = sorted_crl[:, None, None, :] <= np.arange(E)[None, :, None, None]
    dead = np.broadcast_to(dead, out.shape)
    rng = np.random.default_rng(seed)
    out[dead] = rng.integers(-2**31, 2**31, int(dead.sum()), dtype=np.int64)
    return out.reshape(resid.shape), int(dead.sum())


def _check(v, nl, K, E, poisoned=()):
    inv_q = float(np.float32(1.0) / np.float32(Q))
    q = float(np.float32(Q))
    got = emulate_pack(v, inv_q, nl, K, E)
    ref = TH.transform_pack_v3(torch.from_numpy(v), inv_q, nl, K, E)
    for name, a, b in zip(("base", "resid", "cw", "rem"), got, ref):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    cw = got[2]
    for s in range(cw.shape[0]):
        assert (cw[s] == 32).all() if s in poisoned else cw[s].max() <= 16
    crl = np.clip(cw - K, 0, E).astype(np.int32)
    resid_g, n_dead = _garbage_above_width(got[1], crl, K, E, v.shape,
                                           nl + K)
    if not poisoned:
        assert n_dead > 0
    out = emulate_unpack(got[0], crl, resid_g, got[3], q, nl, K, E, v.shape)
    args = (torch.from_numpy(got[0]), torch.from_numpy(crl))
    tail = (torch.from_numpy(got[3]), q, nl, K, E, v.shape)
    want = TH.unpack_inverse_v3_plain(*args, torch.from_numpy(got[1]), *tail)
    with_g = TH.unpack_inverse_v3_plain(*args, torch.from_numpy(resid_g),
                                        *tail)
    np.testing.assert_array_equal(out.view(np.int32),
                                  want.numpy().view(np.int32))
    np.testing.assert_array_equal(with_g.numpy(), want.numpy())


@pytest.mark.parametrize("K,E", [(1, 15), (8, 8), (3, 8)])
@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("shape", [(8, 128, 128), (16, 256, 256),
                                   (8, 128, 1024)])
def test_cluster_schedule_matches_plain(shape, nl, K, E):
    _check(_field(shape), nl, K, E)


@pytest.mark.parametrize("nl", [1, 3])
def test_cluster_schedule_poisons_one_tile(nl):
    """One value over the u16 budget: its tile's widths are all 32 and its
    codes' low 16 bits are packed; the other tiles are untouched."""
    _check(_field((16, 256, 256), poison=True), nl, 8, 8, poisoned=(3,))


def test_swizzle_serves_every_access_pattern():
    """The row-buffer swizzle alone: a bijection of each row's 32-word
    groups; 32 distinct banks for the walk's rows 2*lane + s; and for any 8
    consecutive chunks of a tile, distinct quad banks among those at one
    owner, for every slot and quad."""
    R = np.arange(ROWS)
    for r in R:
        assert sorted(np.arange(32) ^ swz(r)) == list(range(32))
    for s in (0, 1):
        assert len({swz(2 * ln + s) for ln in range(32)}) == 32
    c0 = np.arange(SBC - 7)[:, None] + np.arange(8)[None, :]
    own, Rc = _owner(c0), _row_in_owner(c0)
    for b in range(32):
        for i in range(4):
            key = own * 8 + ((4 * b + i) ^ (swz(Rc) >> 2)) % 8
            assert (np.diff(np.sort(key, -1), axis=-1) > 0).all()
