"""PyTorch port, K2/K3 thread schedule: a NumPy emulation of what each
thread of csrc/bfp.cu computes (no JAX, no card).

A thread owns one block (superblock s, sorted column cs, slot b), with
warps walking b fastest; it reads the chunk inv[s, cs] (the inverse of
rank) through its warp's shared staging area (whole blocks a load
instruction), transposes the block's bits with the register butterfly
(16x16 on paired u16 halves, or 32x32) and stores one word per plane, the
warp's 32 words forming one 128-byte row; K3 loads those rows (a residual
word at cs >= cnt reads as 0), runs the same butterfly and stores the
symbols into chunk row inv[cs] through the staging area. The emulation
follows that schedule step for step, checks that the staging slots are a
bank-conflict-free bijection, that each output word is written at most
once, that a residual band row is stored or skipped by a whole warp, and
which words are covered, and holds the result bit for bit against
encode_bands_plain / decode_bands_plain on every edge case of
bfp.BAND_CASES."""

import numpy as np
import pytest
import torch

from mgard_tpu_torch.lossless import bfp as T

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

_MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
          1: 0x55555555}


def _byte_perm(x, y, sel: int):
    """CUDA __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4i) & 7 of the eight bytes y:x."""
    xy = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(x.shape, np.uint32)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (xy >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def _butterfly(z):
    """bits.cuh bit_transpose<N> on a list of N uint32 arrays, in place."""
    s = len(z) // 2
    while s:
        for i in range(len(z)):
            if not i & s:
                t = ((z[i] >> np.uint32(s)) ^ z[i + s]) & np.uint32(_MASKS[s])
                z[i] ^= t << np.uint32(s)
                z[i + s] ^= t
        s //= 2


def _owners(NB, C, sbc, rank):
    """The (s, cs, b, c) of every thread, and inv from rank as the first
    kernel makes it."""
    NSB = rank.shape[0]
    inv = np.empty_like(rank)
    inv[np.arange(NSB)[:, None], rank] = np.arange(sbc)
    t = np.arange(NB)
    w = t >> 5
    q = w // C
    tiles = sbc >> 5
    s = q // tiles
    cs = (q - s * tiles) * 32 + (t & 31)
    return s, cs, w - q * C, np.minimum(inv[s, cs], sbc - 1)


def _slot(q, lane, N):
    """csrc/bfp.cu slot<N>: quad q of lane's block in the warp's staging
    area (16-byte units)."""
    return q * 32 + (lane ^ (q * (32 // N)))


def _block_pass(i, N):
    """Instruction i of the block pass of load_words/store_words: each lane's
    source lane (whose block it moves) and quad, and their slots, which must
    hit 8 distinct 16-byte bank groups per quarter-warp."""
    QB = N // 4
    lane = np.arange(32)
    src, q = i * (32 // QB) + lane // QB, lane % QB
    sl = _slot(q, src, N)
    assert all(len(set(g)) == 8 for g in (sl % 8).reshape(4, 8))
    return src, q, sl


def _own_slots(q, N):
    sl = _slot(q, np.arange(32), N)
    assert all(len(set(g)) == 8 for g in (sl % 8).reshape(4, 8))
    return sl


def _staged_load(quads, row, b, c, N):
    """load_words: quads (NC, C, N/4, 4) uint32, the warps' row base
    s*sbc (W,), slot b (W,) and chunks c (W, 32) -> (W, 32, N) words of
    each lane's block."""
    QB = N // 4
    st = np.zeros((len(b), QB * 32, 4), np.uint32)
    hit = np.zeros(QB * 32, int)
    for i in range(QB):
        src, q, sl = _block_pass(i, N)
        st[:, sl] = quads[row[:, None] + c[:, src], b[:, None], q[None, :]]
        np.add.at(hit, sl, 1)
    assert (hit == 1).all()  # a bijection of the 32 blocks' quads
    return np.concatenate([st[:, _own_slots(q, N)] for q in range(QB)],
                          axis=2)


def _staged_store(out, row, b, c, words, N):
    """store_words, the mirror: words (W, 32, N) into out (NC, C, N/4, 4).
    Returns how often each quad of out was stored."""
    QB = N // 4
    st = np.zeros((len(b), QB * 32, 4), np.uint32)
    for q in range(QB):
        st[:, _own_slots(q, N)] = words[:, :, 4 * q: 4 * q + 4]
    hits = np.zeros(out.shape[:3], int)
    for i in range(QB):
        src, q, sl = _block_pass(i, N)
        at = (row[:, None] + c[:, src], b[:, None], q[None, :])
        out[at] = st[:, sl]
        np.add.at(hits, at, 1)
    return hits


def _warp_uniform(mask):
    m = mask.reshape(-1, 32)
    assert (m == m[:, :1]).all(), "a band row is split inside a warp"


def _emulate_encode(rows, rank, woff, rband, sb_off, K, E, sb, C,
                    alloc_rows):
    NC, W = rows.shape
    sbc = sb // C
    NSB, NB = NC // sbc, NC * C
    s, cs, b, c = _owners(NB, C, sbc, rank)
    N = 16 if rows.dtype == np.int16 else 32
    quads = np.ascontiguousarray(rows).view(np.uint32).reshape(
        NC, C, N // 4, 4)
    w = _staged_load(quads, s[::32] * sbc, b[::32], c.reshape(-1, 32),
                     N).reshape(NB, N)
    if N == 16:
        z = [_byte_perm(w[:, k >> 1], w[:, 8 + (k >> 1)],
                        0x7632 if k & 1 else 0x5410) for k in range(16)]
    else:
        z = [w[:, k].copy() for k in range(32)]
    _butterfly(z)
    Kp = max(K, 1)
    base = np.zeros(NSB * Kp * C * sbc, np.uint32)
    resid = np.zeros(alloc_rows * 128, np.uint32)
    nb, nr = np.zeros(base.size, int), np.zeros(resid.size, int)
    for j in range(K + E):
        word = z[j] if j < len(z) else np.zeros(NB, np.uint32)
        if j < K:
            idx = ((s * Kp + j) * C + b) * sbc + cs
            base[idx] = word
            np.add.at(nb, idx, 1)
            continue
        p = j - K
        rb = rband[s, p]
        ok = cs < rb * 128
        _warp_uniform(ok)
        idx = ((sb_off[s] + woff[s, p] + b * rb) * 128 + cs)[ok]
        resid[idx] = word[ok]
        np.add.at(nr, idx, 1)
    assert nb.max(initial=0) <= 1 and nr.max(initial=0) <= 1
    return (base.view(np.int32).reshape(NSB, Kp, C, sbc),
            resid.view(np.int32).reshape(alloc_rows, 128), nb, nr)


def _emulate_decode(base, resid2d, rank, woff, rband, sb_off, cnt, K, E, sb,
                    C, wide):
    NSB = base.shape[0]
    sbc = sb // C
    NB = NSB * sb
    s, cs, b, c = _owners(NB, C, sbc, rank)
    Kp = max(K, 1)
    bflat = base.reshape(-1).view(np.uint32)
    rflat = resid2d.reshape(-1).view(np.uint32)
    z = []
    for j in range(32 if wide else 16):
        word = np.zeros(NB, np.uint32)
        if j < K:
            word = bflat[((s * Kp + j) * C + b) * sbc + cs]
        elif j < K + E:
            p = j - K
            ok = cs < cnt[s, p]
            idx = (sb_off[s] + woff[s, p] + b * rband[s, p]) * 128 + cs
            word[ok] = rflat[idx[ok]]
        z.append(word)
    _butterfly(z)
    N = len(z)
    if wide:
        w = z
    else:
        w = [_byte_perm(z[2 * i], z[2 * i + 1], 0x5410) for i in range(8)]
        w += [_byte_perm(z[2 * i], z[2 * i + 1], 0x7632) for i in range(8)]
    out = np.zeros((NSB * sbc, C, N // 4, 4), np.uint32)
    hits = _staged_store(out, s[::32] * sbc, b[::32], c.reshape(-1, 32),
                         np.stack(w, 1).reshape(-1, 32, N), N)
    assert (hits == 1).all(), "every block is stored exactly once"
    return out.view(np.int32 if wide else np.int16).reshape(NSB * sbc, -1)


@pytest.mark.parametrize("spec", T.BAND_CASES, ids=[c[0] for c in
                                                    T.BAND_CASES])
def test_thread_schedule_matches_plain(spec):
    args, cnt, resid_rows = T.band_case(spec)
    rows, rank, woff, rband, sb_off, K, E, sb, C, alloc_rows = args
    static = spec[-1]
    npy = [a.numpy() for a in (rows, rank, woff, rband, sb_off)]
    base, resid, nb, nr = _emulate_encode(*npy, K, E, sb, C, alloc_rows)
    pb, pr = T.encode_bands_plain(*args)
    np.testing.assert_array_equal(base, pb.numpy())
    np.testing.assert_array_equal(resid, pr.numpy())
    # coverage: every base word when K > 0 (the wrapper leaves base
    # uninitialised then), and exactly the plan's band rows of resid
    assert (nb == 1).all() if K else not nb.any()
    written = nr.reshape(alloc_rows, 128)
    assert written[:resid_rows].all() and not written[resid_rows:].any()
    if static:
        assert resid_rows == alloc_rows
    wide = rows.dtype == torch.int32
    out = _emulate_decode(base, resid, npy[1], npy[2], npy[3], npy[4],
                          cnt.numpy(), K, E, sb, C, wide)
    plain = T.decode_bands_plain(pb, pr, rank, woff, rband, sb_off, cnt, K,
                                 E, sb, C, wide)
    np.testing.assert_array_equal(out, plain.numpy())
    np.testing.assert_array_equal(out, npy[0])
