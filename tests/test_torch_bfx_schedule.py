"""PyTorch port, K5/K6 schedule: a NumPy emulation of what each CTA and
thread of csrc/bfx.cu computes (no JAX, no card).

A CTA owns P = min(sb, PB) blocks of one superblock, the range [r*P,
(r+1)*P) of its emission order: slot m holds natural block C*brev(m) +
brev(r), its quads swizzled. K5 (a cluster of C CTAs a superblock) loads
the slots, ORs each block's zigzag codes into its width, scans the widths,
exchanges the CTA totals and the width bytes across the cluster, takes the
superblock offset from the decoupled look-back, stages each block's plane
words in place of the slots already read and stores its run (16-byte
stores inside, scalars at the ends) and, in the last CTA, the alignment
gap. K6 (a CTA per range, no cluster) reads the superblock's widths, takes
the offset by the same look-back, loads exactly its run, un-transposes the
blocks into their slots walking downwards and stores whole lines.

The emulation follows that schedule step for step and holds it word for
word against encode_core_plain / decode_core_plain. It checks that every
output word below the total is written exactly once and nothing past it
is read or written, that no staged or loaded word is overwritten before it
is read, and, in a scheduler with random start orders and few resident
units, that the look-back finishes and every unit waits only on units
with an earlier ticket (taking the superblock from blockIdx instead
deadlocks)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mgard_tpu_torch.lossless import bfx as T

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

_SRC = (Path(T.__file__).resolve().parent.parent / "csrc"
        / "bfx.cu").read_text()
NT = int(re.search(r"constexpr int NT = (\d+);", _SRC).group(1))
LOG_PB = int(re.search(r"constexpr int LOG_PB = (\d+)", _SRC).group(1))
MAX_C = int(re.search(r"constexpr int MAX_C = (\d+);", _SRC).group(1))
LANES = 32  # status words a look-back step reads (one warp)
AGG, INCL = 1, 2

_MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
          1: 0x55555555}


def _brev(k, bits):
    k = np.asarray(k, np.int64)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _geometry(sb, log_pb):
    """(P, logP, logC) of bfx.cu geometry()."""
    bits = sb.bit_length() - 1
    logP = min(bits, log_pb)
    return 1 << logP, logP, bits - logP


def _quads(m):
    """Word indices (len(m), 8, 4) of slot m's quads in the CTA buffer:
    bfx.cu quad_at (4 leading words, quads swizzled by m & 7)."""
    m = np.asarray(m, np.int64)[:, None]
    q = np.arange(8)[None, :]
    return (4 + 32 * m + 4 * (q ^ (m & 7)))[:, :, None] + np.arange(4)


def _zigzag(x):
    x = np.asarray(x).astype(np.int32)
    return (x.astype(np.uint32) << np.uint32(1)) ^ (x >> 31).astype(
        np.uint32)


def _butterfly(z):
    """bits.cuh bit_transpose<32> on z (32, n) uint32, in place."""
    s = 16
    while s:
        for i in range(32):
            if not i & s:
                t = ((z[i] >> np.uint32(s)) ^ z[i + s]) & np.uint32(
                    _MASKS[s])
                z[i] ^= t << np.uint32(s)
                z[i + s] ^= t
        s //= 2


def _aligned(L, align):
    return (L + align - 1) // align * align


def _rand_syms(n, scale, seed=0):
    """tests/test_torch_bfx.py's symbols: near zero, large outliers."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal(n) * scale).astype(np.int32)
    k = max(1, n // 1000)
    idx = rng.integers(0, n, k)
    s[idx] = rng.integers(-(2**30), 2**30, k).astype(np.int32)
    return s


def _symbols(kind, n, seed, sb=1):
    if kind == "zero":
        return np.zeros(n, np.int32)
    if kind == "wide":  # every block 32 bits wide, the whole int32 range
        rng = np.random.default_rng(seed)
        s = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        s[::32] = -2**31
        return s
    if kind == "wide_after_odd":  # 32-bit superblocks at odd offsets
        s = _symbols("wide", n, seed)
        s[:sb * 32] = 0
        s[0] = -1  # the first superblock holds one word
        return s
    return _rand_syms(n, 300, seed)


# ----------------------------------------------------------------------
# The look-back under a scheduler
# ----------------------------------------------------------------------
def lookback_schedule(A, C, resident, rng, by_ticket=True):
    """Run the tickets and the look-back of NSB*C units (K5: C = 1, a
    cluster a superblock; K6: C CTAs a superblock, the range-0 CTA
    publishing) with at most `resident` units on the card, started in a
    random order, stepped in a random order. Returns (E (NSB*C,) the
    offset each unit found, the (waiter, waited-on) ticket pairs), or None
    on a deadlock. by_ticket=False takes the unit's index from blockIdx."""
    NSB = len(A)
    status = np.zeros((NSB, 2), np.int64)  # flag, value
    pending = list(rng.permutation(NSB * C))  # blockIdx in launch order
    running, E, waits, ticket = [], {}, [], 0

    def step(u):
        """One step of unit u (a dict); False when it waits."""
        if u["phase"] == "agg":
            s = u["s"]
            if u["r"] == 0:
                status[s] = (INCL if s == 0 else AGG, A[s])
            u.update(phase="look", top=s - 1, excl=0)
            return True
        top = u["top"]
        if top >= 0:
            lanes = np.arange(top, max(top - LANES, -1), -1)
            flags = status[lanes, 0]
            if (flags == 0).any():
                waits.extend((u["t"], int(x) * C) for x in lanes[flags == 0])
                return False
            hit = np.flatnonzero(flags == INCL)
            stop = hit[0] if hit.size else len(lanes) - 1
            u["excl"] += int(status[lanes[:stop + 1], 1].sum())
            u["top"] = -1 if hit.size else top - LANES
            if u["top"] >= 0:
                return True
        s = u["s"]
        if u["r"] == 0 and s > 0:
            status[s] = (INCL, u["excl"] + A[s])
        E[u["t"]] = u["excl"]
        running.remove(u)
        return True

    while pending or running:
        moved = False
        if pending and len(running) < resident and rng.random() < 0.5:
            b = int(pending.pop())
            t = ticket if by_ticket else b
            ticket += 1
            running.append(dict(t=t, s=t // C, r=t % C, phase="agg"))
            moved = True
        for u in [running[i] for i in rng.permutation(len(running))]:
            if step(u):
                moved = True
                break
        if not moved and not (pending and len(running) < resident):
            return None
    return np.array([E[t] for t in range(NSB * C)]), waits


# ----------------------------------------------------------------------
# K5 and K6, CTA by CTA
# ----------------------------------------------------------------------
def _store_run(out, count, g0, n, buf):
    """bfx.cu store_run: out[g0, g0+n) from buf[a, a+n), a = g0 & 3 (zeros
    when buf is None); whole quads as 16-byte stores, partial ones word by
    word. Returns the number of partial quads."""
    if n <= 0:
        return 0
    q0, q1 = g0 >> 2, (g0 + n - 1) >> 2
    q = np.arange(q0, q1 + 1)
    full = (4 * q >= g0) & (4 * q + 4 <= g0 + n)
    g = np.arange(g0, g0 + n)
    si = g - 4 * q0
    assert si[0] == (g0 & 3)
    out[g] = 0 if buf is None else buf[si]
    count[g] += 1
    return int((~full).sum())


def emulate_encode(sym, sb, align, log_pb, rng, resident=3):
    """K5 on int32 symbols: (out words (cap,), write counts (cap,), widths
    (NB,), width write counts, offs (NSB+1,), the look-back waits)."""
    NB = sym.size // 32
    NSB = NB // sb
    P, logP, logC = _geometry(sb, log_pb)
    C = 1 << logC
    cap = T._out_words(NSB, sb, align)
    out = np.full(cap, 0xDEADBEEF, np.uint32)
    count = np.zeros(cap, np.int64)
    widths = np.zeros(NB, np.uint8)
    wcount = np.zeros(NB, np.int64)
    sym_lines = sym.view(np.uint32).reshape(NB, 8, 4)
    m = np.arange(P)
    qidx = _quads(m)
    owner = np.full(4 + 32 * P, -1)  # the slot whose quad holds a word
    owner[qidx.reshape(P, 32)] = m[:, None]
    ctas = {}
    for s in range(NSB):  # load, widths, CTA scan
        for r in range(C):
            b = s * sb + (_brev(m, logP) << logC) + _brev(r, logC)
            buf = np.zeros(4 + 32 * P, np.uint32)
            buf[qidx] = sym_lines[b]
            codes = _zigzag(buf[qidx].reshape(P, 32).view(np.int32))
            o = np.bitwise_or.reduce(codes, axis=1)
            w = np.array([int(x).bit_length() for x in o], np.int64)
            off = np.concatenate([[0], np.cumsum(w)[:-1]])
            ctas[s, r] = dict(buf=buf, w=w, off=off, T=int(w.sum()))
    A = np.zeros(NSB, np.int64)
    for s in range(NSB):  # the cluster exchange over shared memory
        tots = [ctas[s, r]["T"] for r in range(C)]
        L = sum(tots)
        A[s] = _aligned(L, align)
        for r in range(C):
            ctas[s, r].update(base=sum(tots[:r]), L=L)
            x = np.arange(P)
            i = r * P + x  # natural width bytes of the superblock, one run
            src_r = _brev(i & (C - 1), logC)
            src_m = _brev(i >> logC, logP)
            widths[s * sb + i] = [ctas[s, int(a)]["w"][int(c)]
                                  for a, c in zip(src_r, src_m)]
            wcount[s * sb + i] += 1
    found = lookback_schedule(A, 1, resident, rng)
    assert found is not None, "look-back deadlocked"
    E, waits = found
    for (s, r), c in ctas.items():
        g0 = int(E[s]) + c["base"]
        a = g0 & 3
        if align % 4 == 0:  # the stage is filled before the look-back
            assert (c["base"] & 3) == a
        buf, w, off = c["buf"], c["w"], c["off"]
        read = np.zeros(P, bool)
        staged = np.zeros(buf.size, np.int64)
        for m0 in range(0, P, NT):  # butterfly rounds
            ms = np.arange(m0, min(m0 + NT, P))
            z = _zigzag(buf[qidx[ms]].reshape(-1, 32).view(np.int32)).T
            z = np.ascontiguousarray(z)
            _butterfly(z)
            read[ms] = True  # every slot of the round, before the barrier
            for k, mm in enumerate(ms):
                pos = a + off[mm] + np.arange(w[mm])
                slot = owner[pos]
                assert read[slot[slot >= 0]].all(), "staged over an unread slot"
                staged[pos] += 1
                buf[pos] = z[:w[mm], k]
        assert (staged[a:a + c["T"]] == 1).all() and staged.sum() == c["T"]
        assert _store_run(out, count, g0, c["T"], buf) <= 2
        if r == C - 1:  # the alignment gap
            _store_run(out, count, int(E[s]) + c["L"], int(A[s]) - c["L"],
                       None)
    offs = np.concatenate([[0], np.cumsum(A)])
    return out, count, widths, wcount, offs, waits


def emulate_decode(words, widths, sb, align, log_pb, rng, resident=5):
    """K6 on the stream's words (total,) uint32 and widths: (symbols (NB*32,)
    int32, symbol write counts, word read counts (total,), the look-back
    waits)."""
    NB = widths.size
    NSB = NB // sb
    P, logP, logC = _geometry(sb, log_pb)
    C = 1 << logC
    total = words.size
    reads = np.zeros(total, np.int64)
    sym = np.full(NB * 32, 0x7EADBEEF, np.int32)
    scount = np.zeros(NB * 32, np.int64)
    m = np.arange(P)
    qidx = _quads(m)
    ctas, A = {}, np.zeros(NSB, np.int64)
    for s in range(NSB):
        wsb = widths[s * sb:(s + 1) * sb].astype(np.int64)
        sums = np.bincount(np.arange(sb) & (C - 1), wsb, minlength=C)
        L = int(sums.sum())
        A[s] = _aligned(L, align)
        for r in range(C):
            rr = int(_brev(r, logC))
            w = np.zeros(P, np.int64)
            i = np.flatnonzero((np.arange(sb) & (C - 1)) == rr)
            w[_brev(i >> logC, logP)] = wsb[i]
            base = int(sum(sums[int(_brev(q, logC))] for q in range(r)))
            off = np.concatenate([[0], np.cumsum(w)[:-1]])
            assert int(w.sum()) == sums[rr]
            ctas[s, r] = dict(w=w, off=off, T=int(w.sum()), base=base)
    found = lookback_schedule(A, C, resident, rng)
    assert found is not None, "look-back deadlocked"
    E, waits = found
    for (s, r), c in ctas.items():
        g0 = int(E[s * C + r]) + c["base"]
        a, n, w, off = g0 & 3, c["T"], c["w"], c["off"]
        buf = np.full(4 + 32 * P, 0xFFFFFFFF, np.uint32)
        if n:  # load_run: nothing outside [g0, g0 + n)
            g = np.arange(g0, g0 + n)
            reads[g] += 1  # an index past the total raises here
            buf[g - 4 * (g0 >> 2)] = words[g]
        live = np.zeros(buf.size, bool)  # loaded, not yet read
        live[a:a + n] = True
        for m0 in range((P - 1) // NT * NT, -1, -NT):  # rounds downwards
            ms = np.arange(m0, min(m0 + NT, P))
            z = np.zeros((32, ms.size), np.uint32)
            for k, mm in enumerate(ms):
                pos = a + off[mm] + np.arange(w[mm])
                z[:w[mm], k] = buf[pos]
                live[pos] = False
            _butterfly(z)
            dst = qidx[ms].reshape(-1, 32)
            assert not live[dst].any(), "a slot written over unread words"
            x = z.T.astype(np.int64)
            buf[dst] = ((x >> 1) ^ -(x & 1)).astype(np.uint32)
        assert not live.any()
        b = s * sb + (_brev(m, logP) << logC) + _brev(r, logC)
        lines = (b[:, None, None] * 32 + np.arange(8)[None, :, None] * 4
                 + np.arange(4))
        sym[lines] = buf[qidx].view(np.int32)
        scount[lines] += 1
    return sym, scount, reads, waits


# ----------------------------------------------------------------------
# Tests
# ----------------------------------------------------------------------
_GEOS = [(1, 70), (2, 3), (64, 1), (64, 40), (256, 1), (256, 6),
         (4096, 1), (4096, 2)]


def _check_waits(waits):
    assert all(w < waiter for waiter, w in waits), "waited on a later ticket"


@pytest.mark.parametrize("kind", ["mixed", "zero", "wide"])
@pytest.mark.parametrize("align", [1, 4, 1024])
@pytest.mark.parametrize("sb,nsb", _GEOS)
def test_schedule_matches_plain(sb, nsb, align, kind):
    """K5's and K6's shipped geometry (P = min(sb, PB)) word for word
    against the plain versions."""
    _round_trip(sb, nsb, align, kind, LOG_PB, seed=sb * 31 + nsb + align)


@pytest.mark.parametrize("align", [1, 4])
@pytest.mark.parametrize("sb,nsb", [g for g in _GEOS if g[1] > 1])
def test_schedule_full_slots_at_odd_offsets(sb, nsb, align):
    """Superblocks of 32-bit blocks after one of a single word: at align=1
    every slot of a round stages 32 words at quad phase 1, reaching into
    the next slot's first words (the buffer's four leading words keep
    them from a slot not yet read)."""
    _round_trip(sb, nsb, align, "wide_after_odd", LOG_PB, seed=nsb)


@pytest.mark.parametrize("sb,nsb,align,log_pb", [
    (4096, 2, 1024, LOG_PB + 1),  # clusters of 4 (the variants script's)
    (64, 5, 4, 4), (256, 3, 1, 4),  # clusters of 4 and 16 CTAs of 16
    (256, 2, 1024, 5)])
def test_schedule_other_cluster_sizes(sb, nsb, align, log_pb):
    assert (sb >> min(sb.bit_length() - 1, log_pb)) <= MAX_C
    for kind in ("mixed", "wide"):
        _round_trip(sb, nsb, align, kind, log_pb, seed=log_pb)


def _round_trip(sb, nsb, align, kind, log_pb, seed):
    rng = np.random.default_rng(seed)
    sym = _symbols(kind, sb * 32 * nsb, seed, sb)
    words_p, widths_p, total_p = T.encode_core_plain(
        torch.from_numpy(sym), sb, align)
    total = int(total_p)
    out, count, widths, wcount, offs, waits = emulate_encode(
        sym, sb, align, log_pb, rng)
    _check_waits(waits)
    assert offs[-1] == total
    np.testing.assert_array_equal(widths, widths_p.numpy())
    assert (wcount == 1).all()
    np.testing.assert_array_equal(out[:total],
                                  words_p[:total].numpy().view(np.uint32))
    assert (count[:total] == 1).all(), "a word below the total not once"
    assert (count[total:] == 0).all() and (out[total:] == 0xDEADBEEF).all()

    words = out[:total].copy()
    back, scount, reads, waits = emulate_decode(words, widths, sb, align,
                                                log_pb, rng)
    _check_waits(waits)
    np.testing.assert_array_equal(back, sym)
    np.testing.assert_array_equal(
        back, T.decode_core_plain(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(widths), sb,
                                  align).numpy())
    assert (scount == 1).all()
    lens = widths.reshape(-1, sb).astype(np.int64).sum(1)
    data = np.zeros(total, np.int64)  # each data word once, no gap word
    for s, L in enumerate(lens):
        data[offs[s]:offs[s] + L] = 1
    np.testing.assert_array_equal(reads, data)


@pytest.mark.parametrize("C,resident", [(1, 1), (1, 3), (8, 2), (8, 9),
                                        (4, 1)])
def test_lookback_finishes_under_random_start_orders(C, resident):
    """The look-back by ticket under many random start orders, as few as
    one unit resident: every unit finds its exclusive offset, and waits
    only on units with an earlier ticket."""
    rng = np.random.default_rng(C * 10 + resident)
    for trial in range(20):
        A = rng.integers(0, 5, 75) * rng.choice([1, 4, 1024])
        found = lookback_schedule(A, C, resident, rng)
        assert found is not None
        E, waits = found
        _check_waits(waits)
        want = np.concatenate([[0], np.cumsum(A)[:-1]])
        np.testing.assert_array_equal(E, np.repeat(want, C))


def test_lookback_by_block_index_can_deadlock():
    """The scheduler sees the fault the ticket rules out: with the unit's
    superblock taken from blockIdx, a later superblock that starts first
    waits on one that cannot start."""
    rng = np.random.default_rng(7)
    A = np.ones(40, np.int64)
    outcomes = [lookback_schedule(A, 1, 2, rng, by_ticket=False)
                for _ in range(10)]
    assert any(o is None for o in outcomes)


def test_emulated_geometry_is_the_kernels():
    """The emulation reads NT, PB and MAX_C from csrc/bfx.cu: superblocks of
    4096 blocks are clusters of 8 CTAs of 512 blocks, and the largest
    superblock fits the largest cluster."""
    assert (NT, LOG_PB, MAX_C) == (256, 9, 16)
    assert _geometry(4096, LOG_PB) == (512, 9, 3)
    assert _geometry(256, LOG_PB) == (256, 8, 0)
    assert _geometry(1, LOG_PB) == (1, 0, 0)
