"""PyTorch port, K9 schedule: a NumPy emulation of what each warp and lane
of csrc/bitplane.cu computes (no JAX, no card).

A block of NW warps owns 32 columns of the (32, m) view. Warp w, a column
a lane, quantizes rows [8w, 8w + 8) from their IEEE-754 bits and writes
one 16-byte slot data[k][lane] = (fx, sm, r, float(fx)) and one word
zs[k][lane] = fx | sign << min(B, 31) a value. After the barrier warp 0
reads its column's 32 words back, runs the 32x32 butterfly and stores the
plane words; and warp w takes entry chunk (w + 1) % NW of the B+1 table
entries: lane l walks the 32
slots of column l, forms each entry's residual (by __int2float_rn for
s = B - b >= 24, else as the exact difference of two floats offset by
2^23, with hb = sm & 2^(s-1)), keeps max |d| and the fused square sum,
writes its column partials to the warp's fold rows, and lane i folds row
i over the 32 columns into the partial (block, b).

The emulation follows that schedule step for step and holds it against
encode_core_plain: planes and max partials bit for bit, the finished
err_sq table within relative 1e-6. It checks that the chunks split [0, B]
for every B with the converted entries in their own chunk, that every
slot, plane word and partial is written exactly once, that the shared
accesses are free of bank conflicts, and that the offset difference is
the int-to-float conversion on every value it is used for (and not one
bit further)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mgard_tpu_torch.mdr import bitplane as T

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

_SRC = (Path(T.__file__).resolve().parent.parent / "csrc"
        / "bitplane.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr \w+ {name} = (0x[0-9A-Fa-f]+|\d+)u?;",
                         _SRC).group(1), 0)


NW = _const("NW")
MAGIC_MAX_S = _const("MAGIC_MAX_S")
MAX_CHUNK = _const("MAX_CHUNK")
PITCH = _const("PITCH")
MAGIC = np.uint32(_const("MAGIC"))
FULL = np.uint32(0xFFFFFFFF)
U32 = np.uint32

_MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
          1: 0x55555555}


def _f32(u):
    return np.asarray(u, np.uint32).view(np.float32)


def _bits(f):
    return np.asarray(f, np.float32).view(np.uint32)


def _clz(x):
    x = np.asarray(x, np.uint32)
    bl = np.zeros(x.shape, np.int64)
    for b in range(32):
        bl = np.where((x >> U32(b)) != 0, b + 1, bl)
    return 32 - bl


def _quantize(v, exp, fb, lim):
    """bitplane.cu quantize() on float32 v: (mag, r, sign), uint32 steps."""
    bits = _bits(v)
    sign = bits >> U32(31)
    ebits = ((bits >> U32(23)) & U32(0xFF)).astype(np.int64)
    mant = bits & U32(0x7FFFFF)
    mant24 = np.where(ebits == 0, mant, mant | U32(0x800000)).astype(U32)
    e = np.where(ebits == 0, -126, ebits - 127)
    sh = e - 23 + (fb - exp)
    shl = np.where(sh >= 0, np.minimum(sh, 31), 0).astype(U32)
    kc = np.where(sh >= 0, 0, np.minimum(-sh, 31)).astype(U32)
    half = (U32(1) << kc) >> U32(1)
    up = (mant24 << shl).astype(U32)
    f = np.where(sh >= 0, up, (mant24 + half) >> kc).astype(U32)
    mag = np.minimum(f, U32(lim)).astype(U32)
    remi = (up - (mag << kc)).astype(U32).view(np.int32)
    scale = _f32(((127 - kc.astype(np.int64)) << 23).astype(U32))
    r = remi.astype(np.float32) * scale
    return mag, r.astype(np.float32), sign


def _sm(fx):
    """__funnelshift_rc(0x7FFFFFFF, 0, __clz(fx)): the bits below fx's top
    bit (0 for fx = 0; the shift is clamped at 32)."""
    c = _clz(fx)
    return np.where(c >= 32, 0, U32(0x7FFFFFFF) >> np.minimum(c, 31)
                    .astype(U32)).astype(U32)


def _butterfly(z):
    """bits.cuh bit_transpose<32> on z (32, n) uint32, in place."""
    s = 16
    while s:
        mk = U32(_MASKS[s])
        for i in range(32):
            if i & s == 0:
                t = ((z[i] >> U32(s)) ^ z[i + s]) & mk
                z[i] ^= t << U32(s)
                z[i + s] ^= t
        s >>= 1
    return z


def chunk_of(c, B):
    """bitplane.cu chunk_of: (b0, n, general) of entry chunk c."""
    G = B - MAGIC_MAX_S if B > MAGIC_MAX_S else 0
    if G > 0 and c == 0:
        return 0, G, True
    if G > 0:
        per = (MAGIC_MAX_S + 1) // 3
        return G + (c - 1) * per, per, False
    b0 = c * (B + 1) // NW
    return b0, (c + 1) * (B + 1) // NW - b0, False


def _entry_consts(b, B):
    s = B - b
    mask = FULL if b == 0 else U32((1 << s) - 1)
    half = U32(1 << (s - 1)) if 1 <= b < B else U32(0)
    return mask, half


def _fma32(a, b, c):
    """__fmaf_rn(a, b, c) in float32 via float64 (a*b is exact there; the
    sum can round twice, which moves err_sq by an ulp, not emax)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _banks_ok(words, width):
    """A warp's shared access, word address per lane, `width` words each:
    the hardware serves 32 / width lanes a phase; inside a phase no two
    lanes may touch one bank at different addresses."""
    words = np.asarray(words)
    per = 32 // width
    for p in range(0, 32, per):
        seen = {}
        for a in words[p:p + per]:
            for q in range(width):
                bank = (a + q) % 32
                if seen.setdefault(bank, a + q) != a + q:
                    return False
    return True


def emulate(v2d, exp, B):
    """The kernel's outputs and write counts: planes (B+1, m) uint32,
    emax/esq (m/32, B+1) float32, each with the number of times a word was
    written."""
    m = v2d.shape[1]
    nblk = m // 32
    sbit = min(B, 31)
    lim = (1 << (B - 1)) - 1
    planes = np.zeros((B + 1, m), U32)
    pcount = np.zeros((B + 1, m), np.int64)
    emax = np.zeros((nblk, B + 1), np.float32)
    esq = np.zeros((nblk, B + 1), np.float32)
    ecount = np.zeros((nblk, B + 1), np.int64)
    # phase A, warp w: rows [8w, 8w + 8); lane l of block blk is column
    # 32 blk + l; data slots [blk, k, l] of 4 words, zs words [blk, k, l]
    rows_a = 32 // NW
    data = np.zeros((nblk, 32, 32, 4), U32)
    zs = np.zeros((nblk, 32, 32), U32)
    dcount = np.zeros((nblk, 32, 32), np.int64)
    zcount = np.zeros((nblk, 32, 32), np.int64)
    for w in range(NW):
        for k in range(w * rows_a, (w + 1) * rows_a):
            assert _banks_ok(4 * (k * 32 + np.arange(32)), 4)  # STS.128
            assert _banks_ok(k * 32 + np.arange(32), 1)  # STS zs
            fx, r, sign = _quantize(v2d[k], exp, B - 1, lim)
            slot = np.stack([fx, _sm(fx), _bits(r),
                             _bits(fx.view(np.int32).astype(np.float32))],
                            -1)
            data[:, k] = slot.reshape(nblk, 32, 4)
            dcount[:, k] += 1
            zs[:, k] = (fx | (sign << U32(sbit))).reshape(nblk, 32)
            zcount[:, k] += 1
    assert (dcount == 1).all() and (zcount == 1).all()
    # after the barrier, warp 0: its column's 32 words back, the butterfly
    z = np.zeros((32, m), U32)
    for k in range(32):
        assert _banks_ok(k * 32 + np.arange(32), 1)  # LDS zs
        z[k] = zs[:, k].reshape(m)
    _butterfly(z)
    row = B  # the row pointer, walked upwards from plane row B
    for t in range(31):
        if t < B:
            planes[row] = z[t]
            pcount[row] += 1
            row -= 1
    if B == 32:
        planes[row] = 0
        pcount[row] += 1
    planes[0] = z[sbit]
    pcount[0] += 1
    # phase B: warp w, chunk (w + 1) % NW, lane l column l of the block
    partials = []
    for w in range(NW):
        b0, n, general = chunk_of((w + 1) % NW, B)
        consts = [_entry_consts(b0 + i, B) for i in range(n)]
        mx = np.zeros((n, nblk, 32), np.float32)
        sq = np.zeros((n, nblk, 32), np.float32)
        for k in range(32):
            assert _banks_ok(4 * (k * 32 + np.arange(32)), 4)  # LDS.128
            e = data[:, k]  # (nblk, 32, 4)
            fx, sm, r, fxf = e[..., 0], e[..., 1], _f32(e[..., 2]), \
                _f32(e[..., 3])
            for i, (mask, half) in enumerate(consts):
                x = ((fx & mask) - (sm & half)).astype(U32).view(np.int32)
                conv = x.astype(np.float32)  # __int2float_rn
                if general and i == 0:
                    d = fxf + r
                elif general:
                    d = conv + r
                else:
                    lo = _f32((fx & mask) | MAGIC)
                    hb = _f32((sm & half) | MAGIC)
                    diff = lo - hb
                    # the offset difference is the conversion, bit for bit
                    assert np.array_equal(_bits(diff), _bits(conv))
                    d = diff + r
                mx[i] = np.maximum(mx[i], np.abs(d))
                sq[i] = _fma32(d, d, sq[i])
        partials.append((b0, n, mx, sq))
    # fold rows: warp w's rows [w * 2 MAX_CHUNK, (w + 1) * 2 MAX_CHUNK) of
    # PITCH words each
    fold = np.zeros((nblk, NW * 2 * MAX_CHUNK * PITCH), np.float32)
    fcount = np.zeros(fold.shape[1], np.int64)
    for w, (b0, n, mx, sq) in enumerate(partials):
        base = w * 2 * MAX_CHUNK
        for i in range(n):
            for row, part in ((2 * i, mx[i]), (2 * i + 1, sq[i])):
                at = (base + row) * PITCH + np.arange(32)
                assert _banks_ok(at, 1)  # STS
                fold[:, at] = part
                fcount[at] += 1
        # lane l < 2n folds row l, column c = 0..31 in order
        for c in range(32):
            assert _banks_ok((base + np.arange(2 * n)) * PITCH + c, 1)
        for i in range(n):
            b = b0 + i
            rmax = fold[:, (base + 2 * i) * PITCH + np.arange(32)]
            rsum = fold[:, (base + 2 * i + 1) * PITCH + np.arange(32)]
            emax[:, b] = rmax.max(axis=1)
            acc = np.zeros(nblk, np.float32)
            for c in range(32):
                acc = (acc + rsum[:, c]).astype(np.float32)
            esq[:, b] = acc
            ecount[:, b] += 1
    assert fcount.max() <= 1  # no two warps' rows overlap
    return planes, pcount, emax, esq, ecount


def _level(m, kind, seed):
    rng = np.random.default_rng(seed)
    n = 32 * m
    if kind == "zeros":
        return np.zeros(n, np.float32)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-4, 3, n)
    if kind == "specials":
        v = rng.standard_normal(n) * 1e-3
        v[:14] = [0.0, -0.0, 1e-38, -1e-38, 1e30, -1e30, 1e-45, -1e-45,
                  3e-41, -7e-40, 1.0, -2.0, 2.0 ** -126, -(2.0 ** -149)]
    return v.astype(np.float32)


def _check(v, B):
    m = v.size // 32
    v2d = v.reshape(32, m)
    tv = torch.from_numpy(v2d)
    exp = T._level_exp(tv.abs().max().double())
    planes, pcount, emax, esq, ecount = emulate(v2d, int(exp), B)
    pp, pe, ps = T.encode_core_plain(tv, exp, B)
    assert (pcount == 1).all() and (ecount == 1).all()
    np.testing.assert_array_equal(planes.view(np.int32), pp.numpy())
    np.testing.assert_array_equal(emax, pe.numpy())
    kq = T._finish_tables(torch.from_numpy(emax), torch.from_numpy(esq))[1]
    pq = T._finish_tables(pe, ps)[1]
    rel = ((kq - pq).abs() / pq.clamp_min(1e-300)).max()
    assert float(rel) <= 1e-6


@pytest.mark.parametrize("B", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "specials", "zeros"])
def test_schedule_matches_plain(kind, B):
    """One kernel tile (m = 2048, 64 blocks) of each kind."""
    _check(_level(2048, kind, seed=B), B)


@pytest.mark.parametrize("B", [1, 23, 24, 31])
def test_schedule_matches_plain_at_chunk_edges(B):
    """B = 1 (empty chunks), 23 (the last B without converted entries), 24
    (one converted entry), 31 (the sign at bit 31 below B = 32)."""
    _check(_level(64, "random", seed=B), B)


def test_schedule_matches_plain_at_a_coarse_level():
    """The 384^3 field's coarsest K9 level: 131,072 elements, m = 4096,
    128 blocks (level values from a smooth field decay toward the
    finest)."""
    rng = np.random.default_rng(6)
    v = (rng.standard_normal(32 * 4096) * np.linspace(1.0, 1e-3, 32 * 4096)
         ).astype(np.float32)
    _check(v, 32)


def test_chunks_split_every_B():
    """For every B the NW chunks cover [0, B] once, hold at most MAX_CHUNK
    entries, keep every entry with s >= 24 (the ones the offset difference
    cannot carry) in the converting chunk 0 and the rest out of it; warp w
    runs chunk (w + 1) % NW, so warp 0, which also quantized, never takes
    the converting chunk."""
    for B in range(1, 33):
        seen = np.zeros(B + 1, np.int64)
        for c in range(NW):
            b0, n, general = chunk_of(c, B)
            assert 0 <= n <= MAX_CHUNK
            seen[b0:b0 + n] += 1
            for b in range(b0, b0 + n):
                assert general == (B - b > MAGIC_MAX_S)
            assert not general or (c == 0 and b0 == 0)
        assert (seen == 1).all(), B
    assert chunk_of((0 + 1) % NW, 32)[2] is False
    assert [chunk_of(c, 32)[:2] for c in range(NW)] == [(0, 9), (9, 8),
                                                         (17, 8), (25, 8)]


def test_offset_difference_is_the_conversion():
    """as_float(low | 2^23 bits) - as_float(hb | 2^23 bits) == float(low -
    hb) (__int2float_rn, exact here) for every low below 2^23 and the hb the
    kernel forms (0 or 2^(s-1), s <= 23), and on every edge of |x| < 2^22
    as the 1.5 * 2^23 form states it; one bit further (low >= 2^23) the
    offset form is wrong (2^23 + 1 reads as 2^23 + 2), which is why s
    stops at MAGIC_MAX_S = 23."""
    low = np.arange(1 << 23, dtype=np.uint32)
    for hb in (0, 1, 1 << 21, 1 << 22):
        got = _f32(low | MAGIC) - _f32(U32(hb) | MAGIC)
        want = (low.astype(np.int64) - hb).astype(np.int32).astype(
            np.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert MAGIC_MAX_S == 23 and MAGIC == 0x4B000000
    edges = np.array([0, 1, -1, 2, -2, (1 << 21), -(1 << 21), (1 << 22) - 1,
                      -(1 << 22) + 1, (1 << 22) - 2, 12345, -54321],
                     np.int64)
    wide_offset = _f32((0x4B400000 + edges).astype(U32)) - np.float32(
        12582912.0)
    np.testing.assert_array_equal(wide_offset, edges.astype(np.float32))
    over = _f32(U32((1 << 23) + 1) | MAGIC) - _f32(MAGIC)
    assert over != np.float32((1 << 23) + 1)


def test_emulated_quantize_is_the_plain_one():
    """The emulated per-element quantize equals _int_quantize_f32 +
    _residue_f32 on values that hit every branch (subnormal, clamp, shift
    left and right, residue below 2^-31)."""
    v = _level(64, "specials", seed=3)
    v[20:30] = [3e38, -3e38, 1e-30, 7.0, 0.5, -0.25, 1e-10, 2.0 ** 30,
                -(2.0 ** -140), 123456.78]
    tv = torch.from_numpy(v)
    exp = T._level_exp(tv.abs().max().double())
    for B in (8, 32):
        mag, r, sign = _quantize(v, int(exp), B - 1, 2 ** (B - 1) - 1)
        pm, remi, kc, ps = T._int_quantize_f32(tv, exp, B - 1,
                                               2 ** (B - 1) - 1)
        np.testing.assert_array_equal(mag.view(np.int32), pm.numpy())
        np.testing.assert_array_equal(sign.view(np.int32), ps.numpy())
        np.testing.assert_array_equal(
            _bits(r), _bits(T._residue_f32(remi, kc).numpy()))
        sm = _sm(mag)
        for s in range(1, 32):  # sm has bit s-1 exactly when mag >= 2^s
            np.testing.assert_array_equal(
                (sm >> U32(s - 1)) & U32(1), (mag >= (1 << s)).astype(U32))


def test_emulated_constants_are_the_kernels():
    """The constants this emulation reads, and the lines it mirrors (entry
    masks, residuals, the chunk rule), are the kernel's."""
    assert NW == 4 and PITCH == 33 and MAX_CHUNK == 9
    assert "chunk_of((warp + 1) % NW, B, b0, n, general);" in _SRC
    assert "__shared__ uint4 data[32 * 32];" in _SRC
    assert "__shared__ unsigned zs[32 * 32];" in _SRC
    assert "x[u] = v[(warp * (32 / NW) + u) * m + j];" in _SRC
    assert "for (int k = 0; k < 32; ++k) z[k] = zs[k * 32 + lane];" in _SRC
    assert "__shared__ float fold[NW][2 * MAX_CHUNK][PITCH];" in _SRC
    assert "float(*rows)[PITCH] = fold[warp];" in _SRC
    assert "d = __fadd_rn(__fsub_rn(lo, hb), r);" in _SRC
    for line in ("const float lo = __uint_as_float((e.x & mask[i]) | MAGIC);",
                 "const float hb = __uint_as_float((e.y & half[i]) | MAGIC);",
                 "const int x = (int)((e.x & mask[i]) - (e.y & half[i]));",
                 "mask[i] = b == 0 ? FULL : (1u << s) - 1u;",
                 "half[i] = (b >= 1 && b < B) ? 1u << (s - 1) : 0u;",
                 "b0 = G + (c - 1) * ((MAGIC_MAX_S + 1) / 3);",
                 "n = (MAGIC_MAX_S + 1) / 3;",
                 "b0 = c * (B + 1) / NW;",
                 "n = (c + 1) * (B + 1) / NW - b0;",
                 "const int G = B > MAGIC_MAX_S ? B - MAGIC_MAX_S : 0;"):
        assert line in _SRC, line
    assert "sq[i] = __fmaf_rn(d, d, sq[i]);" in _SRC
    assert "__funnelshift_rc(0x7FFFFFFFu, 0u, __clz((int)fx))" in _SRC
