"""PyTorch port, K12/K13 thread schedule: a NumPy emulation of what each
thread of csrc/bfp.cu's wire kernels reads and writes (no card).

K12 (bfp_compact) and K13 (bfp_expand) take one CTA of 256 threads a
(superblock, plane) band, a row of the wire table (start row, rband, cnt,
wire offset), and split an index into slot and column with a
multiply-and-shift divider made once a CTA. K12's thread t walks the
band's words k = t + NT*(WU*j + u), WU loads in flight, reading word
k - b*cnt of slot b's rows and writing wire word offset + k. K13's walks
the band buffer's 16-byte quads q = t + NT*(WQ*j + u), storing quad
start*32 + q whole: the wire words of slot b, columns 4(q - b*rband*32)
and the three after, where below cnt, and zeros past it. The emulation
follows that schedule, checks the divider against integer division over
the kernels' range, that every output word is written exactly once, that
a warp's lanes store consecutive words (K13: consecutive quads), and
holds the result bit for bit against a NumPy oracle that slices band by
band (the JAX package's host compaction and expansion, written out here)
and the plain versions, on every bfp.BAND_CASES geometry in both the
row-padded and the static-cap layout, and on empty, full and
single-superblock streams. Then the blob path end to end on the CPU (the
wrappers run their plain versions): the JAX package's bytes, with and
without exceptions, and bodies read at every alignment."""

import struct

import jax.numpy as jnp

import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu.lossless import bfp as J
from mgard_tpu_torch.lossless import bfp as T
from mgard_tpu_torch.utils import trace
from mgard_tpu_torch.utils.bytesink import join

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

NT, WU, WQ, LANES = 256, 8, 4, 128


def _divider(d):
    """csrc/bfp.cu divider(): (m, l) for 1 <= d < 2^31."""
    d = np.asarray(d, np.uint64)
    l = np.ceil(np.log2(d.astype(np.float64))).astype(np.uint64)
    l = np.where(d == 1, 0, l).astype(np.uint64)
    m = ((np.uint64(1) << np.uint64(32)) * ((np.uint64(1) << l) - d)) // d
    return (m + np.uint64(1)) & np.uint64(0xFFFFFFFF), l


def _divide(k, mv):
    """csrc/bfp.cu divide(): (__umulhi(k, m) + k) >> l, on uint32 k."""
    m, l = mv
    k = np.asarray(k, np.uint64)
    hi = (k * m) >> np.uint64(32)
    return ((hi + k) & np.uint64(0xFFFFFFFF)) >> l


def test_divider_is_integer_division():
    for d in range(1, 600):
        k = np.arange(16 * d + 300, dtype=np.uint64)
        np.testing.assert_array_equal(_divide(k, _divider(d)), k // d)
    rng = np.random.default_rng(1)
    for d in [*rng.integers(600, 2 ** 31, 200), 2 ** 31 - 1, 2 ** 30,
              2 ** 30 + 1, 16384, 131072]:
        q = rng.integers(0, 2 ** 31 // d, 400)
        k = np.concatenate([q * d, q * d + d - 1, rng.integers(0, 2 ** 31,
                                                               400)])
        k = k[k < 2 ** 31].astype(np.uint64)
        np.testing.assert_array_equal(_divide(k, _divider(d)),
                                      k // np.uint64(d))


def _thread_indices(n, unroll):
    """Every (thread, index k) pair of one CTA's loop over n items, in the
    kernel's order: k0 = t, t + NT*unroll, ...; k = k0 + u*NT, k < n.
    Returns k of shape (steps, unroll, NT) and its mask."""
    steps = max(-(-n // (NT * unroll)), 1)
    k = (np.arange(NT)[None, None, :]
         + NT * unroll * np.arange(steps)[:, None, None]
         + NT * np.arange(unroll)[None, :, None])
    return k, k < n


def _coalesced(addr, ok):
    """Each warp's active lanes of one (step, u) store consecutive items."""
    a = addr.reshape(addr.shape[0], addr.shape[1], NT // 32, 32)
    m = ok.reshape(a.shape)
    steps = np.diff(a, axis=-1)
    assert (steps[m[..., 1:] & m[..., :-1]] == 1).all()


def _emulate_compact(resid_flat, tab, C):
    words = C * int(tab[:, 2].sum())
    out = np.zeros(words, np.uint32)
    hits = np.zeros(words, int)
    for row0, rb, cnt, woff in tab:
        if cnt == 0:
            continue  # the whole CTA returns
        n, rw = C * cnt, rb * LANES
        k, ok = _thread_indices(n, WU)
        b = _divide(k, _divider(cnt)).astype(np.int64)
        src = row0 * LANES + b * rw + (k - b * cnt)
        assert (k - b * cnt < cnt).all() and (src[ok] < (row0 + C * rb)
                                               * LANES).all()
        dst = woff + k
        _coalesced(dst, ok)
        out[dst[ok]] = resid_flat[src[ok]]
        np.add.at(hits, dst[ok], 1)
    assert (hits == 1).all(), "every wire word is written exactly once"
    return out


def _emulate_expand(wire, tab, C, rows):
    buf = np.zeros(rows * LANES, np.uint32)
    hits = np.zeros(rows * LANES, int)
    for row0, rb, cnt, woff in tab:
        rq = rb * (LANES // 4)  # quads a slot
        if rq == 0:
            continue
        q, ok = _thread_indices(C * rq, WQ)
        b = _divide(q, _divider(rq)).astype(np.int64)
        i = 4 * (q - b * rq)
        dstq = row0 * (LANES // 4) + q  # 16-byte aligned: row0*512 bytes
        _coalesced(dstq, ok)
        for e in range(4):
            val = ok & (i + e < cnt)
            v = np.zeros(q.shape, np.uint32)
            v[val] = wire[woff + b[val] * cnt + i[val] + e]
            buf[4 * dstq[ok] + e] = v[ok]
            np.add.at(hits, 4 * dstq[ok] + e, 1)
    assert (hits == 1).all(), "every band word is written exactly once"
    return buf.reshape(rows, LANES)


def _bands(cnt, rband, start, C):
    """(word offset, slots x rows view shape, valid count) of every band
    with valid words, in wire order."""
    for s in range(cnt.shape[0]):
        for p in range(cnt.shape[1]):
            c = int(cnt[s, p])
            if c:
                r = int(rband[s, p])
                yield int(start[s, p]) * LANES, (C, r * LANES), c


def _host_compact(resid_flat, cnt, rband, start, C):
    """Oracle of K12: each band's slots, their first cnt words each."""
    out = np.empty(C * int(cnt.sum()), np.uint32)
    o = 0
    for st, shape, c in _bands(cnt, rband, start, C):
        band = resid_flat[st: st + shape[0] * shape[1]].reshape(shape)
        out[o: o + C * c].reshape(C, c)[:] = band[:, :c]
        o += C * c
    assert o == out.size
    return out


def _host_expand(wire, cnt, rband, start, rows, C):
    """Oracle of K13: (rows, 128) zeros with each slot's wire words put
    back at its start."""
    buf = np.zeros(rows * LANES, np.uint32)
    o = 0
    for st, shape, c in _bands(cnt, rband, start, C):
        band = buf[st: st + shape[0] * shape[1]].reshape(shape)
        band[:, :c] = wire[o: o + C * c].reshape(C, c)
        o += C * c
    assert o == wire.size
    return buf.reshape(rows, LANES)


# (name, E, sb, C, superblocks, residual lengths: a BAND_CASES entry's
# widths, or "full" (every rl = E: cnt = sbc), "empty" (every rl = 0),
# "top" (every rl = E but one chunk a superblock at E - 1))
EXTRA_CASES = (
    ("full bands", 8, 256, 2, 2, "full"),
    ("empty stream", 8, 512, 4, 3, "empty"),
    ("single superblock, full", 8, 16384, 8, 1, "full"),
    ("E=15, one chunk short", 15, 256, 1, 2, "top"),
)


def _cases():
    for spec in T.BAND_CASES:
        yield spec[0], spec
    for extra in EXTRA_CASES:
        yield extra[0], extra


def _crl(spec, seed=0):
    """(crl, E, sb, C) of a case."""
    if len(spec) == 9:
        _name, _bits, K, E, sb, C, _nsb, _w, _static = spec
        cw = T.case_widths(spec, np.random.default_rng(seed))
        return np.clip(cw - K, 0, E).astype(np.int32), E, sb, C
    _name, E, sb, C, nsb, kind = spec
    NC = nsb * (sb // C)
    crl = np.full(NC, 0 if kind == "empty" else E, np.int32)
    if kind == "top":
        crl[:: sb // C] = E - 1
    return crl, E, sb, C


@pytest.mark.parametrize("static", [False, True], ids=["row-padded",
                                                       "static-cap"])
@pytest.mark.parametrize("spec", [c for _, c in _cases()],
                         ids=[n for n, _ in _cases()])
def test_wire_schedule_matches_host(spec, static):
    crl, E, sb, C = _crl(spec)
    cnt, rband, start, rows = T._band_geometry(crl, E, C, sb, static)
    # the histogram's counts: #(rl > j) a superblock and plane
    crl2 = crl.reshape(cnt.shape[0], -1)
    np.testing.assert_array_equal(
        cnt, (crl2[:, None, :] > np.arange(E)[None, :, None]).sum(2))
    tab = T._wire_table(cnt, rband, start, C)
    rng = np.random.default_rng(len(crl) + E)
    # random words in the padding too: compaction must leave them out
    resid = rng.integers(0, 2 ** 32, max(rows, 1) * LANES,
                         np.uint64).astype(np.uint32)
    wire = _emulate_compact(resid, tab, C)
    np.testing.assert_array_equal(wire, _host_compact(resid, cnt, rband,
                                                      start, C))
    tt = torch.from_numpy(tab)
    r2 = torch.from_numpy(resid.view(np.int32)).reshape(-1, LANES)
    np.testing.assert_array_equal(
        T.compact_wire_plain(r2, tt, C).numpy().view(np.uint32), wire)
    buf = _emulate_expand(wire, tab, C, rows)
    np.testing.assert_array_equal(buf, _host_expand(wire, cnt, rband, start,
                                                    rows, C))
    w2 = torch.from_numpy(wire.view(np.int32))
    np.testing.assert_array_equal(
        T.expand_wire_plain(w2, tt, C, rows).numpy().view(np.uint32), buf)
    # K3 reads a slot's first cnt words only: exactly what K13 took from
    # the wire, in the same place as the host's expansion
    for s in range(cnt.shape[0]):
        for p in range(E):
            st, rb, c = start[s, p], rband[s, p], cnt[s, p]
            got = buf[st: st + C * rb].reshape(C, rb * LANES)
            assert not got[:, c:].any()


def _prepared(spec, seed):
    """encode_core_zz of a BAND_CASES entry's u16 rows: (n, K, E, sb, C,
    crl, rows, base, resid2d)."""
    args, _cnt, _rows = T.band_case(spec, "cpu", seed)
    rows, _rank, _w, _r, _o, K, E, sb, C, _a = args
    crl = torch.from_numpy(_crl(spec, seed)[0])
    static = spec[-1]
    out = T.encode_core_zz(rows, crl, K, E, sb, C, static_cap=static)
    return rows.shape[0] * C * 32, K, E, sb, C, crl, rows, *out


_U16 = [s for s in T.BAND_CASES if s[1] == 16 and s[2] + s[3] <= 16]


@pytest.mark.parametrize("spec", _U16, ids=[s[0] for s in _U16])
def test_card_branch_writes_host_bytes(spec):
    """The one blob path, with the wrappers' plain versions on the CPU,
    writes the bytes of the JAX package's host serializer for the same
    rows, and reads the body back to K2's rows at each alignment. Each
    blob counts its wire map on the host."""
    n, K, E, sb, C, crl, rows, base, resid = _prepared(spec, 3)
    static = spec[-1]
    before = trace.counters()
    blob = join(T.serialize_prepared_parts(n, K, E, sb, C, crl, base, resid,
                                           static_cap=static))
    jo = J.encode_core_zz(jnp.asarray(rows.numpy().view(np.uint16)),
                          jnp.asarray(crl.numpy()), K, E, sb, False, C)
    assert blob == J.serialize_prepared(n, K, E, sb, C, crl.numpy(), *jo)
    nnib = (crl.shape[0] + 1) // 2
    assert (struct.calcsize(T._HDR) + nnib) % 4  # the body is unaligned
    for pad in range(4):
        got = T.deserialize_prepared(b"\x00" * pad + blob, pad, "cpu",
                                     static_cap=static)
        assert got[3:] == ((n, K, E, sb, C), len(blob))
        assert torch.equal(got[1], crl)
        back = T.decode_core_zz(*got[:3], K, E, sb, n // 32, C,
                                static_cap=static)
        assert torch.equal(back, rows)
    # a write and four reads, each a blob with its wire on the host
    after = trace.counters()
    assert [after.get(k, 0) - before.get(k, 0) for k in (
        "bfp.wire.device", "bfp.wire.host")] == [0, 5]


@pytest.mark.parametrize("K", [0, 12])
def test_card_branch_standalone_stream_with_exceptions(K):
    rng = np.random.default_rng(K)
    sym = (rng.standard_normal(256 * 32 * 3 + 77) * 3e4).astype(np.int32)
    sym[rng.integers(0, sym.size, 40)] = 2 ** 30 + 5
    cfg = type("Cfg", (), dict(bfp_base_planes=K, bfp_sb_blocks=256))()
    blob = T.encode(torch.from_numpy(sym), cfg)
    assert struct.unpack_from(T._HDR, blob)[7] > 0
    jc = mgard_tpu.Config()
    jc.bfp_base_planes, jc.bfp_sb_blocks = K, 256
    assert blob == J.encode(jnp.asarray(sym), jc)
    for pad in range(4):
        out, used = T.decode(b"\x01" * pad + blob, pad)
        assert used == len(blob)
        np.testing.assert_array_equal(out.numpy(), sym)
