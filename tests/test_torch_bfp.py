"""PyTorch port, BFP codec: for the same int32 symbols the port writes the
same BFP5 bytes as the JAX package's XLA cores (use_pallas=False) plus
serialize, and decodes them back. The port's CPU path runs the plain
versions of kernels K2/K3, so these are also their byte-level oracles."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgard_tpu
import mgard_tpu_torch
from mgard_tpu.lossless import bfp as J
from mgard_tpu_torch.lossless import bfp as T

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


@pytest.fixture(autouse=True)
def _fresh_k_caches(monkeypatch):
    """Sticky K is per process and package: start both empty."""
    monkeypatch.setattr(J, "_K_CACHE", {})
    monkeypatch.setattr(T, "_K_CACHE", {})


def _cfgs(sb, C, K):
    out = []
    for cls in (mgard_tpu.Config, mgard_tpu_torch.Config):
        c = cls()
        c.bfp_sb_blocks, c.bfp_chunk, c.bfp_base_planes = sb, C, K
        out.append(c)
    return out


def _symbols(n, scale, exceptions, seed):
    rng = np.random.default_rng(seed)
    sym = (rng.standard_normal(n) * scale).astype(np.int32)
    sym[: n // 7] //= 64  # mixed widths: the sort has work to do
    if exceptions:
        idx = rng.integers(0, n, max(n // 2000, 3))
        sym[idx] = rng.integers(-(2**30), 2**30, idx.size).astype(np.int32)
    return sym


# (n, scale, sb, C, K, exceptions): narrow (K+E <= 16) and wide (K pinned
# so K+E > 16), with and without exception chunks, sb in {256, 8192,
# 16384} and C in {2, 4, 16} (C halves until sb % (128C) == 0: sb=256 runs
# C=2).
CASES = [
    (256 * 32 * 3 + 100, 40, 256, 16, 0, False),
    (256 * 32 * 2, 40, 256, 2, 0, True),
    (256 * 32 * 2, 3e5, 256, 2, 12, True),
    (8192 * 32, 40, 8192, 4, 0, True),
    (8192 * 32, 5e4, 8192, 4, 12, False),
    (16384 * 32, 40, 16384, 16, 0, False),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_generic_stream_bytes_match_jax(case):
    n, scale, sb, C, K, exc = CASES[case]
    sym = _symbols(n, scale, exc, case)
    jc, tc = _cfgs(sb, C, K)
    jb = J.encode(jnp.asarray(sym), jc)
    tb = T.encode(torch.from_numpy(sym), tc)
    hdr = struct.unpack_from(J._HDR, tb, 0)
    assert hdr[5] == sb and (hdr[7] > 0) == exc
    assert (hdr[3] + hdr[4] > 16) == (K == 12)
    assert tb == jb
    out, used = T.decode(tb)
    assert used == len(tb)
    np.testing.assert_array_equal(out.numpy(), sym)


def _prepared_payload(NC, C, K, E, seed):
    """u16 zigzag rows whose chunk widths stay within K+E <= 16."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, K + E + 1, NC)
    w[: NC // 5] = 0
    hi = (1 << w.astype(np.int64))[:, None]
    rows = (rng.integers(0, 1 << 30, (NC, C * 32)) % hi).astype(np.uint16)
    cw = np.array([int(r.max()).bit_length() for r in rows], np.int32)
    return rows, np.clip(cw - K, 0, E).astype(np.int32)


@pytest.mark.parametrize("sb,C,K,E", [(256, 2, 3, 8), (8192, 4, 4, 8),
                                      (16384, 16, 6, 8), (16384, 8, 0, 7)])
def test_prepared_stream_bytes_match_jax(sb, C, K, E):
    NC = 2 * sb // C
    rows, crl = _prepared_payload(NC, C, K, E, sb + C)
    n = NC * C * 32
    jo = J.encode_core_zz(jnp.asarray(rows), jnp.asarray(crl), K, E, sb,
                          False, C)
    jb = J.serialize_prepared(n, K, E, sb, C, crl, *jo)
    trows = torch.from_numpy(rows.view(np.int16).copy())
    to = T.encode_core_zz(trows, torch.from_numpy(crl), K, E, sb, C)
    from mgard_tpu_torch.utils.bytesink import join

    tb = join(T.serialize_prepared_parts(n, K, E, sb, C,
                                         torch.from_numpy(crl), *to))
    assert tb == jb
    base, tcrl, rbuf, geom, used = T.deserialize_prepared(tb)
    assert geom == (n, K, E, sb, C) and used == len(tb)
    back = T.decode_core_zz(base, tcrl, rbuf, K, E, sb, n // 32, C)
    np.testing.assert_array_equal(back.numpy().view(np.uint16), rows)


def test_decode_jax_written_blob_with_exceptions():
    sym = _symbols(40000, 3e5, True, 11)
    jc = mgard_tpu.Config()
    jc.bfp_base_planes = 12
    jb = J.encode(jnp.asarray(sym), jc)
    out, used = T.decode(jb)
    assert used == len(jb)
    np.testing.assert_array_equal(out.numpy(), sym)


def test_extreme_magnitudes_roundtrip():
    sym = np.array([0, 1, -1, 2**31 - 1, -(2**31), 12345, -99999] * 700,
                   np.int32)
    blob = T.encode(torch.from_numpy(sym))
    assert blob == J.encode(jnp.asarray(sym))
    np.testing.assert_array_equal(T.decode(blob)[0].numpy(), sym)


def test_sort_plan_and_offsets_match_jax():
    rng = np.random.default_rng(5)
    E = 8
    rl = rng.integers(0, E + 1, (3, 512)).astype(np.int32)
    rj, cj = J._sort_plan(jnp.asarray(rl), E)
    rt, ct = T._sort_plan(torch.from_numpy(rl), E)
    assert rt.dtype == torch.int32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    for a, b in zip(T._plan_offsets(ct, 4), J._plan_offsets(cj, 4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    hist = rng.integers(0, 1000, 33)
    for C in (2, 8, 16):
        assert T.choose_K(hist, E, C) == J.choose_K(hist, E, C)


_BAND_CASES = [
    (0, 16, 7, 16, J.SB_BLOCKS),
    (1, 4, 7, 16, J.SB_BLOCKS),
    (2, 2, 15, 4, J.SB_BLOCKS),
    (3, 1, 1, 4, J.SB_BLOCKS_SMALL),
    (4, 3, 7, 16, J.SB_BLOCKS_SMALL),
]


@pytest.mark.parametrize("seed,nsb,E,C,sb", _BAND_CASES)
def test_band_compaction_matches_jax(seed, nsb, E, C, sb):
    """Band compaction/expansion, including zero-count bands (the cases of
    tests/test_bfp.py::test_band_compaction_matches_index_oracle): the
    plain versions of K12/K13, which the CPU runs, against the JAX
    package's NumPy compaction and expansion."""
    L = J.LANES
    rng = np.random.default_rng(seed)
    NC = (sb // C) * nsb
    crl = rng.integers(0, E + 1, NC).astype(np.uint8)
    if seed == 0:
        crl[: sb // C] = 0
    _src, rows = J._band_src_indices(crl, E, C, sb)
    rf = rng.integers(0, 2**32, max(rows * L, 1), np.uint64).astype(np.uint32)
    ref = J._compact_resid(rf, crl, E, C, sb)
    cnt, rband, start, rows_t = T._band_geometry(crl, E, C, sb)
    assert rows_t == rows
    tab = torch.from_numpy(T._wire_table(cnt, rband, start, C))
    resid2d = torch.from_numpy(rf.view(np.int32)).reshape(-1, L)
    wire = T.compact_wire_plain(resid2d, tab, C)
    np.testing.assert_array_equal(wire.numpy().view(np.uint32), ref)
    want = J._expand_resid(ref, crl, E, C, sb)[0]  # rows + spare rows
    got = T.expand_wire_plain(wire, tab, C, rows).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want[:rows])
    assert not want[rows:].any()


def test_corrupt_sidecar_is_rejected():
    sym = _symbols(8192, 40, False, 1)
    blob = bytearray(T.encode(torch.from_numpy(sym)))
    _m, _n, _rw, _K, E, _sb, _C, _c = struct.unpack_from(T._HDR, blob, 0)
    blob[struct.calcsize(T._HDR)] = 0xFF  # residual length 15 > E
    with pytest.raises(ValueError):
        T.decode(bytes(blob))
