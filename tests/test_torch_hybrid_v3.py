"""PyTorch port, fused transform+pack front end (hybrid flag 2): the plain
versions of K10/K11 (what the wrappers run for CPU tensors) and the
static-cap BFP layout against the JAX XLA oracles and the interpret-mode
Pallas kernels, on tests/test_hybrid_v3.py's shapes and field.

Tolerances: chunk widths, the sort rank, the residual planes and every
serialized byte are equal. Quantize is float: a value on a .5 rounding
boundary can flip by one symbol where one side fuses a multiply-add (the
contract tests/test_torch_hybrid_v2.py states for K1's plain version: under
1e-4 of the symbols), and a flipped symbol changes its low bit planes, so
under 1e-3 of the base words may differ (tests/test_hybrid_v3.py's bound);
float outputs agree to atol=1e-6 on an O(1) field."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgard_tpu
import mgard_tpu.highlevel as JHL
import mgard_tpu_torch as M
from mgard_tpu.lossless import bfp as JB
from mgard_tpu.ops import hybrid as JH
from mgard_tpu.utils.bytesink import join as jjoin
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.formats.metadata import MAGIC, Metadata
from mgard_tpu_torch.lossless import bfp as TB
from mgard_tpu_torch.ops import hybrid as TH
from mgard_tpu_torch.utils.bytesink import join as tjoin

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

SHAPE = (16, 256, 256)
SMALL = (16, 128, 256)
NL = 3
E = 8
Q = np.float32(1.7e-4)
INV_Q = np.float32(1.0) / Q


def _field(shape, seed=5):
    """tests/test_hybrid_v3.py's field."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, shape[0], dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        * np.cos(np.linspace(0, 3, shape[1], dtype=np.float32))[None, :, None]
        + np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :] ** 2
        + 0.05 * rng.standard_normal(shape).astype(np.float32)
    )
    return v.astype(np.float32)


def _i32(a):
    """A JAX u32/i32 array as the port's int32 bit patterns (a copy:
    torch wants writable memory)."""
    a = np.array(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


@pytest.fixture(scope="module")
def field():
    return _field(SHAPE)


@pytest.fixture(scope="module")
def K(field):
    """The base-plane count production would choose (the JAX test's rule)."""
    C = SHAPE[2] // 32
    _, cw0, _ = JH.local_transform_v2_xla(jnp.asarray(field),
                                          jnp.float32(INV_Q), NL, C)
    hist = np.bincount(np.clip(np.asarray(cw0), 0, 32), minlength=33)
    return JB.choose_K(hist, E, C)


@pytest.fixture(scope="module")
def oracle(field, K):
    """(base, resid, cw, rem) of the JAX XLA oracle, as NumPy arrays."""
    out = JH.transform_pack_v3_xla(jnp.asarray(field), jnp.float32(INV_Q),
                                   NL, K, E)
    return tuple(np.array(a) for a in out)


@pytest.fixture(scope="module")
def port_pack(field, K):
    return TH.local_transform_pack_v3(torch.from_numpy(field), float(INV_Q),
                                      NL, K, E)


@pytest.mark.parametrize("E_", [1, 8, 15])
def test_sort_plan_matches_jax_plan_kernel(E_):
    """The port's _sort_plan (K10's rank pass and K11 replay it) against
    the JAX in-kernel plan on one superblock of 1024 chunks."""
    rng = np.random.default_rng(E_)
    crl = rng.integers(0, E_ + 1, (1, 1024)).astype(np.int32)
    U = jnp.asarray(np.triu(np.ones((1024, 1024), np.float32), 1),
                    jnp.bfloat16)

    class _URef:
        def __getitem__(self, _):
            return U

    want = np.asarray(JH._v3_plan_kernel(jnp.asarray(crl), E_, _URef()))
    rank, cnt = TB._sort_plan(torch.from_numpy(crl), E_)
    np.testing.assert_array_equal(rank.numpy(), want)
    np.testing.assert_array_equal(
        cnt.numpy()[0], [(crl > j).sum() for j in range(E_)])


@pytest.mark.parametrize("ref", ["xla_oracle", "pallas_interpret"])
def test_transform_pack_matches_jax(ref, field, K, oracle, port_pack):
    if ref == "xla_oracle":
        base_j, resid_j, cw_j, rem_j = oracle
    else:
        out = JH.local_transform_pack_v3(jnp.asarray(field),
                                         jnp.float32(INV_Q), NL, K, E,
                                         interpret=True)
        base_j, resid_j, cw_j, rem_j = (np.asarray(a) for a in out)
    base_t, resid_t, cw_t, rem_t = port_pack
    assert int(cw_t.max()) <= K + E
    np.testing.assert_array_equal(cw_t.numpy(), cw_j)
    np.testing.assert_array_equal(resid_t.numpy(), _i32(resid_j))
    assert base_t.shape == base_j.shape
    assert (base_t.numpy() != _i32(base_j)).mean() < 1e-3
    np.testing.assert_allclose(rem_t.numpy(), rem_j, rtol=0, atol=1e-6)


def test_unpack_inverse_matches_jax(field, K, oracle):
    base_j, resid_j, cw_j, rem_j = oracle
    crl = np.clip(cw_j - K, 0, E).astype(np.int32)
    want = np.asarray(JH.unpack_inverse_v3_xla(
        jnp.asarray(base_j), jnp.asarray(crl), jnp.asarray(resid_j),
        jnp.asarray(rem_j), jnp.float32(Q), NL, K, E, jnp.float32, SHAPE))
    got = TH.unpack_inverse_v3(
        torch.from_numpy(_i32(base_j)), torch.from_numpy(crl),
        torch.from_numpy(_i32(resid_j)), torch.from_numpy(rem_j), float(Q),
        NL, K, E, SHAPE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # quantization is the only loss
    assert float(np.max(np.abs(got.numpy() - field))) <= float(Q) * (NL + 2)


def test_port_roundtrip_is_exact_up_to_quantization(field, K, port_pack):
    base, resid, cw, rem = port_pack
    crl = (cw - K).clamp(0, E)
    out = TH.unpack_inverse_v3(base, crl, resid, rem, float(Q), NL, K, E,
                               SHAPE)
    assert float((out - torch.from_numpy(field)).abs().max()) \
        <= float(Q) * (NL + 2)


def test_static_cap_bytes_match_jax(K, oracle):
    """The same device arrays serialize to the same BFP5 bytes in both
    packages, and parse back to the same static-cap arrays."""
    base_j, resid_j, cw_j, _ = oracle
    crl = np.clip(cw_j.ravel() - K, 0, E).astype(np.int32)
    Z = SHAPE[2]
    C, sb = Z // 32, 32 * Z
    n_cf = int(np.prod(SHAPE))
    jblob = jjoin(JB.serialize_prepared_parts(
        n_cf, K, E, sb, C, crl, base_j, resid_j, 0, static_cap=True))
    tblob = tjoin(TB.serialize_prepared_parts(
        n_cf, K, E, sb, C, torch.from_numpy(crl),
        torch.from_numpy(_i32(base_j)), torch.from_numpy(_i32(resid_j)),
        static_cap=True))
    assert tblob == jblob
    words = struct.unpack_from(TB._HDR, tblob)[2]
    assert words == JB.resid_wire_words(crl, E, C, sb)
    bj, rlj, rj, geom_j, used_j = JB.deserialize_prepared(jblob, 0,
                                                          static_cap=True)
    bt, rlt, rt, geom_t, used_t = TB.deserialize_prepared(tblob, 0, "cpu",
                                                          static_cap=True)
    assert geom_t == tuple(geom_j) == (n_cf, K, E, sb, C)
    assert used_t == used_j == len(tblob)
    np.testing.assert_array_equal(bt.numpy(), _i32(bj))
    np.testing.assert_array_equal(rlt.numpy(), np.asarray(rlj))
    rows = resid_j.shape[0]
    assert rt.shape == (rows, 128)
    np.testing.assert_array_equal(rt.numpy(), _i32(rj)[:rows])
    np.testing.assert_array_equal(rt.numpy(), _i32(resid_j))


def test_static_cap_blob_is_the_dynamic_blob(field, K, port_pack):
    """Static cap is a device layout only: the tile-major rows packed in
    the flag-1 row-padded layout serialize to the same bytes."""
    base, resid, cw, _ = port_pack
    Z = SHAPE[2]
    C, sb = Z // 32, 32 * Z
    n_cf = int(np.prod(SHAPE))
    crl = (cw - K).clamp(0, E).reshape(-1)
    pay, _, _ = TH.local_transform_v2(torch.from_numpy(field), float(INV_Q),
                                      NL, C)
    rows = TH.field_rows_tilemajor(pay).contiguous()
    dyn = TB.encode_core_zz(rows, crl, K, E, sb, C)
    a = tjoin(TB.serialize_prepared_parts(n_cf, K, E, sb, C, crl, *dyn))
    b = tjoin(TB.serialize_prepared_parts(n_cf, K, E, sb, C, crl, base,
                                          resid, static_cap=True))
    assert a == b


def test_tilemajor_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 15, SHAPE).astype(np.int16)
    rows = TH.field_rows_tilemajor(torch.from_numpy(a))
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(JH.field_rows_tilemajor(jnp.asarray(a))))
    np.testing.assert_array_equal(
        TH.rows_tilemajor_field(rows, SHAPE).numpy(), a)


def test_overflow_poisons_one_tile_only(field, K):
    """One value whose zigzag code leaves 16 bits sets all 1024 widths of
    its tile to 32 and leaves the other tiles' widths as they were."""
    v = field.copy()
    clean = TH.transform_pack_v3(torch.from_numpy(v), float(INV_Q), NL, K,
                                 E)[2]
    v[9, 130, 77] = 40.0  # tile (gx, gy) = (1, 1): superblock 3
    cw = TH.local_transform_pack_v3(torch.from_numpy(v), float(INV_Q), NL, K,
                                    E)[2]
    assert cw.shape == (4, 1024)
    assert bool((cw[3] == 32).all())
    assert torch.equal(cw[:3], clean[:3]) and int(cw[:3].max()) <= 16


@pytest.mark.parametrize("shape", [
    (8, 128, 512), (64, 256, 768), (8, 128, 1024), (8, 128), (12, 128, 512),
    (8, 64, 512), (8, 128, 96), (8, 128, 1152),
])
def test_shape_gate_matches_jax(shape):
    assert TH.v3_ok_shape(shape) == JH.v3_ok_shape(shape)
    if TH.v3_ok_shape(shape):
        assert TH._v3_geom(shape[2], E) == JH._v3_geom(shape[2], E)


@pytest.fixture
def fresh_k_caches(monkeypatch):
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_K_CACHE", {})
    return monkeypatch


@pytest.mark.parametrize("padded", [SHAPE, (768, 768, 768)])
def test_v3_params_reads_both_cache_keys(fresh_k_caches, padded):
    """K comes from an explicit bfp_base_planes, else from the sticky cache
    under v3's chunk size C = Z/32 or under the flag-1 serializer's (768:
    24 against 8); the JAX package answers the same."""
    cfg, jcfg = M.Config(), mgard_tpu.Config()
    n_cf = int(np.prod(padded))
    C = padded[2] // 32
    C2 = THL._pick_v2_chunk(padded, cfg)
    assert C2 == JHL._pick_v2_chunk(padded, jcfg)
    assert THL._v3_params(cfg, padded) == JHL._v3_params(jcfg, padded) \
        == (None, E, C)
    for key, K_ in ((("v2", n_cf, E, C2, 0), 6), (("v2", n_cf, E, C, 0), 5)):
        TB._K_CACHE[key] = JB._K_CACHE[key] = (K_, None)
        assert THL._v3_params(cfg, padded) == JHL._v3_params(jcfg, padded) \
            == (K_, E, C)
    cfg.bfp_base_planes = jcfg.bfp_base_planes = 7
    assert THL._v3_params(cfg, padded) == JHL._v3_params(jcfg, padded) \
        == (7, E, C)


def test_hybrid_v3_ok_gate(fresh_k_caches):
    cfg = M.Config()
    cfg.bfp_base_planes = 5
    assert not THL._hybrid_v3_ok(SMALL, np.float32, cfg)  # not asked for
    cfg.hybrid_fused_pack = True
    assert THL._hybrid_v3_ok(SMALL, np.float32, cfg)
    assert not THL._hybrid_v3_ok(SMALL, np.float64, cfg)  # float32 kernels
    assert not THL._hybrid_v3_ok((16, 64, 256), np.float32, cfg)  # Y % 128
    for field_, bad in (("bfp_chunk", 4), ("bfp_sb_blocks", 8192),
                        ("bfp_base_planes", 9), ("bfp_resid_planes", 12),
                        ("hybrid_level_grouping", False),
                        ("lossless", M.lossless_type.BFX)):
        c2 = M.Config(**{**cfg.__dict__, field_: bad})
        assert not THL._hybrid_v3_ok(SMALL, np.float32, c2), field_
    cfg.bfp_base_planes = 0
    assert not THL._hybrid_v3_ok(SMALL, np.float32, cfg)  # no K known yet
    TB._K_CACHE[("v2", int(np.prod(SMALL)), E, 8, 0)] = (5, None)
    assert THL._hybrid_v3_ok(SMALL, np.float32, cfg)


def _flag(blob):
    _m, off = Metadata.deserialize(blob)
    return blob[off + 8 + len(THL._EMPTY_OUTLIERS)]


def _fused_blob(tol=1e-3):
    v = _field(SMALL, seed=9)
    cfg = M.Config()
    cfg.hybrid_fused_pack = True
    cfg.bfp_base_planes = 6
    blob, st = M.compress(v, tol, config=cfg, device="cpu")
    assert st == M.compress_status_type.Success and _flag(blob) == 2
    return v, blob


def test_wire_minor_is_one_only_for_flag2(fresh_k_caches):
    """A stream stamps file minor 1 only when a flag-2 section was written,
    so readers of minor 0 go on parsing flag-0 and flag-1 streams."""
    v, blob = _fused_blob()
    body = len(MAGIC) + 8
    assert blob[body + 4] == 1
    plain, st = M.compress(v, 1e-3, device="cpu")
    assert st == 0 and _flag(plain) == 1 and plain[body + 4] == 0
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and float((out - torch.from_numpy(v)).abs().max()) <= 1e-3


@pytest.mark.parametrize("what", ["sb", "C", "E"])
def test_bad_flag2_geometry_fails_cleanly(fresh_k_caches, what):
    """A flag-2 stream whose BFP5 header does not fit the tile = superblock
    scheme decodes to Failure, never to a crash or a wrong field."""
    _, blob = _fused_blob()
    i = blob.index(b"BFP5")
    bad = bytearray(blob)
    # header: magic4 n8 words8 K1 E1 sb4 C1 cnt8
    if what == "sb":
        struct.pack_into("<I", bad, i + 22, 16384)
    elif what == "C":
        bad[i + 26] = 4
    else:
        bad[i + 21] = 12  # K + E = 18
    out, st = M.decompress(bytes(bad), device="cpu")
    assert out is None and st == M.compress_status_type.Failure


def test_wrappers_raise_on_bad_input():
    v = torch.zeros(SMALL)
    with pytest.raises(ValueError, match="flag-2 gate"):
        TH.local_transform_pack_v3(torch.zeros((16, 64, 256)), 1.0, 3, 5, 8)
    with pytest.raises(ValueError, match="K \\+ E"):
        TH.local_transform_pack_v3(v, 1.0, 3, 9, 8)
    with pytest.raises(ValueError, match="base plane"):
        TH.local_transform_pack_v3(v, 1.0, 3, 0, 8)
    with pytest.raises(TypeError):
        TH.local_transform_pack_v3(v.double(), 1.0, 3, 5, 8)
    with pytest.raises(ValueError, match="no kernel"):
        TH.local_transform_pack_v3(torch.empty(SMALL, device="meta"), 1.0, 3,
                                   5, 8)
    NSB, C, CAP = 2, 8, 8 * 64
    base = torch.zeros((NSB, 5, C, 1024), dtype=torch.int32)
    crl = torch.zeros((NSB, 1024), dtype=torch.int32)
    resid = torch.zeros((NSB * CAP, 128), dtype=torch.int32)
    rem = torch.zeros(TH.remainder_shape(SMALL, 3))
    with pytest.raises(ValueError):
        TH.unpack_inverse_v3(base, crl, resid[:-1], rem, 1.0, 3, 5, 8, SMALL)
    with pytest.raises(TypeError):
        TH.unpack_inverse_v3(base, crl.long(), resid, rem, 1.0, 3, 5, 8,
                             SMALL)
    out = TH.unpack_inverse_v3(base, crl, resid, rem, 1.0, 3, 5, 8, SMALL)
    assert tuple(out.shape) == SMALL and float(out.abs().max()) == 0.0
