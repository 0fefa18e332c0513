"""PyTorch port, the fused front end (``hybrid_fused_pack``, flag-2
streams) and the sticky base-plane count through the public API on the
CPU, each stream decoded by both packages within the tolerance; helpers
from test_torch_highlevel.py. FUSED_SHAPE is tests/test_hybrid_v3.py's
public-API shape."""

import numpy as np
import pytest
import torch

import mgard_tpu
import mgard_tpu.highlevel as JHL
import mgard_tpu_torch as M
from mgard_tpu.ops import hybrid as JH
from mgard_tpu_torch.formats.metadata import Metadata
from mgard_tpu_torch.lossless import bfp as TB
from test_torch_highlevel import (_err, _field, _flag, _minor,
                                  bfp_small, fresh_k_caches)

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


def test_stale_sticky_K_rechoose(bfp_small):
    """A coarser then a finer tolerance on one shape keeps flag 1: the
    serializer re-chooses K from the fresh widths and refreshes the cache
    (the port's counterpart of the JAX test of the same name)."""
    shape = (16, 128, 256)
    v = _field(shape)
    key = ("v2", int(np.prod(shape)), 8, 8, 0)
    b1, s1 = M.compress(v, 1e-2, device="cpu")
    assert s1 == 0 and key in TB._K_CACHE
    K1 = TB._K_CACHE[key][0]
    b2, s2 = M.compress(v, 1e-4, device="cpu")
    assert s2 == 0
    K2 = TB._K_CACHE[key][0]
    assert K2 > K1, (K1, K2)
    for blob, tol in ((b1, 1e-2), (b2, 1e-4)):
        assert _flag(blob) == 1
        out, st = M.decompress(blob, device="cpu")
        assert st == 0 and _err(out, v) <= tol
        outj, stj = mgard_tpu.decompress(blob)
        assert int(stj) == 0 and _err(outj, v) <= tol


FUSED_SHAPE = (16, 128, 256)


def _fused_cfg(K=0):
    cfg = M.Config()
    cfg.hybrid_fused_pack = True
    cfg.bfp_base_planes = K
    return cfg


def _jax_flag2(monkeypatch):
    """Let the JAX package write flag-2 streams on the CPU, its XLA oracle
    standing in for the TPU kernel (as tests/test_hybrid_v3.py does)."""
    monkeypatch.setattr(JHL, "_hybrid_v3_ok", lambda *a, **k: True)
    monkeypatch.setattr(JH, "local_transform_pack_v3",
                        lambda v, iq, nl, K, E:
                        JH.transform_pack_v3_xla(v, iq, nl, K, E))


def test_flag2_streams_cross_decode(fresh_k_caches):
    """hybrid_fused_pack with a pinned base-plane count: each package
    writes a flag-2 stream (file minor 1) that both decode within tol, with
    the same header bytes and the same length."""
    v = _field(FUSED_SHAPE, seed=9)
    tol, K = 1e-3, 6
    blob, st = M.compress(v, tol, config=_fused_cfg(K), device="cpu")
    assert st == M.compress_status_type.Success and _flag(blob) == 2
    assert _minor(blob) == 1
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and _err(out, v) <= tol
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol
    assert float(np.max(np.abs(out.numpy() - np.asarray(outj)))) <= 1e-5
    _jax_flag2(fresh_k_caches)
    jcfg = mgard_tpu.Config()
    jcfg.hybrid_fused_pack = True
    jcfg.bfp_base_planes = K
    jblob, st3 = mgard_tpu.compress(v, tol=tol, config=jcfg)
    assert int(st3) == 0 and _flag(jblob) == 2
    out2, st4 = M.decompress(jblob, device="cpu")
    assert st4 == 0 and _err(out2, v) <= tol
    hj = Metadata.deserialize(jblob)[1]
    assert blob[:hj] == jblob[:hj] and len(blob) == len(jblob)


def test_first_stream_primes_then_fuses(fresh_k_caches):
    """No K pinned: the first stream of a shape rides flag 1 and fills the
    sticky cache, the second one fuses (flag 2) with that K and has the
    same bytes but for the chunk order."""
    v = _field(FUSED_SHAPE)
    cfg = _fused_cfg()
    b1, s1 = M.compress(v, 1e-3, config=cfg, device="cpu")
    key = ("v2", int(np.prod(FUSED_SHAPE)), 8, 8, 0)
    assert s1 == 0 and _flag(b1) == 1 and key in TB._K_CACHE
    b2, s2 = M.compress(v, 1e-3, config=cfg, device="cpu")
    assert s2 == 0 and _flag(b2) == 2 and len(b2) == len(b1)
    for blob in (b1, b2):
        out, st = M.decompress(blob, device="cpu")
        assert st == 0 and _err(out, v) <= 1e-3
        outj, stj = mgard_tpu.decompress(blob)
        assert int(stj) == 0 and _err(outj, v) <= 1e-3


def test_fused_stale_K_falls_back_to_flag1_and_refreshes(fresh_k_caches):
    """A tighter tolerance on a primed shape: the planes packed with the
    stale K are dropped, the flag-1 serializer re-chooses K and refreshes
    the cache, and the next stream fuses again with the new K."""
    v = _field(FUSED_SHAPE)
    cfg = _fused_cfg()
    key = ("v2", int(np.prod(FUSED_SHAPE)), 8, 8, 0)
    M.compress(v, 1e-2, config=cfg, device="cpu")
    K1 = TB._K_CACHE[key][0]
    b2, s2 = M.compress(v, 1e-4, config=cfg, device="cpu")
    K2 = TB._K_CACHE[key][0]
    assert s2 == 0 and _flag(b2) == 1 and K2 > K1
    b3, s3 = M.compress(v, 1e-4, config=cfg, device="cpu")
    assert s3 == 0 and _flag(b3) == 2 and TB._K_CACHE[key][0] == K2
    for blob in (b2, b3):
        out, st = M.decompress(blob, device="cpu")
        assert st == 0 and _err(out, v) <= 1e-4
        outj, stj = mgard_tpu.decompress(blob)
        assert int(stj) == 0 and _err(outj, v) <= 1e-4


@pytest.mark.parametrize("K", [0, 6])
def test_fused_overflow_falls_back_to_flag0(fresh_k_caches, K):
    """One value whose code leaves 16 bits: the fused front end reports its
    tile's widths as 32 and the stream is written as flag 0 (file minor 0),
    from a primed cache and from a pinned K alike; both packages decode
    it."""
    v = _field(FUSED_SHAPE)
    cfg = _fused_cfg(K)
    if not K:
        M.compress(v, 1e-3, config=cfg, device="cpu")
    v[3, 5, 7] = 1e4
    blob, st = M.compress(v, 1e-3, config=cfg, device="cpu")
    assert st == 0 and _flag(blob) == 0
    assert _minor(blob) == 0
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and _err(out, v) <= 1e-3
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= 1e-3
