"""PyTorch port, hybrid flag-1 front end: the plain versions of K1/K4 (what
the wrappers run for CPU tensors) against the JAX XLA oracles and the
interpret-mode Pallas kernels.

Payloads: the integer stages are exact, but quantize is float: a value on
a .5 rounding boundary can flip by one symbol (zigzag delta <= 2) where one
side fuses a multiply-add, on a trace fraction (< 1e-4) of the symbols —
the same contract as tests/test_hybrid_v2.py. Widths and layout are equal;
float outputs agree to atol=1e-6 on an O(1) field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.ops import hybrid as JH
from mgard_tpu_torch.ops import hybrid as TH

NL = 3
CASES = [((16, 16, 128), 4), ((8, 128, 768), 8)]


def _field(shape):
    rng = np.random.default_rng(3)
    x = np.linspace(0, 1, shape[0], dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        * np.cos(np.linspace(0, 3, shape[1], dtype=np.float32))[None, :, None]
        + np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :] ** 2
        + 0.05 * rng.standard_normal(shape).astype(np.float32)
    )
    return v.astype(np.float32)


def _inv_q(q):
    return np.float32(1.0) / np.float32(q)


def _payload_close(pt, pj):
    a = pt.numpy().view(np.uint16).astype(np.int64)
    b = np.asarray(pj).astype(np.int64)
    assert a.shape == b.shape
    mism = a != b
    assert mism.mean() < 1e-4, mism.mean()
    assert np.abs(a - b)[mism].max(initial=0) <= 2


@pytest.mark.parametrize("shape,C", CASES)
@pytest.mark.parametrize("ref", ["xla_oracle", "pallas_interpret"])
def test_forward_matches_jax(shape, C, ref):
    v = _field(shape)
    inv_q = _inv_q(1.7e-4)
    if ref == "xla_oracle":
        pj, cwj, remj = JH.local_transform_v2_xla(jnp.asarray(v),
                                                  jnp.float32(inv_q), NL, C)
    else:
        pj, cwj, remj = JH.local_transform_fused_v2(
            jnp.asarray(v), jnp.float32(inv_q), NL, C, interpret=True)
    pt, cwt, remt = TH.local_transform_fused_v2(torch.from_numpy(v),
                                                float(inv_q), NL, C)
    assert int(cwt.max()) <= 16
    np.testing.assert_array_equal(cwt.numpy(), np.asarray(cwj))
    _payload_close(pt, pj)
    np.testing.assert_allclose(remt.numpy(), np.asarray(remj), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shape,C", CASES)
def test_inverse_matches_jax(shape, C):
    v = _field(shape)
    q = np.float32(1.7e-4)
    pj, _cw, remj = JH.local_transform_v2_xla(jnp.asarray(v),
                                              jnp.float32(_inv_q(q)), NL, C)
    outj = JH.local_inverse_v2_xla(pj, remj, jnp.float32(q), NL,
                                   jnp.float32)
    pay = torch.from_numpy(np.asarray(pj).view(np.int16).copy())
    outt = TH.local_inverse_fused_v2(pay, torch.from_numpy(np.array(remj)),
                                     float(q), NL)
    np.testing.assert_allclose(outt.numpy(), np.asarray(outj), rtol=0,
                               atol=1e-6)
    # round trip: quantization is the only loss
    assert float(np.max(np.abs(outt.numpy() - v))) <= float(q) * (NL + 2)


def test_forward_overflow_reports_wide_chunks():
    """Symbols over the u16 budget must show as cw > 16 (flag-0 path)."""
    v = _field((16, 16, 128)) * np.float32(1e6)
    _, cw, _ = TH.local_transform_fused_v2(torch.from_numpy(v),
                                           float(_inv_q(1e-6)), NL, 4)
    assert int(cw.max()) > 16


@pytest.mark.parametrize("nl", [1, 2, 3])
def test_whole_array_pieces_match_jax(nl):
    """local_decompose/recompose, remainder split/insert, corner mask and
    z-class grouping against the JAX whole-array functions."""
    v = _field((16, 8, 32))
    dj = np.array(JH.local_decompose(jnp.asarray(v), nl))
    dt = TH.local_decompose(torch.from_numpy(v), nl)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-6)
    rj = np.array(JH.extract_remainder(jnp.asarray(dj), nl))
    np.testing.assert_array_equal(
        TH.extract_remainder(torch.from_numpy(dj), nl).numpy(), rj)
    np.testing.assert_array_equal(
        TH.corner_mask(v.shape, nl).numpy(),
        np.asarray(JH.corner_mask(v.shape, nl)))
    ins = TH.insert_remainder(torch.zeros(v.shape), torch.from_numpy(rj), nl)
    np.testing.assert_array_equal(
        ins.numpy(), np.asarray(JH.insert_remainder(jnp.zeros(v.shape),
                                                    jnp.asarray(rj), nl)))
    np.testing.assert_allclose(
        TH.local_recompose(torch.from_numpy(dj), nl).numpy(),
        np.asarray(JH.local_recompose(jnp.asarray(dj), nl)),
        rtol=0, atol=1e-6)
    s = np.arange(16 * 8 * 32, dtype=np.int32).reshape(16, 8, 32)
    g = TH.zclass_group(torch.from_numpy(s))
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(JH.zclass_group(jnp.asarray(s))))
    np.testing.assert_array_equal(TH.zclass_ungroup(g).numpy(), s)


@pytest.mark.parametrize("shape,ok", [
    ((64, 64, 128), True), ((8, 128, 768), True), ((64, 64, 100), False),
    ((64, 64, 2048), False), ((16, 24, 128), False),
])
def test_flag1_shape_gate_matches_jax(shape, ok):
    assert (TH._tile_shape_v2(shape) is not None) is ok
    assert TH._tile_shape_v2(shape) == JH._tile_shape_v2(shape)
