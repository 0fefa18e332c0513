"""PyTorch port, hybrid flag-0 front end: the plain versions of K7/K8 (what
the wrappers run for CPU tensors) against the JAX package's fused Pallas
kernels in interpret mode, where the JAX gate ``_tile_shape`` admits the
shape, and against its unfused XLA branch (``_compress_core_hybrid`` /
``_decompress_core_hybrid`` with fused=False) for every shape, including
shapes the TPU gate refuses but the card's kernels take.

Symbols: quantize is float, so a value on a .5 rounding boundary can flip
by one where one side fuses a multiply-add, on a trace fraction (< 1e-4)
of the positions — the contract of tests/test_torch_hybrid_v2.py. The
remainder and the inverse's output agree to atol=1e-6 on an O(1) field."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.ops import hybrid as JH
from mgard_tpu_torch.ops import hybrid as TH

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

Q = np.float32(1.7e-4)
INV_Q = np.float32(1.0) / Q

# (shape, admitted by the JAX gate)
SHAPES = [((64, 256), True), ((16, 16, 128), True), ((64, 200), False),
          ((24, 40, 56), False)]


def _field(shape, seed=3):
    rng = np.random.default_rng(seed)
    v = 0.05 * rng.standard_normal(shape).astype(np.float32)
    for d, n in enumerate(shape):
        ax = np.linspace(-1, 1, n, dtype=np.float32) * (d + 1)
        v += np.sin(ax).reshape((1,) * d + (n,) + (1,) * (len(shape) - d - 1))
    return v.astype(np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    real = JH.pl.pallas_call
    monkeypatch.setattr(JH.pl, "pallas_call",
                        functools.partial(real, interpret=True))


def _jax_unfused(v, nl):
    """The fused=False branch of mgard_tpu.highlevel._compress_core_hybrid
    without the remainder transform: (symbols, remainder)."""
    dec = JH.local_decompose(jnp.asarray(v), nl)
    rem = JH.extract_remainder(dec, nl)
    cf = jnp.where(JH.corner_mask(dec.shape, nl), jnp.float32(0), dec)
    t = cf * jnp.float32(INV_Q)
    sym = jnp.trunc(jnp.where(t < 0, t - 0.5, t + 0.5)).astype(jnp.int32)
    return np.array(sym), np.array(rem)


def _symbols_close(st, sj):
    a = st.numpy().astype(np.int64)
    b = np.asarray(sj).astype(np.int64)
    assert a.shape == b.shape
    mism = a != b
    assert mism.mean() < 1e-4, mism.mean()
    assert np.abs(a - b)[mism].max(initial=0) <= 1


@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("shape,gated", SHAPES)
def test_forward_matches_jax(shape, gated, nl, request):
    v = _field(shape)
    st, rt = TH.local_transform_fused(torch.from_numpy(v), float(INV_Q), nl)
    assert st.dtype == torch.int32 and rt.dtype == torch.float32
    assert tuple(rt.shape) == TH.remainder_shape(shape, nl)
    refs = [_jax_unfused(v, nl)]
    if gated:
        request.getfixturevalue("pallas_interpret")
        refs.append(JH.local_transform_fused(jnp.asarray(v),
                                             jnp.float32(INV_Q), nl))
    for sj, rj in refs:
        _symbols_close(st, sj)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("nl", [1, 3])
@pytest.mark.parametrize("shape,gated", SHAPES)
def test_inverse_matches_jax(shape, gated, nl, request):
    v = _field(shape)
    sj, rj = _jax_unfused(v, nl)
    out = TH.local_inverse_fused(torch.from_numpy(sj), torch.from_numpy(rj),
                                 float(Q), nl)
    cf = jnp.asarray(sj).astype(jnp.float32) * jnp.float32(Q)
    refs = [JH.local_recompose(JH.insert_remainder(cf, jnp.asarray(rj), nl),
                               nl)]
    if gated:
        request.getfixturevalue("pallas_interpret")
        refs.append(JH.local_inverse_fused(jnp.asarray(sj), jnp.asarray(rj),
                                           jnp.float32(Q), nl, jnp.float32))
    for oj in refs:
        np.testing.assert_allclose(out.numpy(), np.asarray(oj), rtol=0,
                                   atol=1e-6)
    # round trip: quantization is the only loss
    assert float(np.max(np.abs(out.numpy() - v))) <= float(Q) * (nl + 2)


def test_flag1_plain_versions_build_on_flag0():
    """K1's plain version is K7's plus zigzag, grouping and chunk widths;
    K4's is K8's after the un-zigzag and ungrouping."""
    v = torch.from_numpy(_field((16, 16, 128)))
    sym, rem = TH.local_transform(v, float(INV_Q), 3)
    pay, _cw, rem2 = TH.local_transform_v2(v, float(INV_Q), 3, 4)
    zz = TH.zclass_group((sym << 1) ^ (sym >> 31))
    assert torch.equal(pay, (zz & 0xFFFF).to(torch.int16))
    assert torch.equal(rem, rem2)
    assert torch.equal(TH.local_inverse_v2(pay, rem, float(Q), 3),
                       TH.local_inverse(sym, rem, float(Q), 3))


@pytest.mark.parametrize("shape", [
    (64, 256), (16, 16, 128), (8, 1024, 1024), (64, 200), (24, 40, 56),
    (8, 8, 8, 128), (128,), (16, 24, 128)])
def test_fused_shape_gate_matches_jax(shape):
    assert TH._tile_shape(shape) == JH._tile_shape(shape)
