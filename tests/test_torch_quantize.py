"""PyTorch port, the levelwise quantizer: ``ops/quantize.py`` against
``mgard_tpu.ops.quantize`` on the same NumPy inputs.

Integer products must match bit for bit: equal coefficients give equal
symbols, because the per-level factors are computed in the same type and
order (float64 on the host, cast to the field's type) and the multiply and
the round-half-away are single IEEE operations. The dequantized values are
one more multiply and equal too, but for float64 at finite s: there XLA
rewrites sym * (q / vol) under jit (the division is in float64 only in that
case), so the products agree to one unit in the last place (relative 4.5e-16
at most)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.dtypes import decomposition_type as JD, error_bound_type as JE
from mgard_tpu.hierarchy import get_hierarchy as j_hier
from mgard_tpu.ops import quantize as JQ
from mgard_tpu_torch.hierarchy import get_hierarchy as t_hier
from mgard_tpu_torch.ops import quantize as TQ

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

SHAPES = [(65,), (20, 21), (17, 18, 19), (5, 6, 7, 8)]


def _dec(shape, dtype, seed):
    """Coefficient-like values: a few large ones, many near rounding
    edges (k + 0.5 steps) so a wrong rounding rule would show."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 1, shape)
    return v.astype(dtype)


def _assert_dequantized(got, want, dtype, s_inf):
    rtol = 4.5e-16 if dtype == np.float64 and not s_inf else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def _quantizers(hier, tol, s):
    return hier.quantizers(tol, s, 0.0, JE.ABS, JD.MultiDim, not math.isinf(s))


@pytest.mark.parametrize("shape", SHAPES)
def test_node_levels_equal(shape):
    jh, th = j_hier(shape, np.float32), t_hier(shape, np.float32)
    np.testing.assert_array_equal(TQ.node_levels(th).numpy(),
                                  np.asarray(JQ.node_levels(jh)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s", [math.inf, 0.0, -1.0, 1.5])
@pytest.mark.parametrize("reciprocal", [True, False])
def test_scales_bit_equal(dtype, s, reciprocal):
    shape = (17, 18, 19)
    jh, th = j_hier(shape, dtype), t_hier(shape, dtype)
    q = _quantizers(th, 1e-3, s)
    np.testing.assert_array_equal(q, _quantizers(jh, 1e-3, s))
    want = np.asarray(JQ._scales(jh, jnp.asarray(q), math.isinf(s),
                                 reciprocal, dtype))
    got = TQ._scales(th, q, math.isinf(s), reciprocal, dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s", [math.inf, 0.0, -1.0])
def test_quantize_symbols_bit_equal(shape, dtype, s):
    jh, th = j_hier(shape, dtype), t_hier(shape, dtype)
    s_inf = math.isinf(s)
    q = _quantizers(th, 1e-3, s)
    dec = _dec(shape, dtype, len(shape))
    # exact rounding edges: (k + 0.5) * step, both signs
    step = q[0] if s_inf else q[-1] / th.vol_sqrt[-1]
    dec.reshape(-1)[:8] = (np.arange(-4, 4) + 0.5) * step
    want = np.asarray(jax.jit(
        lambda d, qq: JQ.quantize_symbols(d, jh, qq, s_inf))(dec,
                                                             jnp.asarray(q)))
    got = TQ.quantize_symbols(torch.from_numpy(dec), th, q, s_inf)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    back = TQ.dequantize_symbols(got.reshape(-1), th, q, s_inf)
    jback = np.asarray(jax.jit(
        lambda y, qq: JQ.dequantize_symbols(y, jh, qq, s_inf))(
            want.reshape(-1), jnp.asarray(q)))
    assert back.dtype == torch.from_numpy(dec).dtype
    _assert_dequantized(back.numpy(), jback, dtype, s_inf)
    # the quantization error stays within half a step of each node's level
    lv = TQ.node_levels(th).numpy()
    half = 0.5 * (np.full(lv.shape, q[0]) if s_inf
                  else (q / th.vol_sqrt)[lv])
    assert np.all(np.abs(back.numpy() - dec) <= half * (1 + 1e-5))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s", [math.inf, 0.0])
def test_step_mult_bit_equal(dtype, s):
    """The region-of-interest multiplier (finer steps where it is > 1)."""
    shape = (17, 18, 19)
    jh, th = j_hier(shape, dtype), t_hier(shape, dtype)
    s_inf = math.isinf(s)
    q = _quantizers(th, 1e-2, s)
    dec = _dec(shape, dtype, 9)
    rng = np.random.default_rng(1)
    mult = np.where(rng.random(shape) < 0.3, 16.0, 1.0)
    want = np.asarray(jax.jit(lambda d, qq, m: JQ.quantize_symbols(
        d, jh, qq, s_inf, step_mult=m))(dec, jnp.asarray(q),
                                        jnp.asarray(mult)))
    got = TQ.quantize_symbols(torch.from_numpy(dec), th, q, s_inf,
                              step_mult=mult)
    np.testing.assert_array_equal(got.numpy(), want)
    jback = np.asarray(jax.jit(lambda y, qq, m: JQ.dequantize_symbols(
        y, jh, qq, s_inf, step_mult=m))(want.reshape(-1), jnp.asarray(q),
                                        jnp.asarray(mult)))
    back = TQ.dequantize_symbols(got.reshape(-1), th, q, s_inf,
                                 step_mult=mult)
    _assert_dequantized(back.numpy(), jback, dtype, s_inf)


def test_rounds_half_away_from_zero():
    th = t_hier((9,), np.float32)
    q = np.full(th.l_target + 1, 1.0)
    dec = torch.tensor([-2.5, -1.5, -0.5, -0.49, 0.0, 0.49, 0.5, 1.5, 2.5])
    got = TQ.quantize_symbols(dec, th, q, True)
    assert got.tolist() == [-3, -2, -1, 0, 0, 0, 1, 2, 3]
