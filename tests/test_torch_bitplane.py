"""PyTorch port, MDR bitplane level functions: the plain version of kernel
K9 (``encode_core_plain``, which every CPU tensor takes) against
``mgard_tpu.mdr.bitplane`` — its XLA path and its Pallas kernel in
interpret mode — on the same NumPy inputs, plus the float64 branch,
NegaBinary and decode.

Contract and tolerances:
- planes, exp and err_max are equal (integer work, and a max is
  order-free);
- float32-path err_sq within relative 1e-6: the two packages group the
  float32 square sums differently (the JAX paths 128 contiguous terms or 32
  rows x 16 lane chunks; the port 32 rows x 32 columns), each stage at most
  ~1e-7 relative;
- float64-path tables: the JAX package's scale jnp.exp2(k) is off by an ulp
  at some integers k on the CPU, and v - rec cancels about B-1 bits, so the
  tables agree to relative 2^(B-1) * 2^-50; the port's own tables are held
  exactly against a NumPy oracle with exact powers of two;
- float64 decode within relative 1e-15 (the same scale ulp).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from mgard_tpu.mdr import bitplane as J
from mgard_tpu_torch import kernels
from mgard_tpu_torch.mdr import bitplane as T

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

M_SMALL = 4096  # (32, 4096): two K9 tiles
M_LARGE = 65536 + 2048  # (32, 67584): 33 tiles


def _level(n, seed=0, dtype=np.float32):
    """A level of mixed magnitudes with signed zeros, the smallest normal,
    subnormals and large values among them."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-4, 3, n)
    v[:10] = [0.0, -0.0, 1e-38, -1e-38, 1e-45, -3e-41, 2.5, -7.75, 90.0,
              -91.5]
    return v.astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


def _jax_pallas(v, B):
    """K9 on the JAX side, as encode_kernel runs it on a TPU."""
    m = v.shape[0] // 32
    x = jnp.asarray(v)
    exp = J._level_exp(jnp.max(jnp.abs(x)).astype(jnp.float64))
    zt, ep, sp = J._encode_pallas_f32(x.reshape(32, m), exp, B)
    em = np.max(np.asarray(ep)[:, :B + 1, :], axis=(0, 2)).astype(np.float64)
    es = np.sum(np.asarray(sp)[:, :B + 1, :].astype(np.float64), axis=(0, 2))
    return (J._sm_planes_from_zt(zt, B), exp, em * J._F32_SLACK,
            es * J._F32_SLACK_SQ)


@pytest.mark.parametrize("m,B", [(M_SMALL, 8), (M_SMALL, 16), (M_SMALL, 24),
                                 (M_SMALL, 32), (M_LARGE, 32)])
@pytest.mark.parametrize("core", ["xla", "pallas_interpret"])
def test_k9_plain_matches_jax_cores(core, m, B, request):
    """The port's K9 path (plain version on the CPU) against both JAX K9
    routes at the kernel geometry: planes bit-equal, exp equal, err_max
    equal, err_sq within relative 1e-6."""
    v = _level(32 * m, seed=B)
    assert T._use_kernel(v.shape[0], torch.float32, B)
    if core == "pallas_interpret":
        request.getfixturevalue("pallas_interpret")
        jp, je, jm, js = _jax_pallas(v, B)
    else:
        jp, je, jm, js = J.encode_kernel(jnp.asarray(v), B)
    kernels.reset_launches()
    tp, te, tm, ts = T.encode_kernel(torch.from_numpy(v), B)
    assert kernels.LAUNCHES["bitplane_encode"] == 0
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (B + 1, m)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))
    assert int(te) == int(je)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert _rel(ts.numpy(), js) <= 1e-6


def test_k9_plain_small_level_and_all_zero():
    """A level below the kernel geometry (the plain version on every
    device) and an all-zero level."""
    for v in (_level(32 * 37, seed=3), np.zeros(65536, np.float32)):
        jp, je, jm, js = J.encode_kernel(jnp.asarray(v), 16)
        tp, te, tm, ts = T.encode_kernel(torch.from_numpy(v), 16)
        np.testing.assert_array_equal(tp.numpy(),
                                      np.asarray(jp).view(np.int32))
        assert int(te) == int(je)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert _rel(ts.numpy(), js) <= 1e-6


def _exact_f64_tables(v, exp, B):
    """NumPy oracle of the float64 branch with exact powers of two."""
    scale = math.ldexp(1.0, B - 1 - exp)
    fixed = np.minimum(np.round(np.abs(v) * scale), 2 ** (B - 1) - 1)
    fixed = fixed.astype(np.int64)
    signf = np.where(v < 0, -1.0, 1.0)
    em, es = [], []
    for b in range(B + 1):
        if b == 0:
            rec = np.zeros_like(v)
        else:
            mg = fixed & (0xFFFFFFFF << (B - b))
            half = np.where((b < B) & (mg > 0), 1 << max(B - b - 1, 0), 0)
            rec = signf * (mg + half) / scale
        diff = (v - rec) * scale
        em.append(np.max(np.abs(diff)))
        es.append(np.sum(diff * diff))
    return np.array(em), np.array(es)


@pytest.mark.parametrize("B", [16, 32])
def test_float64_branch(B):
    v = _level(4096, seed=5, dtype=np.float64)
    jp, je, jm, js = J.encode_kernel(jnp.asarray(v), B)
    tp, te, tm, ts = T.encode_kernel(torch.from_numpy(v), B)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))
    assert int(te) == int(je)
    tol = 2.0 ** (B - 1 - 50)
    assert _rel(tm.numpy(), jm) <= tol and _rel(ts.numpy(), js) <= tol
    em, es = _exact_f64_tables(v, int(te), B)
    np.testing.assert_array_equal(tm.numpy(), em)
    assert _rel(ts.numpy(), es) <= 1e-12


@pytest.mark.parametrize("dtype,B", [(np.float32, 16), (np.float32, 30),
                                     (np.float64, 16), (np.float64, 32)])
def test_negabinary_matches_jax(dtype, B):
    """B <= 30 float32 takes the integer-exact path; float64 or B > 30 the
    float64 one."""
    v = _level(2048, seed=B, dtype=dtype)
    jp, je, jm, js = J.encode_kernel_negabinary(jnp.asarray(v), B)
    tp, te, tm, ts = T.encode_kernel_negabinary(torch.from_numpy(v), B)
    assert tuple(tp.shape) == (B, 64)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))
    assert int(te) == int(je)
    if dtype == np.float32 and B <= 30:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert _rel(ts.numpy(), js) <= 1e-6
    else:
        tol = 2.0 ** (B - 2 - 50)
        assert _rel(tm.numpy(), jm) <= tol and _rel(ts.numpy(), js) <= tol
    for b in (1, B // 2, B):
        a = np.asarray(J.decode_kernel_negabinary(jp, je, B, b, jnp.float32))
        t = T.decode_kernel_negabinary(tp, int(te), B, b, torch.float32)
        np.testing.assert_array_equal(t.numpy(), a)


def test_negabinary_float32_over_30_bits_rounds_exactly():
    """float32 input at B = 32 (the float64 branch): full-precision decode
    is the exactly scaled, half-even rounded value. (f32 values make many
    exact ties, which the JAX package's ulp-off scale breaks either way.)"""
    B = 32
    v = _level(4096, seed=8)
    tp, te, _, _ = T.encode_kernel_negabinary(torch.from_numpy(v), B)
    scale = math.ldexp(1.0, B - 2 - int(te))
    lim = 2 ** (B - 2) - 1
    want = np.clip(np.round(v.astype(np.float64) * scale), -lim, lim) / scale
    got = T.decode_kernel_negabinary(tp, int(te), B, B).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_bit_equal_for_every_b():
    B = 12
    v = _level(32 * M_SMALL, seed=9)
    jp, je, _, _ = J.encode_kernel(jnp.asarray(v), B)
    tp, te, _, _ = T.encode_kernel(torch.from_numpy(v), B)
    for b in range(B + 1):
        a = np.asarray(J.decode_kernel(jp, je, B, b, jnp.float32))
        t = T.decode_kernel(tp, te, B, b, torch.float32)
        np.testing.assert_array_equal(t.numpy(), a)
    for b in (1, B):
        a = np.asarray(J.decode_kernel(jp, je, B, b, jnp.float64))
        t = T.decode_kernel(tp, te, B, b, torch.float64)
        np.testing.assert_allclose(t.numpy(), a, rtol=1e-15, atol=0)


def test_level_exp_edge_values():
    """Exact ceil(log2 amax) at 0, subnormals, and every float32 power of
    two with one ulp either side. The JAX package's jnp.log2 rounds up at
    some powers of two on the CPU, so its exponent is the exact one or one
    more (one wasted bit, still a valid stream)."""
    vals = [0.0, 1e-45, 3e-41, 1e-40]
    for k in range(-149, 128):
        x = np.float32(2.0 ** k)
        vals += [x, np.nextafter(x, np.float32(np.inf)),
                 np.nextafter(x, np.float32(0))]
    a = np.array(vals, np.float32).astype(np.float64)
    exact = np.array([0 if x == 0 else
                      (lambda f, e: e - 1 if f == 0.5 else e)(*math.frexp(x))
                      for x in a])
    got = T._level_exp(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, exact)
    ref = np.array([int(J._level_exp(jnp.float64(x))) for x in a[::7]])
    assert set(np.unique(ref - exact[::7])) <= {0, 1}


# ----------------------------------------------------------------------
# Counterparts of tests/test_mdr.py's level tests (the port alone)
# ----------------------------------------------------------------------
def test_error_tables_match_actual():
    v = np.random.default_rng(2).standard_normal(512)
    B = 12
    planes, exp, err_max, err_sq, n = T.encode_level(torch.from_numpy(v), B)
    for b in [1, 3, 6, 12]:
        rec = T.decode_level(planes[: 1 + b], exp, B, b, n).numpy()
        actual = np.max(np.abs(rec - v))
        assert np.isclose(actual, float(err_max[b]), rtol=1e-12), (b, actual)


def test_bitplane_extreme_magnitudes():
    """Tables stay finite upper bounds where the physical squared errors
    (~1e61) exceed float32: the device tables are in fixed-point units and
    scale_tables converts them on the host in float64."""
    rng = np.random.default_rng(3)
    f32 = np.float32
    v = np.concatenate([rng.standard_normal(1024 - 8).astype(f32) * 7.3,
                        np.array([0, -0.0, 1e-38, -1e-38, 2, -4, 1e30, -1e30],
                                 f32)])
    for B in (16, 32):
        planes, exp, err_max, err_sq, n = T.encode_level(
            torch.from_numpy(v), B)
        assert np.isfinite(err_max).all() and np.isfinite(err_sq).all()
        for b in (B // 2, B):
            rec = T.decode_level(planes[: 1 + b], exp, B, b, n).numpy()
            d = rec - v.astype(np.float64)
            assert np.max(np.abs(d)) <= float(err_max[b]) * (1 + 1e-9)
            assert float(np.sum(d * d)) <= float(err_sq[b]) * (1 + 1e-6)


def test_int_quantize_matches_f64_oracle():
    """mag = round-half-away(|v| 2^(frac-exp)) clamped, and remi * 2^-kc ==
    p - mag exactly whenever kc < 31 (else it dominates)."""
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.standard_normal(4096)
        * 10.0 ** rng.integers(-8, 8, 4096).astype(np.float64),
        np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.0 ** -126, 65504.0]),
    ]).astype(np.float32)
    B, exp = 24, 30
    mag, remi, kc, sign = T._int_quantize_f32(torch.from_numpy(v),
                                              torch.tensor(exp, dtype=torch.int32),
                                              B - 1, 2 ** (B - 1) - 1)
    r = T._residue_f32(remi, kc).numpy().astype(np.float64)
    p = np.abs(v.astype(np.float64)) * 2.0 ** ((B - 1) - exp)
    mag_ref = np.minimum(np.floor(p + 0.5), 2 ** (B - 1) - 1)
    np.testing.assert_array_equal(mag.numpy(), mag_ref.astype(np.int32))
    np.testing.assert_array_equal(sign.numpy() == 1, np.signbit(v))
    exact = kc.numpy() < 31
    np.testing.assert_array_equal(r[exact], (p - mag_ref)[exact])
    assert np.all(np.abs(r[~exact]) >= np.abs(p - mag_ref)[~exact] - 1e-30)


def test_decode_tiny_exponent_f32_no_underflow():
    """A level with amax near 2^-120 at B = 32 decodes in float32 (the
    scale 2^(exp-31) is below the float32 range; the exponent-field scaling
    never forms it)."""
    v = (np.random.default_rng(11).standard_normal(256) * 2.0 ** -120)
    B = 32
    for nb in (False, True):
        enc = T.encode_kernel_negabinary if nb else T.encode_kernel
        dec = T.decode_kernel_negabinary if nb else T.decode_kernel
        planes, exp, _, _ = enc(T.pad_stream(torch.from_numpy(v)), B)
        rows = planes[: B if nb else 1 + B]
        rec32 = dec(rows, exp, B, B, torch.float32).numpy()[:256]
        rec64 = dec(rows, exp, B, B, torch.float64).numpy()[:256]
        assert np.any(rec32 != 0.0), nb
        np.testing.assert_allclose(rec32, rec64, rtol=1e-6, atol=2.0 ** -126)
        assert np.max(np.abs(rec64 - v)) <= 2.0 ** (int(exp) - B + 2)


# ----------------------------------------------------------------------
# The K9 wrapper
# ----------------------------------------------------------------------
def test_k9_wrapper_takes_plain_path_on_cpu_and_checks_input():
    v = torch.from_numpy(_level(32 * 2048)).reshape(32, 2048)
    exp = torch.tensor(7, dtype=torch.int32)
    kernels.reset_launches()
    got = T.encode_core(v, exp, 32)
    ref = T.encode_core_plain(v, exp, 32)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert kernels.LAUNCHES["bitplane_encode"] == 0
    assert tuple(got[1].shape) == (64, 33) and tuple(got[2].shape) == (64, 33)
    with pytest.raises(ValueError):
        T.encode_core(v[:, :1024], exp, 32)  # not whole tiles
    with pytest.raises(ValueError):
        T.encode_core(v, exp, 33)
    with pytest.raises(TypeError):
        T.encode_core(v.double(), exp, 32)
    with pytest.raises(TypeError):
        T.encode_core(v, exp.long(), 32)
    with pytest.raises(ValueError):
        T.encode_core(v.t().contiguous().t(), exp, 32)
    with pytest.raises(ValueError, match="no kernel"):
        T.encode_core(torch.empty((32, 2048), device="meta"),
                      torch.empty((), dtype=torch.int32, device="meta"), 32)
