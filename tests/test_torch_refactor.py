"""PyTorch port, multilevel transform: decompose/recompose against
mgard_tpu.ops.refactor on remainder-shaped fields, float32 in the
hierarchical basis and, at one shape, the orthogonal basis and float64.
Tolerances: atol=1e-6 on an O(1) float32 field (the matmuls sum in another
order than XLA's); 1e-12 in float64 (the JAX package takes its slice path
there, the port the dense operators: the same linear map, rounded in
another order). The orthogonal correction matrices equal the JAX package's
exactly: both probe the same NumPy oracle.

The split/lerp/merge ("slice") path for axes over 4096 and the SingleDim
transform are held against the JAX package's NumPy oracle (the same code
it jits, run eagerly on the host, as its own tests run it) and, at one
case each, against the jitted function: relative 1e-12 in float64, 1e-5 in
float32 (the tridiagonal solve is a doubling scan in the port, a
sequential sweep in the oracle, an associative scan under jit: three
rounding orders of one recurrence)."""

import jax
import numpy as np
import pytest
import torch

from mgard_tpu.hierarchy import get_hierarchy as j_hier
from mgard_tpu.ops import _be as JBE, refactor as JR
from mgard_tpu_torch.hierarchy import get_hierarchy as t_hier
from mgard_tpu_torch.ops import _be as TBE, refactor as TR

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

SHAPES = [(16, 16, 32), (32, 32, 32), (8, 32, 64)]


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    g = [np.linspace(0, 1, n, dtype=np.float32) for n in shape]
    X, Y, Z = np.meshgrid(*g, indexing="ij")
    v = np.sin(3 * X) * np.cos(2 * Y) + Z ** 2
    return (v + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_decompose_recompose_match_jax(shape):
    v = _field(shape, sum(shape))
    jh, th = j_hier(shape, np.float32), t_hier(shape, np.float32)
    jdec = np.asarray(jax.jit(lambda x: JR.decompose(x, jh, False))(v))
    tdec = TR.decompose(torch.from_numpy(v), th, orthogonal=False)
    np.testing.assert_allclose(tdec.numpy(), jdec, rtol=0, atol=1e-6)
    jrec = np.asarray(jax.jit(lambda x: JR.recompose(x, jh, False))(jdec))
    trec = TR.recompose(tdec, th, orthogonal=False)
    np.testing.assert_allclose(trec.numpy(), jrec, rtol=0, atol=1e-6)
    # round trip of the port alone
    assert float(np.max(np.abs(trec.numpy() - v))) <= 1e-6


@pytest.mark.parametrize("dtype,orthogonal", [(np.float32, True),
                                               (np.float64, False),
                                               (np.float64, True)])
def test_orthogonal_and_f64_match_jax(dtype, orthogonal):
    shape = SHAPES[0]
    v = _field(shape, 5).astype(dtype)
    jh, th = j_hier(shape, dtype), t_hier(shape, dtype)
    for l in range(1, th.l_target + 1):
        for d in range(th.D):
            np.testing.assert_array_equal(TR._corr_matrix(th, l, d),
                                          JR._corr_matrix(jh, l, d))
    atol = 1e-6 if dtype == np.float32 else 1e-12
    jdec = np.asarray(jax.jit(lambda x: JR.decompose(x, jh, orthogonal))(v))
    tdec = TR.decompose(torch.from_numpy(v), th, orthogonal=orthogonal)
    assert tdec.dtype == torch.from_numpy(v).dtype
    np.testing.assert_allclose(tdec.numpy(), jdec, rtol=0, atol=atol)
    trec = TR.recompose(tdec, th, orthogonal=orthogonal)
    jrec = np.asarray(jax.jit(lambda x: JR.recompose(x, jh, orthogonal))(
        jdec))
    np.testing.assert_allclose(trec.numpy(), jrec, rtol=0, atol=atol)
    assert float(np.max(np.abs(trec.numpy() - v))) <= atol


def _long_field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    v = sum(np.sin((5 + 3 * i) * a) for i, a in enumerate(g))
    return (v + 0.05 * rng.standard_normal(shape)).astype(dtype)


def _stretched(shape, seed):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.uniform(0.2, 1.8, n)) for n in shape]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(b))), 1e-300))


RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_linrec_scan_matches_sequential(dtype, reverse, n):
    """The doubling scan against the sequential NumPy sweep (and, through
    it, the JAX package's own NumPy branch, which is the same sweep)."""
    rng = np.random.default_rng(n)
    d = rng.standard_normal((n, 3)).astype(dtype)
    f = rng.uniform(-0.3, 0.3, (n, 1)).astype(dtype)
    want = TBE.linrec(d, f, 0, reverse)
    np.testing.assert_array_equal(want, JBE.linrec(d, f, 0, reverse))
    got = TBE.linrec(torch.from_numpy(d), torch.from_numpy(f), 0, reverse)
    assert got.dtype == torch.from_numpy(d).dtype
    assert _rel(got.numpy(), want) <= RTOL[dtype]
    # along a later axis of a 3D array
    d3 = np.ascontiguousarray(np.broadcast_to(d.T[:, None, :], (3, 2, n)))
    got3 = TBE.linrec(torch.from_numpy(d3), torch.from_numpy(f.reshape(
        1, 1, n)), 2, reverse)
    assert _rel(got3.numpy(), TBE.linrec(d3, f.reshape(1, 1, n), 2,
                                         reverse)) <= RTOL[dtype]


@pytest.mark.parametrize("shape,dtype", [((4097,), np.float64),
                                         ((4097,), np.float32),
                                         ((8193, 3), np.float32),
                                         ((8193, 3), np.float64),
                                         ((4100, 6), np.float64),
                                         # rank 4 with an axis over 4096,
                                         # as XGC's f0 takes the route
                                         ((4, 5, 4200, 5), np.float64),
                                         ((4, 5, 4200, 5), np.float32)])
@pytest.mark.parametrize("orthogonal", [False, True])
@pytest.mark.parametrize("uniform", [True, False])
def test_slice_path_matches_jax(shape, dtype, orthogonal, uniform):
    coords = None if uniform else _stretched(shape, 7)
    jh, th = j_hier(shape, dtype, coords), t_hier(shape, dtype, coords)
    assert not TR._use_fast(th)
    v = _long_field(shape, dtype, 11)
    jdec = JR.decompose(v, jh, orthogonal)  # the NumPy oracle, eager
    tdec = TR.decompose(torch.from_numpy(v), th, orthogonal)
    assert tdec.dtype == torch.from_numpy(v).dtype
    assert _rel(tdec.numpy(), jdec) <= RTOL[dtype]
    trec = TR.recompose(torch.from_numpy(np.asarray(jdec)), th, orthogonal)
    assert _rel(trec.numpy(), JR.recompose(jdec, jh, orthogonal)) <= \
        RTOL[dtype]
    assert _rel(trec.numpy(), v) <= RTOL[dtype]


def test_slice_path_matches_jitted_jax():
    """The float64 orthogonal transform of a 4097-node axis against the
    jitted JAX function (its associative-scan tridiagonal solve)."""
    shape = (4097,)
    jh, th = j_hier(shape, np.float64), t_hier(shape, np.float64)
    v = _long_field(shape, np.float64, 3)
    jdec = np.asarray(jax.jit(lambda x: JR.decompose(x, jh, True))(v))
    tdec = TR.decompose(torch.from_numpy(v), th, True)
    assert _rel(tdec.numpy(), jdec) <= 1e-12
    assert _rel(TR.recompose(tdec, th, True).numpy(), v) <= 1e-12


@pytest.mark.parametrize("shape", [(17, 18, 19), (20, 21), (65,)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("orthogonal", [False, True])
def test_single_dim_matches_jax(shape, dtype, orthogonal):
    coords = _stretched(shape, 5) if len(shape) == 2 else None
    jh, th = j_hier(shape, dtype, coords), t_hier(shape, dtype, coords)
    v = _long_field(shape, dtype, 2)
    jdec = JR.decompose_single(v, jh, orthogonal)
    tdec = TR.decompose_single(torch.from_numpy(v), th, orthogonal)
    assert _rel(tdec.numpy(), jdec) <= RTOL[dtype]
    trec = TR.recompose_single(tdec, th, orthogonal)
    assert _rel(trec.numpy(), v) <= 10 * RTOL[dtype]
    assert _rel(trec.numpy(), JR.recompose_single(jdec, jh, orthogonal)) \
        <= 10 * RTOL[dtype]
    # the reference library's own SingleDim layout (host NumPy in both)
    np.testing.assert_array_equal(TR.recompose_single_x(jdec, th),
                                  JR.recompose_single_x(jdec, jh))


def test_single_dim_matches_jitted_jax():
    shape = (17, 18, 19)
    jh, th = j_hier(shape, np.float32), t_hier(shape, np.float32)
    v = _long_field(shape, np.float32, 4)
    jdec = np.asarray(jax.jit(lambda x: JR.decompose_single(x, jh, True))(v))
    tdec = TR.decompose_single(torch.from_numpy(v), th, True)
    assert _rel(tdec.numpy(), jdec) <= 1e-5


def test_hierarchy_tables_match_on_stretched_grid():
    """The port's copy of the hierarchy carries the coordinates into the
    same tables as the JAX package's."""
    shape = (17, 18, 20)
    coords = _stretched(shape, 9)
    for dtype in (np.float32, np.float64):
        jh, th = j_hier(shape, dtype, coords), t_hier(shape, dtype, coords)
        assert jh.level_shape == th.level_shape and not th.uniform
        np.testing.assert_array_equal(jh.vol_sqrt, th.vol_sqrt)
        for jrow, trow in zip(jh.axis, th.axis):
            for ja, ta in zip(jrow, trow):
                for name in ("lerp_t", "h_ext", "rw_left", "rw_right",
                             "fwd_f", "bwd_binv", "bwd_g"):
                    np.testing.assert_array_equal(getattr(ja, name),
                                                  getattr(ta, name))


@pytest.mark.parametrize("dtype,orthogonal", [(np.float32, False),
                                               (np.float64, True)])
def test_dense_path_on_stretched_grid_matches_jax(dtype, orthogonal):
    shape = (17, 18, 20)
    coords = _stretched(shape, 9)
    jh, th = j_hier(shape, dtype, coords), t_hier(shape, dtype, coords)
    assert TR._use_fast(th)
    v = _long_field(shape, dtype, 6)
    jdec = JR.decompose(v, jh, orthogonal)
    tdec = TR.decompose(torch.from_numpy(v), th, orthogonal)
    assert _rel(tdec.numpy(), jdec) <= RTOL[dtype]
    assert _rel(TR.recompose(tdec, th, orthogonal).numpy(), v) <= RTOL[dtype]


def test_outside_slice_raises():
    """An axis over 4096 takes the split/lerp/merge path (it raised before
    that path was ported); a field whose type differs from its hierarchy's
    is still refused."""
    th = t_hier((4100, 2), np.float32)
    assert not TR._use_fast(th)
    v = torch.from_numpy(_long_field((4100, 2), np.float32, 1))
    back = TR.recompose(TR.decompose(v, th, orthogonal=False), th, False)
    assert float((back - v).abs().max()) <= 1e-6
    th = t_hier((16, 16, 32), np.float32)
    with pytest.raises(TypeError):
        TR.decompose(torch.zeros((16, 16, 32), dtype=torch.float64), th)
