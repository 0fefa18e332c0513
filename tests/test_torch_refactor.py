"""PyTorch port, multilevel transform: decompose/recompose against
mgard_tpu.ops.refactor on remainder-shaped fields, float32 in the
hierarchical basis and, at one shape, the orthogonal basis and float64.
Tolerances: atol=1e-6 on an O(1) float32 field (the matmuls sum in another
order than XLA's); 1e-12 in float64 (the JAX package takes its slice path
there, the port the dense operators: the same linear map, rounded in
another order). The orthogonal correction matrices equal the JAX package's
exactly: both probe the same NumPy oracle."""

import jax
import numpy as np
import pytest
import torch

from mgard_tpu.hierarchy import get_hierarchy as j_hier
from mgard_tpu.ops import refactor as JR
from mgard_tpu_torch.hierarchy import get_hierarchy as t_hier
from mgard_tpu_torch.ops import refactor as TR

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


def test_outside_slice_raises():
    """Axes over 4096 wait for ROADMAP item 9; a field whose type differs
    from its hierarchy's is refused."""
    th = t_hier((4100, 2), np.float32)
    with pytest.raises(NotImplementedError, match="item 9"):
        TR.decompose(torch.zeros((4100, 2)), th, orthogonal=False)
    th = t_hier((16, 16, 32), np.float32)
    with pytest.raises(TypeError):
        TR.decompose(torch.zeros((16, 16, 32), dtype=torch.float64), th)
