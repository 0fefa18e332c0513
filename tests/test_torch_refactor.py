"""PyTorch port, multilevel transform: decompose/recompose (float32,
hierarchical basis) against mgard_tpu.ops.refactor on remainder-shaped
fields. Tolerance atol=1e-6 on an O(1) field: the matmuls sum in another
order than XLA's."""

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


def test_outside_slice_raises():
    th = t_hier((16, 16, 32), np.float32)
    v = torch.zeros((16, 16, 32))
    with pytest.raises(NotImplementedError, match="item 9"):
        TR.decompose(v, th, orthogonal=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        TR.decompose(v.double(), th, orthogonal=False)
