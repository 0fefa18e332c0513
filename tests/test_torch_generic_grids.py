"""PyTorch port, the generic compress surface against ``mgard_tpu``:
non-uniform grids (``coords=``), the SingleDim decomposition and shape
adjustment, on the same NumPy inputs, under the contract of
test_torch_generic.py (whose helpers this file uses)."""

import numpy as np
import pytest
import torch

import mgard_tpu as J
import mgard_tpu_torch as M
from mgard_tpu_torch import highlevel as THL
from test_torch_generic import DT, INF, both, smooth, stretched

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


@pytest.mark.parametrize("shape,dtype", [((33, 21), np.float32),
                                         ((9, 10, 11, 8), np.float64),
                                         ((17, 18, 19), np.float32)])
@pytest.mark.parametrize("s", [INF, 0.0])
def test_nonuniform_matches_jax(shape, dtype, s):
    coords = stretched(shape)
    v = smooth(shape, dtype, seed=4)
    _, _, meta = both(v, 1e-3, s, coords=coords)
    assert meta.dstype == \
        M.highlevel.data_structure_type.Cartesian_Grid_Non_Uniform
    for a, b in zip(meta.coords, coords):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(17, 18, 19), (9, 10, 11, 12), (40, 40)])
@pytest.mark.parametrize("s", [INF, 0.0])
def test_single_dim_matches_jax(shape, s):
    v = smooth(shape, np.float32, seed=6)
    _, _, meta = both(v, 1e-2, s, decomposition=J.decomposition_type.SingleDim)
    assert meta.decomposition == DT.SingleDim


@pytest.mark.parametrize("shape", [(30, 61, 7), (30, 30), (100,)])
def test_adjust_shape_matches_jax(shape):
    from mgard_tpu.highlevel import adjust_shape as j_adjust

    assert M.adjust_shape(shape) == j_adjust(shape)
    v = smooth(shape, np.float32, seed=8)
    _, _, meta = both(v, 1e-2, adjust_shape=True)
    assert meta.adjusted == (M.adjust_shape(shape) != shape)
    assert tuple(meta.shape) == shape


def test_adjust_shape_rule():
    from mgard_tpu.highlevel import adjust_shape as j_adjust

    for shape in [(3,), (4, 5), (30, 61, 7), (31, 33, 34), (100, 129, 130),
                  (1000, 1025), (5, 6, 7, 8, 9)]:
        assert M.adjust_shape(shape) == j_adjust(shape)
    assert THL.infer_orthogonal_projection(0.0) and \
        not THL.infer_orthogonal_projection(INF)
