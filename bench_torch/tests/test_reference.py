"""The plain reference against the program at small sizes on the CPU."""

import numpy as np
import pytest
import torch

import reference
from mgard_tpu_torch.hierarchy import get_hierarchy
from mgard_tpu_torch.ops.refactor import decompose, recompose


@pytest.mark.parametrize("shape", [(17, 17, 17), (16, 18, 20), (12, 9)])
def test_multilevel_matches_the_program(shape):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(shape, generator=g, dtype=torch.float64)
    coeffs, levels = reference.decompose(x)
    hier = get_hierarchy(shape, np.float64)
    assert reference.num_levels(shape) == hier.l_target
    # the program's nested-box layout orders the nodes otherwise: the
    # coefficients agree as a multiset, and each side rebuilds the field
    prog = decompose(x, hier, orthogonal=False)
    torch.testing.assert_close(prog.flatten().sort().values,
                               coeffs.flatten().sort().values, rtol=0,
                               atol=1e-12)
    ours = reference.recompose(coeffs)
    torch.testing.assert_close(ours, x, rtol=0, atol=1e-12)
    theirs = recompose(prog, hier, orthogonal=False)
    torch.testing.assert_close(theirs, x, rtol=0, atol=1e-12)
    assert int(levels.max()) == hier.l_target
    for l in range(hier.l_target + 1):
        assert int((levels == l).sum()) == int(np.prod(
            hier.level_shape[l])) - (int(np.prod(hier.level_shape[l - 1]))
                                     if l else 0)


def test_truncation_keeps_the_top_planes():
    c = torch.tensor([0.75, -0.3, 0.0, 0.5], dtype=torch.float64)
    assert reference.level_exponent(0.75) == 0
    assert reference.level_exponent(0.5) == -1
    full = reference.truncate_planes(c, 32)
    torch.testing.assert_close(full, c, rtol=0, atol=2.0 ** -31)
    assert torch.equal(reference.truncate_planes(c, 0), torch.zeros(4))
    # two planes: the sign plane's partner bit 31 is always 0, so one bit
    # of magnitude (0.5) is kept and half of the next (0.25) added; -0.3 keeps
    # no bit and reads 0
    two = reference.truncate_planes(c, 2)
    torch.testing.assert_close(two, torch.tensor([0.75, 0.0, 0.0, 0.75],
                                                 dtype=torch.float64))
