"""PyTorch port, K14 on the card (csrc/multidim.cu, ops/multidim.py): the
MultiDim transform of a 3D field against its plain version
(refactor.decompose_plain / recompose_plain: the dense operators) on the
same card, at the shapes of test_torch_multidim_schedule.py in both types,
bases and on both kinds of coordinates, and at 500^3 float64 in the L2
basis (S3D's size); then compress / decompress at REL 1e-3, s = 0 within
the L2 bound, with the transform counters per call. Tests marked ``card``
skip without a CUDA card; on the GPU host:

    python3 -m pytest --noconftest -m card tests/test_torch_multidim_card.py

This file imports no JAX (the GPU host has none)."""

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import refactor as R
from mgard_tpu_torch.utils import trace
from test_torch_multidim_schedule import CASES, TOL, _coords, _field, _ids

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _moved(fn):
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_k14_matches_the_plain_version(card, case):
    shape, dtype, uniform, orth = case
    coords = None if uniform else _coords(shape, sum(shape))
    hier = Hierarchy(shape, dtype, coords)
    v = _field(shape, dtype, 5).to(card)
    dec, d = _moved(lambda: R.decompose(v, hier, orth))
    assert d.get("transform.kernel_levels", 0) == hier.l_target
    assert "transform.dense_levels" not in d
    if hier.l_target:
        assert _rel(dec, R.decompose_plain(v, hier, orth)) <= TOL[dtype]
    w = _field(shape, dtype, 7).to(card)
    assert _rel(R.recompose(w, hier, orth),
                R.recompose_plain(w, hier, orth)) <= TOL[dtype]
    assert _rel(R.recompose(dec, hier, orth), v) <= TOL[dtype]


@pytest.mark.card
def test_k14_at_500_cubed_float64(card):
    """S3D's 500^3 float64 field in the L2 basis: 9 levels, two of them
    even (500 -> 251, 126 -> 64), each way against the dense path."""
    n = 500
    x = torch.linspace(0, 1, n, dtype=torch.float64, device=card)
    v = (torch.sin(5 * x)[:, None, None] * torch.cos(3 * x)[None, :, None]
         + x[None, None, :] ** 2)
    hier = M.get_hierarchy((n, n, n), np.float64)
    assert hier.l_target == 9
    dec = R.decompose(v, hier, True)
    assert _rel(dec, R.decompose_plain(v, hier, True)) <= 1e-13
    back = R.recompose(dec, hier, True)
    assert _rel(back, R.recompose_plain(dec, hier, True)) <= 1e-13
    assert _rel(back, v) <= 1e-13


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_compress_s0_rel_on_the_card(card, dtype):
    """compress / decompress at REL 1e-3, s = 0 within the L2 bound; each
    call runs every level step on K14 and, once the tables are on the
    card, copies nothing up."""
    shape = (130, 97, 200)
    x = [torch.linspace(0, 1, k, dtype=torch.float64, device=card)
         for k in shape]
    v = (torch.sin(6 * x[0])[:, None, None] * torch.cos(4 * x[1])[None, :,
                                                                  None]
         + torch.exp(-2 * x[2])[None, None, :]).to(dtype)
    hier = M.get_hierarchy(shape, v.cpu().numpy().dtype)
    for call in range(2):
        (blob, st), dc = _moved(lambda: M.compress(
            v, 1e-3, 0.0, M.error_bound_type.REL))
        (out, st2), dd = _moved(lambda: M.decompress(blob, device=card))
        assert st == st2 == M.compress_status_type.Success
        for d in (dc, dd):
            assert d["transform.kernel_levels"] == hier.l_target
            assert "transform.dense_levels" not in d
            if call:
                assert d.get("transform.ops_bytes", 0) == 0
    ref = v.double().cpu().numpy()
    err = M.norm(out.double().cpu().numpy() - ref, 0.0)
    assert err <= 1e-3 * float(np.sqrt(np.mean(ref ** 2)))
