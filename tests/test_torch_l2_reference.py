"""PyTorch port, the raw s = 0 (L2) path against the benchmark's plain
reference ``bench_torch/reference_l2.py`` (loaded from there by path, so
the benchmark and these tests hold the port to one copy), on the CPU.

First the reference's own identities: decompose then recompose gives the
field back; on grids whose axes are 2^k + 1 each level's coefficients are
M-orthogonal to the coarse space (on an axis of even size MGARD-X's ghost
stencil departs from that, as the reference's docstring says). Then the
port's ``compress``/``decompress`` of float64 fields at s = 0, REL and ABS,
against the reference's round trip: the same reconstruction, the L2 bound,
the same norms, and the header of a native float64 L2 stream."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu_torch.dtypes import norm_type, np_dtype
from mgard_tpu_torch.formats.metadata import Metadata

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

_BENCH = pathlib.Path(__file__).resolve().parent.parent / "bench_torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, _BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_load("reference")  # reference_l2 takes the hierarchy from it
R = _load("reference_l2")


def smooth(shape, seed=0):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    v = np.zeros(shape)
    for _ in range(4):
        acc = rng.uniform(0, 2 * np.pi)
        for k, g in zip(rng.integers(1, 5, len(shape)), grids):
            acc = acc + 2 * np.pi * k * g
        v = v + rng.uniform(0.3, 1.0) * np.sin(acc)
    return v


def walk(shape):
    """The cumsum random walk of ROADMAP fault 3.1 (test_torch_ref_stream)."""
    rng = np.random.default_rng(3)
    return np.cumsum(rng.standard_normal(shape), axis=-1)


def _rand(shape, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=torch.float64)


@pytest.mark.parametrize("shape", [(17, 17, 17), (33, 20, 9), (16, 18, 20),
                                   (12, 9)])
def test_decompose_then_recompose_is_the_identity(shape):
    """Values in [0, 1) through ~L levels of float64 stencils and Thomas
    sweeps: the round trip is exact but for rounding, within 1e-13."""
    x = _rand(shape)
    parts = R.decompose(x)
    assert [tuple(p.shape) for p in parts] == R.level_shapes(shape)
    torch.testing.assert_close(R.recompose(parts), x, rtol=0, atol=1e-13)


def _orthogonality_defect(shape):
    """Per level, |R M_f d| / |M_f r| at most, d the level's detail (the
    residual less the prolonged correction), r its residual."""
    cur, worst = _rand(shape, 2), 0.0
    for _ in range(R.num_levels(shape)):
        r = cur - R._interpolant(cur)
        c = R.correction(r)
        d = r - R._interpolant(R._scatter_coarse(c, tuple(r.shape)))
        t = d
        for dim in range(d.ndim):
            t = R._mass_restrict(t, dim)
        worst = max(worst, float(t.abs().max())
                    / float(R.mass_apply(r).abs().max()))
        cur = R._coarse(cur) + c
    return worst


@pytest.mark.parametrize("shape", [(17, 17, 17), (33, 17, 9), (9, 9)])
def test_levels_are_M_orthogonal_to_the_coarse_space(shape):
    """On axes of 2^k + 1 nodes the restriction is the exact adjoint of the
    interpolation, so each level's detail is M-orthogonal to the coarse
    space up to float64 rounding (1e-12 of the residual's mass)."""
    assert _orthogonality_defect(shape) <= 1e-12


def test_even_axes_depart_from_orthogonality():
    """MGARD-X's ghost stencil on an axis of even size (the departure the
    reference's docstring names): the program computes it, so the
    reference keeps it, and the detail is then not M-orthogonal."""
    assert _orthogonality_defect((16, 18, 20)) > 1e-3


def test_l2_norm_is_the_function_norm():
    """sqrt(e^T M e) is 1 for the constant 1 on the unit cube and agrees
    with the port's mgard::norm at s = 0 (the multilevel component sum),
    computed another way, to rounding."""
    one = torch.ones((9, 12, 7), dtype=torch.float64)
    assert abs(R.l2_norm(one) - 1.0) < 1e-14
    e = _rand((17, 10, 9), 3) - 0.5
    assert R.l2_norm(e) == pytest.approx(M.norm(e.numpy(), 0.0), rel=1e-12)


FIELDS = [("smooth", (17, 17, 17)), ("smooth", (33, 20, 9)),
          ("smooth", (65, 65, 65)), ("walk", (33, 33, 33)),
          # rank 4: the dense operators, then the slice route (an axis
          # over refactor._FAST_MAX_AXIS), as XGC's f0 takes it
          ("smooth", (8, 9, 33, 9)), ("smooth", (4, 5, 4200, 5))]


@pytest.mark.parametrize("mode", ["REL", "ABS"])
@pytest.mark.parametrize("kind,shape", FIELDS)
def test_port_matches_the_reference(kind, shape, mode):
    """The port's float64 stream at s = 0 rebuilds the reference's field:
    with equal symbols the two differ by float64 rounding of the transforms
    (up to ~1e-11 of the finest step measured), and one symbol on the other
    side of a rounding edge would move a node by a whole step, so the gap
    is held to 1e-6 of a step. The error's L2 norm is within the bound,
    and the header states a native float64 L2 stream of one subdomain whose
    norm is the reference's to 1e-14 (a float64 square sum in another
    order)."""
    v = smooth(shape) if kind == "smooth" else walk(shape)
    tol = 1e-3
    blob, st = M.compress(v, tol, 0.0, M.error_bound_type[mode],
                          device="cpu")
    assert st == M.compress_status_type.Success
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == M.compress_status_type.Success
    x = torch.from_numpy(v)
    ref, abs_tol, step = R.roundtrip(x, tol, mode)
    assert float((out - ref).abs().max()) <= 1e-6 * step
    assert R.l2_norm(out - x) <= abs_tol
    meta = Metadata.deserialize(blob)[0]
    assert np_dtype(meta.dtype) == np.float64
    assert not meta.demoted and meta.s == 0.0 and not meta.domain_decomposed
    assert meta.ntype == norm_type.L_2
    assert meta.ebtype == M.error_bound_type[mode]
    if mode == "REL":
        assert meta.norm == pytest.approx(R.rel_norm(x), rel=1e-14)
    assert out.dtype == torch.float64
