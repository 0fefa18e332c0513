"""PyTorch port, float64 through the generic compress surface on the CPU:
certified float64 -> float32 demotion and the native float64 transform,
each against ``mgard_tpu`` on the same NumPy input, under the contract of
test_torch_generic.py (whose helpers this file uses): header bytes equal,
symbols equal or off by one at under 1e-4 of the positions, the bound held
on the double data, each package decoding the other's stream.

Two tests name a point where the port departs from the JAX package on
purpose (defects recorded against the reference): the demotion gate's
per-subdomain reduction and the float32 decode of a demoted flag-0 stream
(the third, detect_roi's parent attribution, is in test_torch_roi.py)."""

import numpy as np
import pytest
import torch

import mgard_tpu as J
import mgard_tpu_torch as M
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.decomposer import DomainDecomposer
from mgard_tpu_torch.formats.metadata import Metadata
from mgard_tpu_torch.ops import hybrid as THy
from test_torch_generic import (ABS, DT, INF, REL, both, configs, smooth,
                                stretched, symbols)

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


def f64_field(shape, seed=7, scale=1.0):
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.linspace(0, 3, n) for n in shape], indexing="ij")
    v = sum(np.sin(2.1 * a + i) for i, a in enumerate(axes))
    v += 0.05 * rng.standard_normal(shape)
    return (scale * v).astype(np.float64)


@pytest.mark.parametrize("shape", [(33, 34, 35), (64, 64, 64)])
@pytest.mark.parametrize("mode", [ABS, REL])
def test_demoted_matches_jax(shape, mode, monkeypatch):
    """Ample budget: both packages write a float32 payload under a float64
    header, the bound holds on the double data. At (64, 64, 64) the stream
    is Hybrid flag 0 (Z = 64 fails the flag-1 gate) with a BFX section."""
    from mgard_tpu.lossless import bfp as JB
    from mgard_tpu_torch.lossless import bfp as TB

    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_K_CACHE", {})
    v = f64_field(shape)
    _, tblob, meta = both(v, 1e-3, INF, mode)
    assert meta.demoted and meta.dtype == M.data_type.Double
    hybrid = shape == (64, 64, 64)
    assert meta.decomposition == (DT.Hybrid if hybrid else DT.MultiDim)
    out, _ = M.decompress(tblob, device="cpu")
    assert out.dtype == torch.float64


def test_demoted_nonuniform_and_decomposed():
    shape = (21, 22)
    coords = stretched(shape, seed=1)
    _, _, meta = both(f64_field(shape), 5e-3, coords=coords)
    assert meta.demoted and meta.coords is not None
    v = f64_field((40, 40, 40))
    _, _, meta = both(v, 1e-2, max_memory_footprint=4 * v.size)
    assert meta.demoted and meta.domain_decomposed


def test_tight_tolerance_keeps_native_f64():
    """A budget under four cast errors: the gate refuses, the native double
    transform certifies the bound."""
    v = f64_field((17, 18, 19))
    cast_err = float(np.max(np.abs(v - v.astype(np.float32).astype(
        np.float64))))
    _, _, meta = both(v, cast_err)
    assert not meta.demoted and meta.dtype == M.data_type.Double


def test_demotion_off_finite_s_and_f32_never_demote():
    _, _, meta = both(f64_field((16, 17, 18)), 1e-2, f64_demote=False)
    assert not meta.demoted
    blob, st = M.compress(f64_field((17, 17)), 1e-2, 0.0, device="cpu")
    assert st == 0 and not Metadata.deserialize(blob)[0].demoted
    blob, st = M.compress(f64_field((16, 16, 16)).astype(np.float32), 1e-3,
                          device="cpu")
    meta = Metadata.deserialize(blob)[0]
    assert not meta.demoted and meta.dtype == M.data_type.Float


def test_native_f64_hybrid_matches_jax(monkeypatch):
    """A hybrid-worthwhile float64 field with a budget too tight to demote
    runs the plain flag-0 front end in float64 (the kernels are float32),
    in both packages."""
    from mgard_tpu.lossless import bfp as JB
    from mgard_tpu_torch.lossless import bfp as TB

    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_K_CACHE", {})
    v = f64_field((64, 64, 64), scale=0.01)
    _, tblob, meta = both(v, 1e-9)
    assert not meta.demoted and meta.decomposition == DT.Hybrid
    assert meta.nlocal == 3 and symbols(tblob) is not None


def test_hybrid_at_finite_s_matches_jax(monkeypatch):
    """Hybrid asked for at finite s on a hybrid-worthwhile shape: the header
    keeps Hybrid, the section is the MultiDim transform of the whole field
    (262,144 symbols: one BFP stream in the pre-sorted mode)."""
    from mgard_tpu.lossless import bfp as JB
    from mgard_tpu_torch.lossless import bfp as TB

    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_K_CACHE", {})
    v = smooth((64, 64, 64), np.float32, seed=2)
    _, tblob, meta = both(v, 1e-3, 0.0)
    assert meta.decomposition == DT.Hybrid and meta.nlocal == 3
    pos = Metadata.deserialize(tblob)[1] + 8 + len(THL._EMPTY_OUTLIERS)
    assert tblob[pos] == int(M.lossless_type.BFP)


def test_demotion_gate_reduces_per_subdomain(monkeypatch):
    """DIVERGENCE from mgard_tpu on purpose (a defect recorded against the
    reference): the port reduces the cast error and max |v| subdomain by
    subdomain, never over the whole array; the JAX package casts and
    reduces the whole array before it decomposes the domain. The maximum
    of the per-subdomain maxima is the same number, so the streams are
    the same bytes."""
    v = f64_field((40, 40, 40))
    cap = 4 * v.size
    seen = []
    real = THL._demotion_tolerance

    def spy(t, tol, mode, config):
        dd = DomainDecomposer(tuple(t.shape), np.float64, config,
                              device=t.device)
        seen.append(dd.num_subdomains)
        biggest = max(int(np.prod(dd.subdomain_shape(i)))
                      for i in range(dd.num_subdomains))
        abs_ = torch.Tensor.abs
        monkeypatch.setattr(
            torch.Tensor, "abs",
            lambda x: (_ for _ in ()).throw(AssertionError(
                f"reduction over {x.numel()} values"))
            if x.numel() > biggest else abs_(x))
        try:
            return real(t, tol, mode, config)
        finally:
            monkeypatch.setattr(torch.Tensor, "abs", abs_)

    monkeypatch.setattr(THL, "_demotion_tolerance", spy)
    for mode in (ABS, REL):
        jblob, tblob, meta = both(v, 1e-2, INF, mode,
                                  max_memory_footprint=cap)
        assert meta.demoted and jblob == tblob
    assert seen and min(seen) > 1


def test_demoted_flag0_decodes_in_float32(monkeypatch):
    """DIVERGENCE from mgard_tpu on purpose (a defect recorded against the
    reference): a demoted stream's flag-0 section decodes with the working
    type float32, so it reaches the float32 front-end wrapper (K8 on the
    card); the JAX package hands its gate the declared float64 and takes
    the generic path. The values agree either way."""
    v = f64_field((64, 64, 64))
    jc, tc = configs(lossless=J.lossless_type.BFX)
    jblob, _ = J.compress(v, 1e-3, INF, J.error_bound_type.ABS, jc)
    meta = Metadata.deserialize(jblob)[0]
    assert meta.demoted and meta.decomposition == DT.Hybrid
    calls = []
    real = THy.local_inverse_fused
    monkeypatch.setattr(THy, "local_inverse_fused",
                        lambda sym, rem, q, nl: calls.append(
                            (sym.dtype, rem.dtype)) or real(sym, rem, q, nl))
    out, st = M.decompress(jblob, device="cpu")
    assert st == 0 and out.dtype == torch.float64
    assert calls == [(torch.int32, torch.float32)]
    assert float(np.max(np.abs(out.numpy() - v))) <= 1e-3
    jout, _ = J.decompress(jblob)
    assert float(np.max(np.abs(out.numpy() - jout))) <= 1e-6
