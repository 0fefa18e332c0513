"""PyTorch port, the generic compress surface end to end on the CPU:
1D-5D, float32 and float64, s = inf and finite s, ABS and REL, MultiDim and
SingleDim, non-uniform grids, shape adjustment, domain decomposition and
certified float64 -> float32 demotion, each against ``mgard_tpu`` on the
same NumPy input.

The contract per case: header bytes equal for equal inputs; symbols equal,
or off by at most 1 at under 1e-4 of the positions (the two packages apply
the same linear map in another rounding order, so a coefficient on a
rounding edge may fall to either side); the requested bound holds (L-inf
for s = inf, the s-norm of ``mgard_tpu_torch.norm`` for finite s); each
package decodes the other's stream inside the bound. One exception to
"header bytes equal": under a REL bound at finite s the header's norm is a
float64 square sum, which the two packages add in another order; for
float64 input it is compared to relative 1e-14 and the other fields
exactly.

This file holds the (shape, dtype, s, mode) grid; non-uniform grids,
SingleDim and shape adjustment are in test_torch_generic_grids.py, norms,
domain decomposition and refusals in test_torch_generic_norms.py, and the
float64 cases (demotion, the native transform) in
test_torch_generic_f64.py; all use this file's helpers."""

import dataclasses
import math
import struct

import numpy as np
import pytest
import torch

import mgard_tpu as J
import mgard_tpu_torch as M
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.formats.metadata import Metadata
from mgard_tpu_torch.interop import config_from_jax, coords_to_host
from mgard_tpu_torch.lossless.registry import lossless_decompress

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

INF = math.inf
ABS, REL = M.error_bound_type.ABS, M.error_bound_type.REL
DT = M.decomposition_type


def smooth(shape, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    v = np.zeros(shape)
    for _ in range(4):
        acc = rng.uniform(0, 2 * np.pi)
        for k, g in zip(rng.integers(1, 5, len(shape)), grids):
            acc = acc + 2 * np.pi * k * g
        v = v + rng.uniform(0.3, 1.0) * np.sin(acc)
    return (scale * v).astype(dtype)


def stretched(shape, seed=5):
    rng = np.random.default_rng(seed)
    coords = [np.sort(rng.uniform(0, 1, n)) for n in shape]
    for c in coords:
        c[0], c[-1] = 0.0, 1.0
    return coords


def configs(**fields):
    """(mgard_tpu Config, the port's Config) with the same fields set."""
    jc = J.Config()
    for k, val in fields.items():
        setattr(jc, k, val)
    return jc, config_from_jax(dataclasses.asdict(jc))


def header_bytes(blob):
    return blob[: Metadata.deserialize(blob)[1]]


def symbols(blob):
    """int32 symbols of a one-subdomain stream's lossless section (None
    for a flag-1 or flag-2 hybrid section)."""
    meta, off = Metadata.deserialize(blob)
    pos = off + 8
    if meta.roi_enabled:
        pos += 8 + struct.unpack_from("<Q", blob, pos)[0]
    pos += THL._skip_outliers(blob, pos)
    if meta.decomposition == DT.Hybrid and math.isinf(meta.s):
        if blob[pos] != 0:
            return None
        pos += 1
    return lossless_decompress(blob, pos, "cpu")[0].numpy()


def assert_symbol_contract(jblob, tblob):
    if jblob == tblob:
        return
    js, ts = symbols(jblob), symbols(tblob)
    assert js is not None and ts is not None and js.shape == ts.shape
    d = np.abs(js.astype(np.int64) - ts.astype(np.int64))
    assert d.max() <= 1 and np.count_nonzero(d) < 1e-4 * d.size, \
        (int(d.max()), np.count_nonzero(d), d.size)


def error(out, v, meta, tol, mode=ABS):
    """(achieved error, limit) in the norm the stream states its bound
    in, for the caller's tolerance and mode (a demoted stream's header
    holds the ABS tolerance left after the cast error)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(v, np.float64)
    s = meta.s
    if math.isinf(s):
        err, scale = np.max(np.abs(out - ref)), np.max(np.abs(ref))
    else:
        err, scale = M.norm(out - ref, s, meta.coords), meta.norm
    return err, tol * (scale if mode == REL else 1.0)


def both(v, tol, s=INF, mode=ABS, coords=None, norm_rtol=0.0, **fields):
    """Compress `v` in both packages and hold the pair to the contract.
    Returns (JAX blob, port blob, port header)."""
    jc, tc = configs(**fields)
    jblob, jst = J.compress(v, tol, s, J.error_bound_type(int(mode)), jc,
                            coords)
    tblob, tst = M.compress(v, tol, s, mode, tc, coords_to_host(coords),
                            device="cpu")
    assert int(jst) == 0 and tst == M.compress_status_type.Success
    jm, tm = Metadata.deserialize(jblob)[0], Metadata.deserialize(tblob)[0]
    if norm_rtol:
        assert abs(jm.norm - tm.norm) <= norm_rtol * abs(jm.norm)
        assert dataclasses.replace(jm, norm=0.0, coords=None) == \
            dataclasses.replace(tm, norm=0.0, coords=None)
    else:
        assert header_bytes(jblob) == header_bytes(tblob)
    if jm.norm == tm.norm:
        assert_symbol_contract(jblob, tblob)
    # each package decodes the other's stream inside the bound
    tout, st = M.decompress(jblob, device="cpu")
    assert st == M.compress_status_type.Success
    assert tuple(tout.shape) == v.shape and tout.numpy().dtype == v.dtype
    err, limit = error(tout.numpy(), v, tm, tol, mode)
    assert err <= limit, (err, limit)
    jout, st = J.decompress(tblob)
    assert int(st) == 0 and jout.shape == v.shape and jout.dtype == v.dtype
    err, limit = error(jout, v, tm, tol, mode)
    assert err <= limit, (err, limit)
    if jblob != tblob:  # and its own
        own, st = M.decompress(tblob, device="cpu")
        err, limit = error(own.numpy(), v, tm, tol, mode)
        assert st == 0 and err <= limit, (err, limit)
    return jblob, tblob, tm


# shape, dtype, s, mode, what the header must say
GRID = [
    ((65,), np.float32, INF, ABS),
    ((65,), np.float32, 0.0, ABS),
    ((65,), np.float64, 0.0, ABS),
    ((65,), np.float64, -1.0, ABS),
    ((40, 40), np.float32, INF, ABS),
    ((40, 40), np.float32, 1.0, ABS),
    ((40, 40), np.float64, INF, ABS),
    ((40, 40), np.float64, -1.0, ABS),
    ((17, 18, 19), np.float32, INF, ABS),
    ((17, 18, 19), np.float32, 0.0, ABS),
    ((17, 18, 19), np.float32, -1.0, ABS),
    ((17, 18, 19), np.float32, 1.0, ABS),
    ((17, 18, 19), np.float32, INF, REL),
    ((17, 18, 19), np.float32, 0.0, REL),
    ((17, 18, 19), np.float64, INF, ABS),
    ((17, 18, 19), np.float64, 0.0, ABS),
    ((17, 18, 19), np.float64, 1.0, ABS),
    ((9, 10, 11, 12), np.float32, INF, ABS),
    ((9, 10, 11, 12), np.float32, 0.0, ABS),
    ((9, 10, 11, 12), np.float64, 0.0, REL),
    ((5, 6, 7, 8, 9), np.float32, INF, ABS),
    ((5, 6, 7, 8, 9), np.float64, -1.0, ABS),
    ((5, 6, 7, 8, 9), np.float64, 0.0, REL),
    # rank 4 with an axis over 4096: the slice route, as XGC's f0 takes it
    ((4, 5, 4200, 5), np.float64, 0.0, REL),
]


@pytest.mark.parametrize("shape,dtype,s,mode", GRID)
def test_generic_matches_jax(shape, dtype, s, mode):
    v = smooth(shape, dtype, seed=len(shape))
    rel_f64 = mode == REL and not math.isinf(s) and dtype == np.float64
    _, tblob, meta = both(v, 1e-3, s, mode,
                          norm_rtol=1e-14 if rel_f64 else 0.0)
    # every shape here is too small for Hybrid: the header records the
    # MultiDim fallback; float64 at s = inf with this budget demotes
    assert meta.decomposition == DT.MultiDim
    assert meta.demoted == (dtype == np.float64 and math.isinf(s))
    # negative s on a uniform grid carries true-geometry coordinates
    assert (meta.coords is not None) == (not math.isinf(s) and s < 0)
