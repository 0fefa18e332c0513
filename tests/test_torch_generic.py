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

The float64 cases (demotion, the native transform) are in
test_torch_generic_f64.py, which uses this file's helpers."""

import dataclasses
import math
import struct

import numpy as np
import pytest
import torch

import mgard_tpu as J
import mgard_tpu_torch as M
from mgard_tpu.ops.norms import norm as j_norm
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.formats.metadata import Metadata
from mgard_tpu_torch.interop import config_from_jax, coords_to_host
from mgard_tpu_torch.lossless.registry import lossless_decompress

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


# ----------------------------------------------------------------------
# s-norms, domain decomposition, refusals
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(33, 34), (34, 34)])
def test_snorm_bound_grid(shape):
    """The bound itself, measured in the s-norm, over an (s, tol) grid,
    negative s on even shapes included (that case needs the true-geometry
    routing)."""
    u = smooth(shape, np.float64, seed=3)
    for s in [-1.5, -0.5, 0.0, 0.5, 1.5, INF]:
        for tol in [0.1, 0.001]:
            blob, st = M.compress(u, tol, s, device="cpu")
            assert st == 0
            meta = Metadata.deserialize(blob)[0]
            out, st = M.decompress(blob, device="cpu")
            err, limit = error(out.numpy(), u, meta, tol)
            assert st == 0 and err <= limit, (s, tol, err)


@pytest.mark.parametrize("shape,coords", [((33,), False), ((20, 21), False),
                                          ((17, 18, 19), True),
                                          ((5, 6, 7, 8), False)])
def test_norm_matches_jax(shape, coords):
    c = stretched(shape) if coords else None
    u = smooth(shape, np.float64, seed=9)
    for s in [INF, 0.0, -1.0, 0.7]:
        want = j_norm(u, s, c)
        assert abs(M.norm(u, s, c) - want) <= 1e-12 * abs(want)
        assert abs(M.norm(torch.from_numpy(u), s, c) - want) <= \
            1e-12 * abs(want)
    assert abs(M.norm(np.ones(shape), 0.0) - 1.0) < 1e-12


def test_decomposed_rel_finite_s_matches_jax():
    """Several subdomains under a REL bound at finite s: the norm is the
    root of the summed per-subdomain squares, the local tolerance shrinks
    by sqrt(S)."""
    v = smooth((24, 24, 24), np.float32, seed=1)
    _, _, meta = both(v, 1e-3, 0.0, REL, max_memory_footprint=v.size * 20)
    assert meta.domain_decomposed and meta.norm > 0
    _, _, meta = both(v, 1e-3, INF, REL, max_memory_footprint=v.size * 20)
    assert meta.domain_decomposed and meta.norm == np.max(np.abs(v))



def test_bfp_section_at_a_ragged_symbol_count(monkeypatch):
    """65^3 = 274,625 symbols under MultiDim: over the BFX threshold, so
    the section is one BFP stream in the pre-sorted mode, and not a
    multiple of a superblock (8,192 symbols on the CPU), so its last
    superblock is zero-padded. Same bytes in both packages."""
    from mgard_tpu.lossless import bfp as JB
    from mgard_tpu_torch.lossless import bfp as TB

    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_K_CACHE", {})
    v = smooth((65, 65, 65), np.float32, seed=5)
    jblob, tblob, meta = both(v, 1e-3,
                              decomposition=J.decomposition_type.MultiDim)
    pos = Metadata.deserialize(tblob)[1] + 8 + len(THL._EMPTY_OUTLIERS)
    assert tblob[pos] == int(M.lossless_type.BFP) and jblob == tblob
    assert v.size % (TB.SB_BLOCKS_SMALL * 32) != 0
    # the sticky K is keyed by the padded count (and E, and the chunk size
    # that fits the small superblock: 2)
    assert list(TB._K_CACHE) == [(278528, TB.E_DEFAULT, 2)]
    assert list(JB._K_CACHE) == [(278528, TB.E_DEFAULT, 2)]


def test_refusals_name_their_roadmap_item():
    """What the port does not serve yet: the ZFP compressor (item 9b),
    the Huffman-class backends and the zstd second stages (item 11), on
    compress and on decompress of a JAX-written stream."""
    v = smooth((17, 18, 19), np.float32)
    for fields, item in (
            (dict(lossless=J.lossless_type.Huffman), "item 11"),
            (dict(lossless=J.lossless_type.CPU_Lossless), "item 11"),
            (dict(lossless=J.lossless_type.BFX_Zstd), "item 11"),
            (dict(compressor=J.dtypes.compressor_type.ZFP), "item 9b")):
        jc, tc = configs(**fields)
        with pytest.raises(NotImplementedError, match=item):
            M.compress(v, 1e-3, config=tc, device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            M.compress_roi(v, 1e-3, v > 0, config=tc, device="cpu")
        jblob, st = J.compress(v, 1e-3, INF, J.error_bound_type.ABS, jc)
        assert int(st) == 0
        with pytest.raises(NotImplementedError, match=item):
            M.decompress(jblob, device="cpu")


def test_decompress_leaves_the_callers_config_alone():
    cfg = M.Config()
    cfg.lossless = M.lossless_type.BFX
    before = dataclasses.asdict(cfg)
    blob, _ = M.compress(smooth((20, 21), np.float32), 1e-3, device="cpu")
    out, st = M.decompress(blob, cfg, device="cpu")
    assert st == 0 and dataclasses.asdict(cfg) == before
