"""PyTorch port, the generic compress surface: the bound in the s-norm
over an (s, tol) grid, ``norm`` against ``mgard_tpu``, domain
decomposition under a REL bound at finite s, a BFP section at a ragged
symbol count, what the port refuses, and the caller's Config left alone;
helpers and contract from test_torch_generic.py."""

import dataclasses

import numpy as np
import pytest
import torch

import mgard_tpu as J
import mgard_tpu_torch as M
from mgard_tpu.ops.norms import norm as j_norm
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.formats.metadata import Metadata
from test_torch_generic import (INF, REL, both, configs, error, smooth,
                                stretched)

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


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
