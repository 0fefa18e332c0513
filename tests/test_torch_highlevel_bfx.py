"""PyTorch port, BFX sections through the public API on the CPU: the
main path's small remainder at the production threshold, and
``lossless=BFX`` (flag-0 streams of one BFX section) in 2D, 3D and 4D,
each stream decoded by both packages within the tolerance; helpers from
test_torch_highlevel.py."""

import dataclasses

import pytest
import torch

import mgard_tpu
import mgard_tpu_torch as M
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.formats.metadata import Metadata
from mgard_tpu_torch.interop import config_from_jax
from test_torch_highlevel import (SHAPE, _err, _field, _flag,
                                  _jax_flag1, _raw_backend, fresh_k_caches)

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


def test_bfx_section_and_flag2_raise_clearly(fresh_k_caches):
    """The default main path at (64, 64, 128) and the production threshold:
    the 8192-symbol remainder rides a BFX section. Each package decodes the
    other's flag-1 stream; a flag byte forged to 2 on a shape outside the
    flag-2 scheme fails cleanly."""
    v = _field(SHAPE)
    tol = 1e-3
    blob, st = M.compress(v, tol, device="cpu")
    assert st == 0 and _flag(blob) == 1
    assert _raw_backend(blob) == M.lossless_type.BFX
    assert blob.count(b"BFP5") == 1 and blob.count(b"BFX2") == 1
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and _err(out, v) <= tol
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol
    _jax_flag1(fresh_k_caches)
    jblob, st = mgard_tpu.compress(v, tol=tol)
    assert int(st) == 0 and _flag(jblob) == 1
    assert _raw_backend(jblob) == M.lossless_type.BFX
    out, st3 = M.decompress(jblob, device="cpu")
    assert st3 == 0 and _err(out, v) <= tol
    bad = bytearray(blob)
    _m, off = Metadata.deserialize(blob)
    bad[off + 8 + len(THL._EMPTY_OUTLIERS)] = 2
    out, st4 = M.decompress(bytes(bad), device="cpu")
    assert out is None and st4 == M.compress_status_type.Failure


def _bfx_config():
    jcfg = mgard_tpu.Config()
    jcfg.lossless = mgard_tpu.lossless_type.BFX
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.lossless == M.lossless_type.BFX
    assert cfg.bfx_sb_blocks == jcfg.bfx_sb_blocks
    return jcfg, cfg


@pytest.mark.parametrize("shape", [SHAPE, (512, 512)])
def test_bfx_backend_streams_cross_decode(fresh_k_caches, shape):
    """lossless=BFX: a flag-0 stream of one BFX section (K7 and K5 on a
    CUDA tensor). Each package decodes the other's stream within tol; a
    JAX Config carried across gives the same header bytes."""
    v = _field(shape) if len(shape) == 3 else _field(shape + (1,))[..., 0]
    tol = 1e-3
    jcfg, cfg = _bfx_config()
    blob, st = M.compress(v, tol, config=cfg, device="cpu")
    assert st == 0 and _flag(blob) == 0
    assert _raw_backend(blob) == M.lossless_type.BFX
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and tuple(out.shape) == shape and _err(out, v) <= tol
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol
    jblob, st3 = mgard_tpu.compress(v, tol=tol, config=jcfg)
    assert int(st3) == 0 and _flag(jblob) == 0
    out, st4 = M.decompress(jblob, device="cpu")
    assert st4 == 0 and _err(out, v) <= tol
    hj = Metadata.deserialize(jblob)[1]
    assert blob[:hj] == jblob[:hj]


def test_bfx_stream_of_a_4d_field_decodes_in_both_packages(fresh_k_caches):
    """A 4D field takes the flag-0 plain versions on every device (the JAX
    package runs no Pallas kernel for it either)."""
    shape = (8, 8, 64, 64)
    v = _field((8, 1, 8 * 64 * 64)).reshape(shape)
    tol = 1e-3
    blob, st = M.compress(v, tol, config=_bfx_config()[1], device="cpu")
    assert st == 0 and _flag(blob) == 0
    assert _raw_backend(blob) == M.lossless_type.BFX
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and tuple(out.shape) == shape and _err(out, v) <= tol
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol
