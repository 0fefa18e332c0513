"""PyTorch port, the whole slice: compress/decompress through the public
API on the CPU, and streams that cross-decode both ways with the JAX
package within the tolerance. This file holds the flag-1 main path and the
API's edges; the fused flag-2 path is in test_torch_highlevel_fused.py and
the BFX sections in test_torch_highlevel_bfx.py, both on this file's
helpers.

(64, 64, 128) is the smallest shape with one full v2 superblock (16384
blocks of 32 symbols). Its remainder has 8192 symbols, which ride BFX at
the production threshold; the ``bfp_small`` fixture gives both packages
``bfp.SB_PALLAS_MIN = 256`` so that the flag-1 tests below also cover a BFP
remainder section. The BFX tests run at the production threshold."""

import struct

import numpy as np
import pytest
import torch

import mgard_tpu
import mgard_tpu.highlevel as JHL
import mgard_tpu_torch as M
from mgard_tpu.lossless import bfp as JB
from mgard_tpu.ops import hybrid as JH
from mgard_tpu_torch import highlevel as THL
from mgard_tpu_torch.formats.metadata import MAGIC, Metadata
from mgard_tpu_torch.lossless import bfp as TB

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

SHAPE = (64, 64, 128)


def _field(shape, seed=3):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, shape[0], dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        * np.cos(np.linspace(0, 3, shape[1], dtype=np.float32))[None, :, None]
        + np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :] ** 2
        + 0.05 * rng.standard_normal(shape).astype(np.float32)
    )
    return v.astype(np.float32)


@pytest.fixture
def bfp_small(monkeypatch):
    """Remainders of 8192 symbols ride BFP in both packages; sticky K
    caches start empty."""
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "SB_PALLAS_MIN", 256)
        monkeypatch.setattr(mod, "_K_CACHE", {})
    return monkeypatch


@pytest.fixture
def fresh_k_caches(monkeypatch):
    """Sticky K caches start empty; the thresholds stay as shipped."""
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_K_CACHE", {})
    return monkeypatch


def _flag(blob):
    """Hybrid front-end flag of the first subdomain section."""
    _m, off = Metadata.deserialize(blob)
    return blob[off + 8 + len(THL._EMPTY_OUTLIERS)]


def _minor(blob):
    """Minor file version stamped in the header."""
    return blob[len(MAGIC) + 8 + 4]


def _jax_flag1(monkeypatch):
    """Let the JAX package write flag-1 streams on the CPU (as
    tests/test_hybrid_v2.py does)."""
    monkeypatch.setattr(JHL, "_hybrid_v2_ok", lambda *a, **k: True)
    monkeypatch.setattr(JH, "local_transform_fused_v2",
                        lambda v, iq, nl, c: JH.local_transform_v2_xla(
                            v, iq, nl, c))


def _err(out, v):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return float(np.max(np.abs(out.astype(np.float64) - v)))


def _raw_backend(blob):
    """Backend id of the first subdomain's lossless section (the remainder
    section of a flag-1 stream)."""
    _m, off = Metadata.deserialize(blob)
    pos = off + 8 + len(THL._EMPTY_OUTLIERS)
    flag = blob[pos]
    pos += 1
    if flag == 1:
        (cf_len,) = struct.unpack_from("<Q", blob, pos)
        pos += 8 + cf_len
    return blob[pos]


@pytest.mark.parametrize("tol", [1e-2, 1e-3])
def test_port_flag1_stream_decodes_in_both_packages(bfp_small, tol):
    v = _field(SHAPE)
    blob, st = M.compress(v, tol, device="cpu")
    assert st == M.compress_status_type.Success
    assert _flag(blob) == 1 and blob.count(b"BFP5") == 2
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == M.compress_status_type.Success
    assert out.dtype == torch.float32 and tuple(out.shape) == SHAPE
    assert _err(out, v) <= tol
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol


def test_jax_flag1_stream_decodes_in_port(bfp_small):
    _jax_flag1(bfp_small)
    v = _field(SHAPE)
    tol = 1e-3
    jblob, st = mgard_tpu.compress(v, tol=tol)
    assert int(st) == 0 and _flag(jblob) == 1
    out, st2 = M.decompress(jblob, device="cpu")
    assert st2 == M.compress_status_type.Success and _err(out, v) <= tol
    # same knobs, same header bytes
    tblob, _ = M.compress(v, tol, device="cpu")
    hj = Metadata.deserialize(jblob)[1]
    assert tblob[:hj] == jblob[:hj]


def test_tight_tolerance_takes_flag0_in_both_packages(bfp_small):
    """Symbols over the u16 budget: the port falls back to flag 0, and each
    package decodes the other's flag-0 stream."""
    v = _field(SHAPE)
    tol = 1e-5
    blob, st = M.compress(v, tol, device="cpu")
    assert st == M.compress_status_type.Success and _flag(blob) == 0
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol
    jblob, st2 = mgard_tpu.compress(v, tol=tol)  # CPU JAX writes flag 0
    assert int(st2) == 0 and _flag(jblob) == 0
    out, st3 = M.decompress(jblob, device="cpu")
    assert st3 == M.compress_status_type.Success and _err(out, v) <= tol


def test_rel_mode(bfp_small):
    v = _field(SHAPE) * np.float32(7.0)
    tol = 1e-3
    blob, st = M.compress(v, tol, mode=M.error_bound_type.REL, device="cpu")
    assert st == 0
    bound = tol * float(np.max(np.abs(v)))
    out, _ = M.decompress(blob, device="cpu")
    assert _err(out, v) <= bound
    outj, _ = mgard_tpu.decompress(blob)
    assert _err(outj, v) <= bound


def test_tensor_input_stays_on_its_device(bfp_small):
    v = _field(SHAPE)
    blob_np, _ = M.compress(v, 1e-3, device="cpu")
    blob_t, _ = M.compress(torch.from_numpy(v), 1e-3)
    assert blob_np == blob_t
    with pytest.raises(ValueError):
        M.compress(torch.from_numpy(v), 1e-3, device="meta")


def test_status_codes():
    cpu = dict(device="cpu")
    assert M.compress(np.zeros((2,) * 6, np.float32), 1e-3, **cpu)[1] == \
        M.compress_status_type.NotSupportHigherNumberOfDimensionsFailure
    assert M.compress(np.zeros((8, 8), np.int32), 1e-3, **cpu)[1] == \
        M.compress_status_type.NotSupportDataTypeFailure
    assert M.decompress(b"not a stream", **cpu)[1] == \
        M.compress_status_type.Failure
    # a small field takes the MultiDim fallback; what the port still lacks
    # names its ROADMAP item
    blob, st = M.compress(np.zeros((8, 8, 8), np.float32), 1e-3, **cpu)
    assert st == M.compress_status_type.Success
    assert Metadata.deserialize(blob)[0].decomposition == \
        M.decomposition_type.MultiDim
    out, st = M.decompress(blob, **cpu)
    assert st == M.compress_status_type.Success and not out.any()
    from mgard_tpu_torch.dtypes import compressor_type

    for field, value, item in (
            ("compressor", compressor_type.ZFP, "item 9b"),
            ("lossless", M.lossless_type.Huffman, "item 11"),
            ("lossless", M.lossless_type.BFP_Zstd, "item 11")):
        cfg = M.Config()
        setattr(cfg, field, value)
        with pytest.raises(NotImplementedError, match=item):
            M.compress(np.zeros((8, 8, 8), np.float32), 1e-3, config=cfg,
                       **cpu)


def test_default_device_is_the_card(monkeypatch, fresh_k_caches):
    """With no CUDA device, a call that leaves the device to its default
    raises and names device='cpu'; it never quietly runs on the CPU. A CPU
    tensor is the caller asking for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = _field(SHAPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.compress(v, 1e-3)
    blob, st = M.compress(torch.from_numpy(v), 1e-3)
    assert st == 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.decompress(blob)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.decompress(blob, device="cuda")
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and out.device.type == "cpu" and _err(out, v) <= 1e-3


def test_truncated_stream_fails_cleanly(bfp_small):
    blob, _ = M.compress(_field(SHAPE), 1e-3, device="cpu")
    out, st = M.decompress(blob[: len(blob) // 2], device="cpu")
    assert out is None and st == M.compress_status_type.Failure
    (sec_len,) = struct.unpack_from("<Q", blob,
                                    Metadata.deserialize(blob)[1])
    assert sec_len > 0


def test_subdomains_cross_decode(bfp_small):
    """A memory cap splits the field into two (64, 64, 64) subdomains (each
    takes flag 0: Z=64 fails the flag-1 gate); both packages decode it."""
    v = _field(SHAPE)
    cfg = M.Config()
    cfg.max_memory_footprint = 64 * 64 * 64 * 44 + 1
    tol = 1e-3
    blob, st = M.compress(v, tol, config=cfg, device="cpu")
    assert st == 0
    meta, _ = Metadata.deserialize(blob)
    assert meta.domain_decomposed and _flag(blob) == 0
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == 0 and _err(out, v) <= tol
    outj, stj = mgard_tpu.decompress(blob)
    assert int(stj) == 0 and _err(outj, v) <= tol


def test_jax_demoted_f64_stream_decodes_in_port(bfp_small):
    """The JAX package compresses a float64 field as its certified float32
    image (a 'demoted' stream); the port decodes it to float64."""
    v = _field(SHAPE).astype(np.float64)
    tol = 1e-3
    jblob, st = mgard_tpu.compress(v, tol=tol)
    assert int(st) == 0 and Metadata.deserialize(jblob)[0].demoted
    out, st2 = M.decompress(jblob, device="cpu")
    assert st2 == 0 and out.dtype == torch.float64 and _err(out, v) <= tol
