"""PyTorch port, BFX codec: for the same int32 symbols and geometry the port
writes the same BFX2 bytes as the JAX package (its bytes API on the CPU,
sb=256 and align=1; its XLA and interpret-mode Pallas cores at the kernel
geometry, sb=4096 and align=1024; and ``np_encode``), and each package
decodes the other's blobs. The port's CPU path runs the plain versions of
kernels K5/K6 (the merge and split trees), so these are also their
byte-level oracles. Every comparison is exact."""

import functools
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgard_tpu
import mgard_tpu_torch
from mgard_tpu.lossless import bfx as J
from mgard_tpu_torch.lossless import bfx as T
from mgard_tpu_torch.utils.bytesink import join

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores


def _rand_syms(n, scale, seed=0):
    """The symbols of tests/test_bfx.py: near zero, with large outliers."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal(n) * scale).astype(np.int32)
    k = max(1, n // 1000)
    idx = rng.integers(0, n, k)
    s[idx] = rng.integers(-(2**30), 2**30, k).astype(np.int32)
    return s


def _jax_decode(blob):
    out, used = J.decode(blob)
    return np.asarray(out), used


@pytest.mark.parametrize("n", [1, 31, 32, 8192, 8193, 40000])
@pytest.mark.parametrize("scale", [0, 3, 1000])
def test_blob_bytes_match_jax_and_cross_decode(n, scale):
    s = _rand_syms(n, scale)
    blob = T.encode(torch.from_numpy(s))
    assert blob == J.encode(s)
    out, used = T.decode(blob)
    assert used == len(blob) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), s)
    outj, usedj = _jax_decode(blob)
    assert usedj == len(blob)
    np.testing.assert_array_equal(outj, s)


def test_matches_numpy_reference():
    s = _rand_syms(3 * 8192, 50, seed=3)
    blob = T.encode(torch.from_numpy(s))
    widths_ref, words_ref = J.np_encode(s)
    _m, _n, total, sb, align = struct.unpack_from(T._HDR, blob, 0)
    assert (sb, align) == (T.SB_BLOCKS_SMALL, 1)
    p = struct.calcsize(T._HDR)
    nb = len(widths_ref)
    np.testing.assert_array_equal(np.frombuffer(blob, np.uint8, nb, p),
                                  widths_ref)
    assert total == len(words_ref)
    np.testing.assert_array_equal(np.frombuffer(blob, "<u4", total, p + nb),
                                  words_ref)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    real = J.pl.pallas_call
    monkeypatch.setattr(J.pl, "pallas_call",
                        functools.partial(real, interpret=True))


def _padded(n, sb, seed):
    s = _rand_syms(n, 40, seed)
    out = np.zeros(T._pad_to(n, sb), np.int32)
    out[:n] = s
    return out


@pytest.mark.parametrize("core", ["xla", "pallas_interpret"])
def test_kernel_geometry_words_match_jax_cores(core, request):
    """sb=4096 and align=1024 (the geometry the card and the TPU write) over
    two superblocks: the plain K5 words, widths and total equal the JAX
    core's; each side decodes the other's words."""
    if core == "pallas_interpret":
        request.getfixturevalue("pallas_interpret")
    sb, align = T.SB_BLOCKS, T.ALIGN
    sym = _padded(sb * 32 + 5000, sb, 1)
    w2d, wj, totj = J.encode_core(jnp.asarray(sym), sb,
                                  core == "pallas_interpret", align)
    words, widths, total = T.encode_core(torch.from_numpy(sym), sb, align)
    tot = int(total)
    assert tot == int(totj) and tot % align == 0
    flat = np.asarray(w2d).reshape(-1)
    np.testing.assert_array_equal(words[:tot].numpy().view(np.uint32),
                                  flat[:tot])
    np.testing.assert_array_equal(widths.numpy(), np.asarray(wj))
    back = T.decode_core(torch.from_numpy(flat[:tot].view(np.int32).copy()),
                          widths, sb, align)
    np.testing.assert_array_equal(back.numpy(), sym)
    # the JAX core reads a superblock of slack past the stream
    buf = np.zeros(tot + sb * 32, np.uint32)
    buf[:tot] = words[:tot].numpy().view(np.uint32)
    backj = J.decode_core(jnp.asarray(buf.reshape(-1, 128)),
                          jnp.asarray(np.asarray(wj)), sb,
                          core == "pallas_interpret", align)
    np.testing.assert_array_equal(np.asarray(backj), sym)


def test_kernel_geometry_blob_decodes_on_cpu():
    """A blob at sb=4096, align=1024 (as the card writes it) decodes on the
    port's CPU path: the geometry comes from the header. (The JAX package's
    decoding of such words is held above.)"""
    sb, align = T.SB_BLOCKS, T.ALIGN
    n = sb * 32 + 777
    s = _rand_syms(n, 1000, 2)
    sym = np.zeros(T._pad_to(n, sb), np.int32)
    sym[:n] = s
    words, widths, total = T.encode_core(torch.from_numpy(sym), sb, align)
    blob = join(T.serialize_device_parts(
        ("bfx", n, sb, align, words, widths, total)))
    assert struct.unpack_from(T._HDR, blob, 0)[3:] == (sb, align)
    out, used = T.decode(blob)
    assert used == len(blob)
    np.testing.assert_array_equal(out.numpy(), s)


def test_sb_override_matches_jax():
    s = _rand_syms(64 * 32 * 2 + 3, 30, 4)
    jc, tc = mgard_tpu.Config(), mgard_tpu_torch.Config()
    jc.bfx_sb_blocks = tc.bfx_sb_blocks = 64
    blob = T.encode(torch.from_numpy(s), tc)
    assert struct.unpack_from(T._HDR, blob, 0)[3:] == (64, 1)
    assert blob == J.encode(s, jc)
    np.testing.assert_array_equal(T.decode(blob)[0].numpy(), s)


def test_sb1_decode_masks_above_width():
    """DIVERGENCE from mgard_tpu on purpose (a defect recorded against the
    reference): at Config.bfx_sb_blocks = 1 both packages write the same
    blob, but the JAX package's split tree has no level that masks the
    words above a block's width, so it decodes a narrow block with the
    next superblock's words as its high planes. The port's plain K6 (and
    K6 on the card) decode the input."""
    s = _rand_syms(40 * 32, 30, 6)
    jc, tc = mgard_tpu.Config(), mgard_tpu_torch.Config()
    jc.bfx_sb_blocks = tc.bfx_sb_blocks = 1
    blob = T.encode(torch.from_numpy(s), tc)
    assert struct.unpack_from(T._HDR, blob, 0)[3:] == (1, 1)
    assert blob == J.encode(s, jc)
    np.testing.assert_array_equal(T.decode(blob)[0].numpy(), s)
    assert not np.array_equal(_jax_decode(blob)[0], s)


def test_geometry_choice_follows_the_jax_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    big = T.SB_BLOCKS * 32
    assert T._choose_sb(big, cuda) == T.SB_BLOCKS
    assert T._choose_sb(big - 1, cuda) == T.SB_BLOCKS_SMALL
    assert T._choose_sb(big, cpu) == T.SB_BLOCKS_SMALL
    assert T._choose_sb(big, cpu, 1024) == 1024
    assert T._choose_sb(100, cpu, 1024) == T.SB_BLOCKS_SMALL


def test_extreme_magnitudes_and_all_zero():
    sym = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**30, -(2**30) - 1] * 700,
                   np.int32)
    blob = T.encode(torch.from_numpy(sym))
    assert blob == J.encode(sym)
    np.testing.assert_array_equal(T.decode(blob)[0].numpy(), sym)
    zeros = np.zeros(8192, np.int32)
    blob = T.encode(torch.from_numpy(zeros))
    assert blob == J.encode(zeros)
    assert len(blob) == struct.calcsize(T._HDR) + 8192 // 32
    np.testing.assert_array_equal(T.decode(blob)[0].numpy(), zeros)
    empty = T.encode(torch.zeros(0, dtype=torch.int32))
    assert empty == J.encode(np.zeros(0, np.int32))
    assert T.decode(empty)[0].numel() == 0


def test_corrupt_blob_is_rejected():
    blob = bytearray(T.encode(torch.from_numpy(_rand_syms(9000, 30, 5))))
    p = struct.calcsize(T._HDR)
    bad = bytearray(blob)
    bad[p] = 33  # a width over 32
    with pytest.raises(ValueError):
        T.decode(bytes(bad))
    bad = bytearray(blob)
    bad[p] ^= 1  # widths no longer sum to the word count
    with pytest.raises(ValueError):
        T.decode(bytes(bad))
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 20, 3)  # sb not a power of two
    with pytest.raises(ValueError):
        T.decode(bytes(bad))
