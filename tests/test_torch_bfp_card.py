"""PyTorch port, BFP's wire compaction on the card (K12/K13, csrc/bfp.cu)
against the same blobs made of CPU tensors, where the wrappers run their
plain versions: for flag-1 and flag-2 streams through the public API and a
standalone BFP stream with exceptions, the card writes the bytes that the
same symbols give on the CPU, both read them to the same tensors, and
streams cross between the card and the CPU both ways; a blob compressed
under a side stream copies after K12; the kernels equal their plain
versions on every bfp.BAND_CASES geometry in both layouts. Tests marked
``card`` skip without a CUDA card; on the GPU host:

    python3 -m pytest --noconftest -m card tests/test_torch_bfp_card.py

The unmarked test counts the plain versions on the CPU. This file imports
no JAX (the GPU host has none)."""

import struct

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu_torch import highlevel as HL, kernels
from mgard_tpu_torch.formats.metadata import Metadata
from mgard_tpu_torch.lossless import bfp as T
from mgard_tpu_torch.utils import trace
from mgard_tpu_torch.utils.bytesink import join

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

WIRE = ("bfp.wire.device", "bfp.wire.host")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _fresh_k_cache(monkeypatch):
    monkeypatch.setattr(T, "_K_CACHE", {})


def _moved(fn):
    """fn()'s result and how far it moved the two wire counters."""
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, [after.get(k, 0) - before.get(k, 0) for k in WIRE]


def _field(shape, seed=3):
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.linspace(0, 1, n, dtype=np.float32)
                      for n in shape], indexing="ij")
    v = (np.sin(2 * np.pi * g[0]) * np.cos(3 * g[1]) + g[2] ** 2
         + 0.05 * rng.standard_normal(shape).astype(np.float32))
    return torch.from_numpy(v.astype(np.float32))


def _cf_section(blob):
    """(flag, cf stream blob) of a Hybrid stream's payload."""
    _m, off = Metadata.deserialize(blob)
    p = off + 8 + len(HL._EMPTY_OUTLIERS)
    (n,) = struct.unpack_from("<Q", blob, p + 1)
    return blob[p], blob[p + 9: p + 9 + n]


def _fused_cfg(K):
    cfg = M.Config()
    cfg.hybrid_fused_pack = True
    cfg.bfp_base_planes = K
    return cfg


def test_cpu_counts_the_host_branch():
    sym = (np.random.default_rng(0).standard_normal(256 * 32 * 3) * 40
           ).astype(np.int32)
    blob, moved = _moved(lambda: T.encode(torch.from_numpy(sym)))
    assert moved == [0, 1]
    (out, _), moved = _moved(lambda: T.decode(blob))
    assert moved == [0, 1]
    np.testing.assert_array_equal(out.numpy(), sym)


@pytest.mark.card
@pytest.mark.parametrize("flag", [1, 2])
def test_hybrid_stream_card_branch_equals_host(flag, card, monkeypatch):
    """A flag-1 (default Config) or flag-2 (fused, K pinned) stream: its cf
    stream is the blob that the same symbols give as CPU tensors, one blob
    with its wire on the card a call each way; the card and the CPU parse
    it to the same tensors, and the CPU reads the stream within tol."""
    shape, tol = ((128, 128, 128), 1e-3) if flag == 1 else \
        ((16, 128, 256), 1e-3)
    cfg = None if flag == 1 else _fused_cfg(6)
    v = _field(shape).to(card)
    real, seen = T.serialize_prepared_parts, []

    def noted(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(T, "serialize_prepared_parts", noted)
    (blob, st), moved = _moved(lambda: M.compress(v, tol, config=cfg))
    assert st == 0 and moved == [1, 0] and len(seen) == 1
    got_flag, cf = _cf_section(blob)
    assert got_flag == flag
    args, kw = seen[0]
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    cf_cpu, moved = _moved(lambda: join(real(*cpu_args, **kw)))
    assert cf_cpu == cf and moved == [0, 1]
    (out, st), moved = _moved(lambda: M.decompress(blob, device=card))
    assert st == 0 and moved == [1, 0]
    assert float((out - v).abs().max()) <= tol
    static = flag == 2
    on_card = T.deserialize_prepared(cf, 0, card, static_cap=static)
    on_cpu = T.deserialize_prepared(cf, 0, "cpu", static_cap=static)
    assert on_card[3:] == on_cpu[3:]
    for a, b in zip(on_card[:3], on_cpu[:3]):
        assert torch.equal(a.cpu(), b)
    out_c, st = M.decompress(blob, device="cpu")
    assert st == 0 and float((out_c - v.cpu()).abs().max()) <= tol
    # and the other way: a stream written on the CPU, read on the card
    blob_c, st = M.compress(v.cpu(), tol, config=cfg, device="cpu")
    out, st2 = M.decompress(blob_c, device=card)
    assert st == st2 == 0 and float((out - v).abs().max()) <= tol


def _pinned_cfg(K=0):
    """The card's superblock pinned, so the CPU packs the same blob."""
    cfg = M.Config()
    cfg.bfp_base_planes, cfg.bfp_sb_blocks = K, T.SB_BLOCKS
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("K", [0, 12])
def test_standalone_stream_with_exceptions(K, card):
    rng = np.random.default_rng(K)
    n = T.SB_BLOCKS * 32 * 2 + 1000
    sym = (rng.standard_normal(n) * 3e4).astype(np.int32)
    sym[rng.integers(0, n, 300)] = 2 ** 30 + 7
    cfg = _pinned_cfg(K)
    x = torch.from_numpy(sym).to(card)
    kernels.reset_launches()
    blob = T.encode(x, cfg)
    assert kernels.LAUNCHES["bfp_compact"] == 1
    out, used = T.decode(blob, 0, card)
    assert kernels.LAUNCHES["bfp_expand"] == 1 and used == len(blob)
    assert torch.equal(out, x)
    assert T.encode(torch.from_numpy(sym), cfg) == blob
    np.testing.assert_array_equal(T.decode(blob)[0].numpy(), sym)


@pytest.mark.card
def test_copies_follow_the_compressing_stream(card, monkeypatch):
    """A blob compressed on a side stream, with K12 held back there: its
    copies from the card wait for K12, and the bytes equal those of the
    same symbols on the CPU. Twice, since a process's first such call can
    be serialized where later ones are not."""
    sym = (np.random.default_rng(9).standard_normal(1 << 22) * 3e4
           ).astype(np.int32)
    x = torch.from_numpy(sym).to(card)
    cfg = _pinned_cfg()
    host = T.encode(torch.from_numpy(sym), cfg)
    launch = kernels.launch

    def held(name, *args, **kw):
        if name == "bfp_compact":
            torch.cuda._sleep(1 << 27)  # some 0.08 s of the side stream
        launch(name, *args, **kw)

    monkeypatch.setattr(kernels, "launch", held)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    for _ in range(2):
        with torch.cuda.stream(side):
            blob, moved = _moved(lambda: T.encode(x, cfg))
        assert moved == [1, 0] and blob == host


@pytest.mark.card
@pytest.mark.parametrize("static", [False, True], ids=["row-padded",
                                                       "static-cap"])
@pytest.mark.parametrize("spec", T.BAND_CASES, ids=[c[0] for c in
                                                    T.BAND_CASES])
def test_kernels_equal_plain(spec, static, card):
    _name, _bits, K, E, sb, C, _nsb, _w, _s = spec
    cw = T.case_widths(spec, np.random.default_rng(5))
    crl = np.clip(cw - K, 0, E).astype(np.int32)
    cnt, rband, start, rows = T._band_geometry(crl, E, C, sb, static)
    tab = T._wire_table(cnt, rband, start, C)
    gen = torch.Generator(device=card).manual_seed(7)
    resid = torch.randint(-2 ** 31, 2 ** 31 - 1, (max(rows, 1), 128),
                          generator=gen, device=card, dtype=torch.int32)
    wire = T.compact_wire(resid, tab, C)
    tt = torch.from_numpy(tab).to(card)
    assert torch.equal(wire, T.compact_wire_plain(resid, tt, C))
    back = T.expand_wire(wire, tab, C, rows)
    torch.cuda.synchronize()
    if rows:
        assert torch.equal(back, T.expand_wire_plain(wire, tt, C, rows))
