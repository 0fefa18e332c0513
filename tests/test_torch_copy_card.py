"""PyTorch port, the staged copies of a stream's bytes between the card and
the host (``utils/trace.py``'s ``PinnedRing``): a staged DtoH and HtoD give
the bytes and tensors of the direct copy at every chunk boundary and at a
host offset of one byte; a copy that finds the ring held goes direct, and
threads that share the ring lose no byte; a blob compressed under a side
stream copies after its kernels; round trips back to back, with the last
DMAs of a read still queued, give the streams and fields of the direct
path; and the 512^3 round trip of the nyx cells gives the same stream byte
for byte with staging bypassed, its bulk copies counted under
``copy.staged.*``. Tests marked ``card`` skip without a CUDA card; on the
GPU host:

    python3 -m pytest --noconftest -m card tests/test_torch_copy_card.py

This file imports no JAX (the GPU host has none)."""

import math
import sys
import threading

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu_torch import kernels
from mgard_tpu_torch.lossless import bfp as T
from mgard_tpu_torch.utils import trace

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

C = trace.CHUNK
SIZES = {"0": 0, "1": 1, "chunk-1": C - 1, "chunk": C, "chunk+1": C + 1,
         "3.5chunks": 7 * C // 2}
KEYS = ("copy.staged.calls", "copy.staged.bytes", "copy.staged.chunks",
        "copy.direct.calls")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _moved(fn):
    """fn()'s result and how far it moved the staging counters."""
    before = trace.counters()
    out = fn()
    torch.cuda.synchronize()
    after = trace.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in KEYS}


def _direct(ring, fn):
    """fn() with the ring held, so that every bulk copy goes direct."""
    with ring.lock:
        return _moved(fn)


def _bytes(n, card, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=card,
                         generator=gen)


def _six_modes(n, device, seed=42):
    """A 512^3-class smooth field: six sine modes of bench.py's draws."""
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    X, Y, Z = x[:, None, None], x[None, :, None], x[None, None, :]
    rng = np.random.default_rng(seed)
    v = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for _ in range(6):
        kx, ky, kz = (int(k) for k in rng.integers(1, 9, 3))
        amp, ph = float(rng.uniform(0.3, 1.0)), float(rng.uniform(0, 6.28))
        v += amp * torch.sin(2 * math.pi * (kx * X + ky * Y + kz * Z) + ph)
    return v


@pytest.mark.card
@pytest.mark.parametrize("size", SIZES.values(), ids=SIZES.keys())
def test_ring_copies_equal_direct(size, card):
    """Both legs through the ring, at a host offset of one byte, against
    the direct copies of the same bytes; the chunks are the plan's."""
    ring = trace.pinned_ring(card)
    src = _bytes(size, card, size)
    want = src.cpu()
    host = np.zeros(size + 1, np.uint8)
    assert ring.dtoh(src, torch.from_numpy(host[1:])) == len(
        trace.chunk_plan(size))
    assert host[0] == 0 and np.array_equal(host[1:], want.numpy())

    blob = bytes(1) + want.numpy().tobytes()
    up = torch.from_numpy(np.frombuffer(blob, np.uint8, size, 1).copy())
    out = torch.full((size,), 7, dtype=torch.uint8, device=card)
    assert ring.htod(up, out) == len(trace.chunk_plan(size))
    assert torch.equal(out, up.to(card)) and torch.equal(out, src)


@pytest.mark.card
def test_helpers_stage_bulk_copies_and_go_direct_when_held(card):
    """to_host_into and to_device take the ring at STAGE_MIN bytes and up,
    copy directly below it, and count a bulk copy that found the ring held
    under copy.direct.calls; every path gives the same values."""
    ring = trace.pinned_ring(card)
    x = _bytes(trace.STAGE_MIN + 64, card, 5).view(torch.int32)
    want = x.cpu().numpy()
    for t, staged in ((x, True), (x[:trace.STAGE_MIN // 8], False)):
        for held in (False, True):
            host = np.zeros(t.numel() * 4 + 1, np.uint8)
            fn = lambda: trace.to_host_into(t, host[1:])  # noqa: E731
            _, d = _direct(ring, fn) if held else _moved(fn)
            assert np.array_equal(host[1:].view(np.int32),
                                  want[:t.numel()])
            bulk = staged and not held
            assert d == {"copy.staged.calls": int(bulk),
                         "copy.staged.bytes": bulk * t.numel() * 4,
                         "copy.staged.chunks": bulk * len(
                             trace.chunk_plan(t.numel() * 4)),
                         "copy.direct.calls": int(staged and held)}, d
            a = want[:t.numel()].reshape(-1, 4)
            fn = lambda: trace.to_device(a, card)  # noqa: E731
            up, d = _direct(ring, fn) if held else _moved(fn)
            assert up.dtype == torch.int32 and tuple(up.shape) == a.shape
            assert torch.equal(up.reshape(-1), t)
            assert d["copy.staged.calls"] == int(bulk)
            assert d["copy.direct.calls"] == int(staged and held)


@pytest.mark.card
def test_uploads_back_to_back_keep_their_bytes(card):
    """Three bulk uploads with no sync between them: each waits for the
    slot its chunks reuse, so none reads another's bytes."""
    arrays = [np.random.default_rng(s).integers(
        0, 2**31, 3 * C // 4 + s, dtype=np.int32) for s in range(3)]
    outs = [trace.to_device(a, card) for a in arrays]
    for a, t in zip(arrays, outs):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


@pytest.mark.card
def test_threads_share_the_ring(card):
    """Twelve threads (more than the cores) copy bulk tensors both ways at
    once, with a short switch interval: each copy takes the ring or goes
    direct, every byte arrives, and every bulk copy is counted once."""
    n, rounds, threads = trace.STAGE_MIN + 4096, 3, 12
    srcs = [_bytes(n, card, 100 + i) for i in range(threads)]
    wants = [s.cpu().numpy() for s in srcs]
    torch.cuda.synchronize()
    errors = []

    def work(i):
        try:
            for _ in range(rounds):
                host = np.zeros(n + 1, np.uint8)
                trace.to_host_into(srcs[i], host[1:])
                up = trace.to_device(host[1:], card)
                if not (np.array_equal(host[1:], wants[i])
                        and torch.equal(up, srcs[i])):
                    errors.append(i)
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _, d = _moved(lambda: _run_threads(work, threads))
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert d["copy.staged.calls"] + d["copy.direct.calls"] == \
        2 * rounds * threads, d
    assert d["copy.staged.bytes"] == d["copy.staged.calls"] * n


def _run_threads(fn, k):
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(k)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "a copy hung"


@pytest.mark.card
def test_copies_follow_the_compressing_stream(card, monkeypatch):
    """A blob compressed on a side stream, with K12 held back there: its
    staged copies from the card wait for K12, and the bytes equal those of
    the same symbols on the CPU."""
    sym = (np.random.default_rng(9).standard_normal(1 << 24) * 3e4
           ).astype(np.int32)
    x = torch.from_numpy(sym).to(card)
    cfg = M.Config()
    cfg.bfp_base_planes, cfg.bfp_sb_blocks = 0, T.SB_BLOCKS
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
            blob, d = _moved(lambda: T.encode(x, cfg))
        assert blob == host and d["copy.staged.calls"] >= 1, d


@pytest.mark.card
def test_round_trips_back_to_back_equal_the_direct_path(card):
    """compress, decompress (its last DMAs left queued), then the next
    compress at once: every stream and field equals the one made with the
    ring held, and the first blob is unchanged after the second."""
    ring = trace.pinned_ring(card)
    fields = [_six_modes(384, card, seed) for seed in (1, 2)]

    def trips():
        T._K_CACHE.clear()  # both passes choose K from the same state
        res = []
        for v in fields:
            blob, st = M.compress(v, 1e-3, math.inf, M.error_bound_type.ABS)
            out, st2 = M.decompress(blob, device=card)
            res.append((blob, bytes(bytearray(blob)), out, st, st2))
        return res

    staged, d = _moved(trips)
    direct, dd = _direct(ring, trips)
    assert d["copy.staged.calls"] >= 4 and d["copy.direct.calls"] == 0, d
    assert dd["copy.staged.calls"] == 0 and dd["copy.direct.calls"] >= 4, dd
    for (b, keep, out, st, st2), (b2, _, out2, _, _) in zip(staged, direct):
        assert st == st2 == M.compress_status_type.Success
        assert b == keep == b2
        assert torch.equal(out, out2)


@pytest.mark.card
def test_nyx_round_trip_stream_equals_the_direct_one(card):
    """The nyx cells' 512^3 round trip, on BFP and on BFX: the staged
    stream equals the direct one byte for byte, the staged counters cover
    the stream's bulk device bytes, and the fields read back are equal."""
    ring = trace.pinned_ring(card)
    v = _six_modes(512, card)
    for lossless in (M.lossless_type.BFP, M.lossless_type.BFX):
        cfg = M.Config()
        cfg.lossless = lossless

        def write():
            T._K_CACHE.clear()
            return M.compress(v, 1e-3, math.inf, M.error_bound_type.ABS,
                              config=cfg)[0]

        blob, dw = _moved(write)
        blob2, ddw = _direct(ring, write)
        assert blob == blob2
        assert dw["copy.direct.calls"] == 0 and dw["copy.staged.calls"] >= 1
        assert 0.9 * len(blob) < dw["copy.staged.bytes"] <= len(blob), dw
        assert ddw["copy.direct.calls"] == dw["copy.staged.calls"], ddw
        read = lambda: M.decompress(blob, device=card)[0]  # noqa: E731
        out, dr = _moved(read)
        out2, _ = _direct(ring, read)
        assert torch.equal(out, out2)
        assert float((out - v).abs().max()) <= 1e-3
        assert dr["copy.staged.calls"] >= 1
        assert 0.9 * len(blob) < dr["copy.staged.bytes"] <= len(blob), dr
        del out, out2
