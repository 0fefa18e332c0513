"""PyTorch port, kernel wrappers on the CPU: a CPU tensor takes the plain
version beside the kernel and launches nothing; bad inputs raise; the
package imports, and the CPU path runs, without nvcc. (The kernels
themselves run only on the GPU: ``python3 chip_smoke.py`` builds them and
holds each against its plain version there.)"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mgard_tpu_torch import kernels
from mgard_tpu_torch.lossless import bfp as TB
from mgard_tpu_torch.lossless import bfx as TX
from mgard_tpu_torch.ops import hybrid as TH

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _zero_counts():
    kernels.reset_launches()
    yield
    assert all(n == 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _v(shape=(16, 16, 128), seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_hybrid_wrappers_take_plain_path_on_cpu():
    v = _v()
    got = TH.local_transform_fused_v2(v, 100.0, 3, 4)
    ref = TH.local_transform_v2(v, 100.0, 3, 4)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    out = TH.local_inverse_fused_v2(got[0], got[2], 0.01, 3)
    assert torch.equal(out, TH.local_inverse_v2(got[0], got[2], 0.01, 3))


@pytest.mark.parametrize("shape,K,E", [((8, 128, 128), 4, 8),
                                       ((16, 128, 256), 1, 15)])
def test_fused_pack_wrappers_take_plain_path_on_cpu(shape, K, E):
    """K10/K11: a CPU tensor runs the plain versions and launches nothing
    (the fixture checks the counts)."""
    v = _v(shape) * 0.01
    got = TH.local_transform_pack_v3(v, 100.0, 3, K, E)
    ref = TH.transform_pack_v3(v, 100.0, 3, K, E)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    base, resid, cw, rem = got
    assert int(cw.max()) <= K + E
    crl = (cw - K).clamp(0, E)
    out = TH.unpack_inverse_v3(base, crl, resid, rem, 0.01, 3, K, E, shape)
    assert torch.equal(out, TH.unpack_inverse_v3_plain(
        base, crl, resid, rem, 0.01, 3, K, E, shape))
    assert float((out - v).abs().max()) <= 0.01 * 5


def test_fused_pack_wrappers_ask_for_cuda_and_never_fall_back(monkeypatch):
    """A CUDA request without CUDA raises at the entry point; a tensor that
    is neither on the CPU nor on CUDA finds no kernel and no plain
    fallback."""
    import mgard_tpu_torch as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = M.Config()
    cfg.hybrid_fused_pack = True
    cfg.bfp_base_planes = 6
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.compress(_v((16, 128, 256)).numpy(), 1e-3, config=cfg)
    shape = (8, 128, 128)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TH.local_transform_pack_v3(torch.empty(shape, **meta), 1.0, 3, 4, 8)
    with pytest.raises(ValueError, match="no kernel"):
        TH.unpack_inverse_v3(
            torch.empty((1, 4, 4, 1024), dtype=torch.int32, **meta),
            torch.empty((1, 1024), dtype=torch.int32, **meta),
            torch.empty((8 * 32, 128), dtype=torch.int32, **meta),
            torch.empty(TH.remainder_shape(shape, 3), **meta), 1.0, 3, 4, 8,
            shape)


@pytest.mark.parametrize("shape", [(64, 256), (16, 16, 128), (24, 40, 56)])
def test_flag0_wrappers_take_plain_path_on_cpu(shape):
    v = _v(shape)
    got = TH.local_transform_fused(v, 100.0, 2)
    ref = TH.local_transform(v, 100.0, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    out = TH.local_inverse_fused(got[0], got[1], 0.01, 2)
    assert torch.equal(out, TH.local_inverse(got[0], got[1], 0.01, 2))


@pytest.mark.parametrize("sb,align", [(256, 1), (64, 1024), (1, 4)])
def test_bfx_wrappers_take_plain_path_on_cpu(sb, align):
    rng = np.random.default_rng(sb)
    n = sb * 32 * 3
    x = rng.standard_normal(n) * rng.choice([0, 5, 5e5, 2e9], n)
    sym = torch.from_numpy(np.clip(x, -2**31, 2**31 - 1).astype(np.int32))
    got = TX.encode_core(sym, sb, align)
    ref = TX.encode_core_plain(sym, sb, align)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    words = got[0][: int(got[2])].contiguous()
    assert torch.equal(TX.decode_core(words, got[1], sb, align), sym)


def _plan(NSB, sbc, E, seed):
    g = torch.Generator().manual_seed(seed)
    crl = torch.randint(0, E + 1, (NSB, sbc), generator=g, dtype=torch.int32)
    rank, cnt = TB._sort_plan(crl, E)
    rband, woff, sb_off, rows = TB._plan_offsets(cnt, 2)
    return crl, rank, cnt, rband, woff, sb_off


@pytest.mark.parametrize("wide", [False, True])
def test_bfp_wrappers_take_plain_path_on_cpu(wide):
    sb, C, K, E = 256, 2, 3, 8
    NSB, sbc = 2, sb // C
    crl, rank, cnt, rband, woff, sb_off = _plan(NSB, sbc, E, 1)
    # rows whose chunk widths agree with crl (sorted-prefix invariant)
    w = (crl.reshape(-1) + K).clamp(max=K + E).long()
    hi = (torch.ones_like(w) << w)[:, None]
    g = torch.Generator().manual_seed(2)
    rows = (torch.randint(0, 1 << 30, (NSB * sbc, C * 32), generator=g) % hi)
    rows = rows.to(torch.int32 if wide else torch.int16)
    alloc = (NSB + 1) * E * (sb // 128)
    got = TB.encode_bands(rows, rank, woff, rband, sb_off, K, E, sb, C, alloc)
    ref = TB.encode_bands_plain(rows, rank, woff, rband, sb_off, K, E, sb, C,
                                alloc)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    back = TB.decode_bands(got[0], got[1], rank, woff, rband, sb_off, cnt, K,
                           E, sb, C, wide)
    assert torch.equal(back, rows)


def test_wrappers_raise_on_bad_input():
    v = _v()
    with pytest.raises(TypeError):
        TH.local_transform_fused_v2(v.double(), 1.0, 3, 4)
    with pytest.raises(ValueError):
        TH.local_transform_fused_v2(_v((16, 16, 100)), 1.0, 3, 4)
    with pytest.raises(ValueError):
        TH.local_transform_fused_v2(v, 1.0, 3, 3)  # 96 does not tile Z
    with pytest.raises(ValueError):
        TH.local_transform_fused_v2(v.transpose(0, 1), 1.0, 3, 4)
    pay = torch.zeros((16, 16, 128), dtype=torch.int16)
    with pytest.raises(ValueError):
        TH.local_inverse_fused_v2(pay, torch.zeros((4, 4, 31)), 1.0, 3)
    with pytest.raises(TypeError):
        TH.local_inverse_fused_v2(pay.int(), torch.zeros((4, 4, 32)), 1.0, 3)
    crl, rank, cnt, rband, woff, sb_off = _plan(2, 128, 8, 0)
    rows = torch.zeros((256, 64), dtype=torch.int16)
    with pytest.raises(ValueError):
        TB.encode_bands(rows.float(), rank, woff, rband, sb_off, 3, 8, 256, 2,
                        64)
    with pytest.raises(ValueError):
        TB.encode_bands(rows, rank[:1], woff, rband, sb_off, 3, 8, 256, 2, 64)
    with pytest.raises(ValueError):
        TB.encode_bands(rows, rank, woff, rband, sb_off, 30, 8, 256, 2, 64)
    with pytest.raises(ValueError):
        TB.decode_bands(torch.zeros((2, 3, 2, 128), dtype=torch.int32),
                        torch.zeros((10, 127), dtype=torch.int32), rank, woff,
                        rband, sb_off, cnt, 3, 8, 256, 2, False)


def test_bfx_and_flag0_wrappers_raise_on_bad_input():
    v = _v((16, 16, 128))
    with pytest.raises(TypeError):
        TH.local_transform_fused(v.double(), 1.0, 3)
    for bad in (_v((16, 16, 100)), _v((128,)), _v((8, 8, 8, 8)), _v((4, 64))):
        with pytest.raises(ValueError):
            TH.local_transform_fused(bad, 1.0, 3)
    with pytest.raises(ValueError):
        TH.local_transform_fused(v.transpose(0, 1), 1.0, 3)
    with pytest.raises(ValueError):
        TH.local_transform_fused(v, 1.0, 4)
    sym = torch.zeros((16, 16, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        TH.local_inverse_fused(sym, torch.zeros((4, 4, 31)), 1.0, 3)
    with pytest.raises(TypeError):
        TH.local_inverse_fused(sym.short(), torch.zeros((4, 4, 32)), 1.0, 3)
    s = torch.zeros(256 * 32, dtype=torch.int32)
    with pytest.raises(ValueError):
        TX.encode_core(s, 3, 1)  # sb not a power of two
    with pytest.raises(ValueError):
        TX.encode_core(s[:-32], 256, 1)  # not whole superblocks
    with pytest.raises(ValueError):
        TX.encode_core(s, 256, 0)
    with pytest.raises(TypeError):
        TX.encode_core(s.float(), 256, 1)
    w = torch.zeros(256, dtype=torch.uint8)
    with pytest.raises(TypeError):
        TX.decode_core(torch.zeros(8, dtype=torch.int64), w, 256, 1)
    with pytest.raises(TypeError):
        TX.decode_core(torch.zeros(8, dtype=torch.int32), w.int(), 256, 1)
    with pytest.raises(ValueError):
        TX.decode_core(torch.zeros((2, 4), dtype=torch.int32), w, 256, 1)


def test_no_fallback_on_other_devices():
    """Only a CPU tensor takes the plain version; any other device must
    launch a kernel or raise."""
    v = torch.empty((16, 16, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TH.local_transform_fused_v2(v, 1.0, 3, 4)


@pytest.mark.parametrize("shape", [(64, 256), (16, 16, 128)])
def test_no_fallback_for_bfx_and_flag0_wrappers(shape):
    """K5-K8 on a tensor that is neither on the CPU nor on CUDA: no plain
    fallback, a clear error."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TH.local_transform_fused(torch.empty(shape, **meta), 1.0, 3)
    rem = torch.empty(TH.remainder_shape(shape, 3), **meta)
    with pytest.raises(ValueError, match="no kernel"):
        TH.local_inverse_fused(torch.empty(shape, dtype=torch.int32, **meta),
                               rem, 1.0, 3)
    with pytest.raises(ValueError, match="no kernel"):
        TX.encode_core(torch.empty(256 * 32, dtype=torch.int32, **meta),
                        256, 1)
    with pytest.raises(ValueError, match="no kernel"):
        TX.decode_core(torch.empty(8, dtype=torch.int32, **meta),
                        torch.empty(256, dtype=torch.uint8, **meta), 256, 1)


def test_cpu_compress_launches_nothing(monkeypatch):
    import mgard_tpu_torch as M

    monkeypatch.setattr(TB, "SB_PALLAS_MIN", 256)
    monkeypatch.setattr(TB, "_K_CACHE", {})
    v = _v((64, 64, 128)).numpy() * 0.01
    blob, st = M.compress(v, 1e-3, device="cpu")
    out, st2 = M.decompress(blob, device="cpu")
    assert st == 0 and st2 == 0
    assert float((out - torch.from_numpy(v)).abs().max()) <= 1e-3


def test_cpu_fused_compress_launches_nothing(monkeypatch):
    """The fused flag-2 path on the CPU (the K10/K11 wrappers) runs the
    plain versions only."""
    import mgard_tpu_torch as M

    monkeypatch.setattr(TB, "_K_CACHE", {})
    cfg = M.Config()
    cfg.hybrid_fused_pack = True
    cfg.bfp_base_planes = 6
    v = _v((16, 128, 256)).numpy() * 0.01
    blob, st = M.compress(v, 1e-3, config=cfg, device="cpu")
    out, st2 = M.decompress(blob, device="cpu")
    assert st == 0 and st2 == 0
    assert float((out - torch.from_numpy(v)).abs().max()) <= 1e-3


def test_cpu_bfx_compress_launches_nothing():
    """Hybrid+BFX on the CPU (flag 0: the K7/K8 and K5/K6 wrappers) runs
    the plain versions only."""
    import mgard_tpu_torch as M

    cfg = M.Config()
    cfg.lossless = M.lossless_type.BFX
    v = _v((32, 64, 128)).numpy() * 0.01
    blob, st = M.compress(v, 1e-3, config=cfg, device="cpu")
    out, st2 = M.decompress(blob, device="cpu")
    assert st == 0 and st2 == 0 and b"BFX2" in blob
    assert float((out - torch.from_numpy(v)).abs().max()) <= 1e-3


def test_import_and_cpu_path_need_no_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(REPO))
    code = ("import mgard_tpu_torch, sys; "
            "from mgard_tpu_torch import kernels; "
            "assert kernels._lib is None and 'jax' not in sys.modules; "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(kernels.shutil, "which", lambda *_a, **_k: None)
    monkeypatch.setattr(kernels, "library_path",
                        lambda: tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
