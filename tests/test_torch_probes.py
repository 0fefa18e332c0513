"""PyTorch port, the layout probes P1-P3 (``mgard_tpu_torch/probes.py``):
the plain versions, which serve CPU tensors and are what the CUDA variants
are held against on the card, checked here against the NumPy expectations
of the three TPU probe scripts (``scripts/probe_dynwin.py``,
``scripts/probe_strided_dma.py``, ``scripts/probe_u16.py``), and P3 also
against ``scripts/probe_u16.bt16`` run with ``jax.numpy`` on the CPU. All
products are words and bits: every comparison is exact. The scripts are
loaded by path and not edited."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu_torch import kernels, probes as P

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("geom", [(8, 4, 4), (3, 8, 16), (1, 1, 1)])
def test_dynwin_matches_the_scripts_expectation(geom):
    """scripts/probe_dynwin.py expects the content rows of every plane
    concatenated, superblock after superblock."""
    NSB, E, W = geom
    planes, woff, sb_off, total = P.dynwin_inputs(NSB, E, W, seed=0)
    out = P.dynwin_place_plain(planes, woff, sb_off, total).numpy()
    pl, wo = planes.numpy(), woff.numpy()
    tot = np.diff(np.append(sb_off.numpy(), total))
    rows = np.diff(np.concatenate([wo, tot[:, None]], 1), axis=1)
    exp = np.concatenate([pl[i, j, : rows[i, j]] for i in range(NSB)
                          for j in range(E)], axis=0)
    assert out.shape == (total + E * W, 128) and exp.shape[0] == total
    np.testing.assert_array_equal(out[:total], exp)
    assert not out[total:].any()
    # the sorted-suffix-zero invariant the OR placement relies on
    assert all(not pl[i, j, rows[i, j]:].any() for i in range(NSB)
               for j in range(E))
    for variant in P.VARIANTS["dynwin"]:  # a CPU tensor takes the plain one
        got = P.dynwin_place(planes, woff, sb_off, total, variant=variant)
        np.testing.assert_array_equal(got.numpy(), out)


def test_dynwin_inputs_are_the_scripts_draws():
    """At the probe's own geometry the inputs are the script's own
    default_rng(0) draws."""
    planes, woff, sb_off, total = P.dynwin_inputs(8, 4, 4, seed=0)
    rng = np.random.default_rng(0)
    want = rng.integers(1, 1 << 30, size=(8, 4, 4, 128),
                        dtype=np.int64).astype(np.uint32)
    rows = rng.integers(1, 5, size=(8, 4)).astype(np.int32)
    for i in range(8):
        for j in range(4):
            want[i, j, rows[i, j]:] = 0
    np.testing.assert_array_equal(planes.numpy().view(np.uint32), want)
    assert total == int(rows.sum())
    np.testing.assert_array_equal(woff.numpy(), np.cumsum(rows, 1) - rows)


@pytest.mark.parametrize("sbc", [256, 8])
def test_relayout_matches_the_scripts_expectation(sbc):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 30, (sbc, 128), dtype=np.int64).astype(np.int32)
    exp = x.reshape(sbc, 4, 32).reshape(sbc * 4, 32) * 2
    for variant in P.VARIANTS["relayout"]:
        got = P.relayout(torch.from_numpy(x), variant=variant)
        np.testing.assert_array_equal(got.numpy(), exp)
    # row 4c + g = lanes [32g, 32g + 32) of row c, doubled
    np.testing.assert_array_equal(exp[4 * 5 + 2], 2 * x[5, 64:96])
    t = rng.integers(0, 1 << 30, (sbc * 4, 32), dtype=np.int64).astype(
        np.int32)
    exp2 = t.reshape(sbc, 4, 32).reshape(sbc, 128)
    got2 = P.relayout(torch.from_numpy(t), reverse=True)
    np.testing.assert_array_equal(got2.numpy(), exp2)
    assert got2.data_ptr() != torch.from_numpy(t).data_ptr()


@pytest.mark.parametrize("S", [4096, 33])
def test_u16_planes_match_the_scripts_expectation_and_bt16(S):
    rng = np.random.default_rng(0)
    zz = rng.integers(0, 1 << 16, (S, 32), dtype=np.int64).astype(np.uint16)
    # the script's expectation: plane j word of block b = bits j of the 32
    # symbols
    Z = zz.astype(np.uint32)
    exp = np.zeros((16, S), np.uint32)
    for j in range(16):
        for k in range(32):
            exp[j] |= (((Z[:, k] >> j) & 1) << k).astype(np.uint32)
    t = torch.from_numpy(zz.view(np.int16))
    for variant in P.VARIANTS["u16"]:
        got = P.u16_planes(t, variant=variant)
        assert got.dtype == torch.int32 and tuple(got.shape) == (16, S)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), exp)
    # the script's kernel body: its 16-bit butterfly on both halves
    bt16 = _load("probe_u16").bt16
    xt = jnp.asarray(zz).T
    lo, hi = bt16(xt[:16], jnp), bt16(xt[16:], jnp)
    body = np.asarray(lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16))
    np.testing.assert_array_equal(body, exp)


def test_wrappers_refuse_bad_input_and_count_nothing_on_the_cpu():
    before = dict(kernels.LAUNCHES)
    findings = P.run_all("cpu", production=False)
    assert kernels.LAUNCHES == before  # no kernel was launched
    assert {(f["probe"], f["variant"]) for f in findings} == {
        ("dynwin", "or"), ("dynwin", "owner"), ("relayout", "direct"),
        ("relayout", "cpasync"), ("relayout", "row32"),
        ("relayout", "row33"), ("relayout_rev", "direct"),
        ("relayout_rev", "cpasync"), ("u16", "ballot"),
        ("u16", "butterfly")}
    assert all(f["equal"] and f["ms"] is None for f in findings)
    assert all(P.counter(p, v) in kernels.LAUNCHES
               for p, vs in P.VARIANTS.items() for v in vs)
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        P.relayout(x, variant="tma")
    with pytest.raises(ValueError):
        P.relayout(x, reverse=True)
    with pytest.raises(TypeError):
        P.relayout(x.float())
    with pytest.raises(TypeError):
        P.u16_planes(torch.zeros((4, 32), dtype=torch.int32))
    with pytest.raises(ValueError):
        P.u16_planes(torch.zeros((4, 16), dtype=torch.int16))
    planes, woff, sb_off, total = P.dynwin_inputs(2, 2, 2)
    with pytest.raises(ValueError):
        P.dynwin_place(planes, woff[:, :1].contiguous(), sb_off, total)
    with pytest.raises(ValueError, match="variant"):
        P.dynwin_place(planes, woff, sb_off, total, variant="spill")


def test_probe_shapes_are_the_ones_stated():
    """The probe's own shapes and one production shape each: K2's geometry
    at 512^3, 128 MB of rows, the 512^3 cf stream."""
    from mgard_tpu_torch.lossless import bfp

    assert P.SHAPES["dynwin"][0] == (8, 4, 4)
    NSB, E, W = P.SHAPES["dynwin"][1]
    assert NSB == 512 ** 3 // (bfp.SB_BLOCKS * 32) and E == bfp.E_DEFAULT
    assert W == bfp.SB_BLOCKS // bfp.LANES
    assert P.SHAPES["relayout"] == (256, 1 << 18)
    assert P.SHAPES["u16"] == (4096, 512 ** 3 // 32)


def test_relayout_tail_is_ragged(monkeypatch):
    """P2's tail case: its int4 count is no multiple of a direct block's
    NT threads x U int4 (csrc/probes.cu), so the last block's masked end
    runs, and it needs more blocks than an H100 holds at once (132 SMs x 8
    blocks of 256); the plain version is the scripts' expectation there
    too."""
    import re

    src = (pathlib.Path(P.__file__).resolve().parent / "csrc"
           / "probes.cu").read_text()
    NT = int(re.search(r"constexpr int NT = (\d+);", src).group(1))
    U = int(re.search(r"constexpr int U = (\d+);", src).group(1))
    n4 = P.RELAYOUT_TAIL * P.LANES // 4
    assert n4 % (NT * U) and n4 // (NT * U) > 132 * 8
    sbc = P.RELAYOUT_TAIL
    x = np.random.default_rng(1).integers(0, 1 << 30, (sbc, 128),
                                          dtype=np.int64).astype(np.int32)
    got = P.relayout(torch.from_numpy(x), variant="direct")
    np.testing.assert_array_equal(got.numpy(), x.reshape(sbc * 4, 32) * 2)
    back = P.relayout(got // 2, reverse=True, variant="direct")
    np.testing.assert_array_equal(back.numpy(), x)
    monkeypatch.setattr(P, "SHAPES", {"dynwin": ((1, 1, 1),) * 2,
                                      "relayout": (8, 8), "u16": (33, 33)})
    tails = [c[1] for c in P.cases("cpu") if c[0].startswith("relayout")]
    assert tails.count(sbc) == 2  # forward and reverse, on the card too
