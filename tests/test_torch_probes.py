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
        ("dynwin", "or"), ("dynwin", "owner"), ("dynwin", "run"),
        ("dynwin", "bulk"), ("relayout", "direct"),
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


# ----------------------------------------------------------------------
# P1's "run" variant: its schedule emulated in NumPy
# ----------------------------------------------------------------------
def _probes_constants():
    import re

    src = (pathlib.Path(P.__file__).resolve().parent / "csrc"
           / "probes.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("NT", "U")}


_POISON = 0xDEADBEEF  # what torch.empty may leave in a row nobody writes


def _emulate_run(planes, woff, sb_off, total, mutation=None):
    """dynwin_run_kernel's grid (E, NSB + 1) in NumPy: block (j, i) takes
    plane (i, j)'s run (plane_run: rows woff[i, j] to the next plane's
    offset, for the last plane to the superblock's end, sb_off[i + 1] or
    total_rows for the last superblock); block (j, NSB) zeroes tail rows
    [total + j*W, total + (j+1)*W). Thread t copies int4 t0 + u*NT for
    t0 = t, t + NT*U, ... and u < U while below the run's count. Returns
    the output (unwritten int4 hold _POISON) and the writes per int4."""
    k = _probes_constants()
    NT, U = k["NT"], k["U"]
    pl = planes.numpy().view(np.uint32).reshape(-1, 4)  # int4 of the planes
    wo, so = woff.numpy(), sb_off.numpy()
    NSB, E, W, _ = planes.shape
    w4 = W * 32
    out = np.full(((total + E * W) * 32, 4), _POISON, np.uint32)
    writes = np.zeros(out.shape[0], np.int64)
    tid = np.arange(NT)
    for i in range(NSB + 1):
        for j in range(E):
            if i == NSB:
                first = total + j * W + (mutation == "tail+1")
                src, dst, n4 = None, first * 32, w4
            else:
                o = int(wo[i, j])
                if j + 1 < E:
                    end = int(wo[i, j + 1])
                elif mutation == "no_tot_rule":
                    end = o + W  # the plane's capacity, not its content
                else:
                    end = (int(so[i + 1]) if i + 1 < NSB else total) \
                        - int(so[i])
                n = end - o + {"run+1": 1, "run-1": -1}.get(mutation, 0)
                src, dst, n4 = (i * E + j) * w4, (int(so[i]) + o) * 32, n * 32
            steps = np.arange(0, max(n4, 1), NT * U)
            idx = (tid[:, None, None] + steps[None, :, None]
                   + np.arange(U)[None, None, :] * NT).ravel()
            idx = idx[idx < n4]
            if dst + (idx.max(initial=-1)) >= out.shape[0]:
                raise IndexError("store past the end of the output")
            out[dst + idx] = 0 if src is None else pl[src + idx]
            np.add.at(writes, dst + idx, 1)
    return out.reshape(-1, 128), writes


@pytest.mark.parametrize("geom", [(8, 4, 4), (256, 8, 128)])
def test_dynwin_run_schedule_equals_plain(geom):
    """The run variant's blocks write every output int4 exactly once, and
    the result is dynwin_place_plain's, bit for bit, at the probe's shape
    and the production shape."""
    planes, woff, sb_off, total = P.dynwin_inputs(*geom, seed=0)
    got, writes = _emulate_run(planes, woff, sb_off, total)
    assert (writes == 1).all()
    want = P.dynwin_place_plain(planes, woff, sb_off, total).numpy()
    np.testing.assert_array_equal(got, want.view(np.uint32))


@pytest.mark.parametrize("mutation",
                         ["no_tot_rule", "tail+1", "run+1", "run-1"])
def test_dynwin_run_schedule_catches_mutations(mutation):
    """Each deliberate fault in the schedule (the last plane copying its
    whole capacity, the tail shifted a row, every run a row too long or
    too short) breaks exactly-once coverage or the result."""
    planes, woff, sb_off, total = P.dynwin_inputs(8, 4, 4, seed=0)
    want = P.dynwin_place_plain(planes, woff, sb_off, total).numpy()
    try:
        got, writes = _emulate_run(planes, woff, sb_off, total, mutation)
    except IndexError:
        return  # a store past the end of the output
    assert not ((writes == 1).all()
                and np.array_equal(got, want.view(np.uint32)))


def test_dynwin_wrapper_is_one_launch_without_host_to_device_copy(
        monkeypatch):
    """The card's branch of dynwin_place makes one launch per call and
    passes total_rows as an int: no tensor is built from host values
    (torch.tensor) and no torch.diff runs, so the call can be captured in
    a CUDA graph; every variant takes the same entry point."""
    calls = []
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *a, count_as=None:
                        calls.append((name, a, count_as)))
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)

    def refuse(*a, **k):
        raise AssertionError("a host value became a device tensor")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "diff", refuse)
    planes, woff, sb_off, total = P.dynwin_inputs(8, 4, 4)
    for v in P.VARIANTS["dynwin"]:
        out = P._dynwin_launch(planes, woff, sb_off, total, v)
        assert tuple(out.shape) == (total + 16, 128)
    assert [c[0] for c in calls] == ["probe_dynwin"] * 4
    assert [c[2] for c in calls] == [P.counter("dynwin", v)
                                     for v in P.VARIANTS["dynwin"]]
    for _, args, _ in calls:
        assert all(type(a) is int for a in args)
        assert args[4:9] == (8, 4, 4, total, args[8])
    assert [c[1][8] for c in calls] == [0, 1, 2, 3]
    assert not hasattr(P, "_dynwin_tot")
    assert P.dynwin_place.__defaults__ == ("bulk",)
