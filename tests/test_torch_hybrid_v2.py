"""PyTorch port, hybrid flag-1 front end: the plain versions of K1/K4 (what
the wrappers run for CPU tensors) against the JAX XLA oracles and the
interpret-mode Pallas kernels.

Payloads: the integer stages are exact, but quantize is float: a value on
a .5 rounding boundary can flip by one symbol (zigzag delta <= 2) where one
side fuses a multiply-add, on a trace fraction (< 1e-4) of the symbols —
the same contract as tests/test_hybrid_v2.py. Widths and layout are equal;
float outputs agree to atol=1e-6 on an O(1) field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgard_tpu.ops import hybrid as JH
from mgard_tpu_torch.ops import hybrid as TH

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

NL = 3
CASES = [((16, 16, 128), 4), ((8, 128, 768), 8)]


def _field(shape):
    rng = np.random.default_rng(3)
    x = np.linspace(0, 1, shape[0], dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        * np.cos(np.linspace(0, 3, shape[1], dtype=np.float32))[None, :, None]
        + np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :] ** 2
        + 0.05 * rng.standard_normal(shape).astype(np.float32)
    )
    return v.astype(np.float32)


def _inv_q(q):
    return np.float32(1.0) / np.float32(q)


def _payload_close(pt, pj):
    a = pt.numpy().view(np.uint16).astype(np.int64)
    b = np.asarray(pj).astype(np.int64)
    assert a.shape == b.shape
    mism = a != b
    assert mism.mean() < 1e-4, mism.mean()
    assert np.abs(a - b)[mism].max(initial=0) <= 2


@pytest.mark.parametrize("shape,C", CASES)
@pytest.mark.parametrize("ref", ["xla_oracle", "pallas_interpret"])
def test_forward_matches_jax(shape, C, ref):
    v = _field(shape)
    inv_q = _inv_q(1.7e-4)
    if ref == "xla_oracle":
        pj, cwj, remj = JH.local_transform_v2_xla(jnp.asarray(v),
                                                  jnp.float32(inv_q), NL, C)
    else:
        pj, cwj, remj = JH.local_transform_fused_v2(
            jnp.asarray(v), jnp.float32(inv_q), NL, C, interpret=True)
    pt, cwt, remt = TH.local_transform_fused_v2(torch.from_numpy(v),
                                                float(inv_q), NL, C)
    assert int(cwt.max()) <= 16
    np.testing.assert_array_equal(cwt.numpy(), np.asarray(cwj))
    _payload_close(pt, pj)
    np.testing.assert_allclose(remt.numpy(), np.asarray(remj), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shape,C", CASES)
def test_inverse_matches_jax(shape, C):
    v = _field(shape)
    q = np.float32(1.7e-4)
    pj, _cw, remj = JH.local_transform_v2_xla(jnp.asarray(v),
                                              jnp.float32(_inv_q(q)), NL, C)
    outj = JH.local_inverse_v2_xla(pj, remj, jnp.float32(q), NL,
                                   jnp.float32)
    pay = torch.from_numpy(np.asarray(pj).view(np.int16).copy())
    outt = TH.local_inverse_fused_v2(pay, torch.from_numpy(np.array(remj)),
                                     float(q), NL)
    np.testing.assert_allclose(outt.numpy(), np.asarray(outj), rtol=0,
                               atol=1e-6)
    # round trip: quantization is the only loss
    assert float(np.max(np.abs(outt.numpy() - v))) <= float(q) * (NL + 2)


def test_forward_overflow_reports_wide_chunks():
    """Symbols over the u16 budget must show as cw > 16 (flag-0 path)."""
    v = _field((16, 16, 128)) * np.float32(1e6)
    _, cw, _ = TH.local_transform_fused_v2(torch.from_numpy(v),
                                           float(_inv_q(1e-6)), NL, 4)
    assert int(cw.max()) > 16


@pytest.mark.parametrize("nl", [1, 2, 3])
def test_whole_array_pieces_match_jax(nl):
    """local_decompose/recompose, remainder split/insert, corner mask and
    z-class grouping against the JAX whole-array functions."""
    v = _field((16, 8, 32))
    dj = np.array(JH.local_decompose(jnp.asarray(v), nl))
    dt = TH.local_decompose(torch.from_numpy(v), nl)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-6)
    rj = np.array(JH.extract_remainder(jnp.asarray(dj), nl))
    np.testing.assert_array_equal(
        TH.extract_remainder(torch.from_numpy(dj), nl).numpy(), rj)
    np.testing.assert_array_equal(
        TH.corner_mask(v.shape, nl).numpy(),
        np.asarray(JH.corner_mask(v.shape, nl)))
    ins = TH.insert_remainder(torch.zeros(v.shape), torch.from_numpy(rj), nl)
    np.testing.assert_array_equal(
        ins.numpy(), np.asarray(JH.insert_remainder(jnp.zeros(v.shape),
                                                    jnp.asarray(rj), nl)))
    np.testing.assert_allclose(
        TH.local_recompose(torch.from_numpy(dj), nl).numpy(),
        np.asarray(JH.local_recompose(jnp.asarray(dj), nl)),
        rtol=0, atol=1e-6)
    s = np.arange(16 * 8 * 32, dtype=np.int32).reshape(16, 8, 32)
    g = TH.zclass_group(torch.from_numpy(s))
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(JH.zclass_group(jnp.asarray(s))))
    np.testing.assert_array_equal(TH.zclass_ungroup(g).numpy(), s)


@pytest.mark.parametrize("shape,ok", [
    ((64, 64, 128), True), ((8, 128, 768), True), ((64, 64, 100), False),
    ((64, 64, 2048), False), ((16, 24, 128), False),
])
def test_flag1_shape_gate_matches_jax(shape, ok):
    assert (TH._tile_shape_v2(shape) is not None) is ok
    assert TH._tile_shape_v2(shape) == JH._tile_shape_v2(shape)


# ----------------------------------------------------------------------
# The register-line schedule of K1/K4 (csrc/line8.cuh, csrc/hybrid_v2.cu),
# emulated in NumPy float32 and held bit for bit against the plain
# versions; no JAX. A warp holds one 8^3 block, lane (xi, j) the z lines
# y = 2j ("a") and y = 2j + 1 ("b"); x and y passes read other lanes'
# lines as the shuffles do, z runs along the line, and only the level's
# chain points are computed. The per-chunk widths are taken per tile of
# K1's 16 z-blocks, one (line, class) run at a time, as the kernel stores
# them.
# ----------------------------------------------------------------------
_CHAIN = (0xFF, 0xD5, 0x91, 0x81)
_FWD_NB = 16  # z-blocks a tile of K1 (hybrid_v2.cu FWD_NB)


def _in(lvl, p):
    return bool((_CHAIN[lvl] >> p) & 1)


def _fine(lvl, p):
    return bool(((_CHAIN[lvl] & ~_CHAIN[lvl + 1]) >> p) & 1)


def _rule(lvl, p):
    """local8.cuh::lerp_rule: (lp, rp, wl, wr) of a fine position."""
    if lvl == 0:
        return p - 1, p + 1, np.float32(0.5), np.float32(0.5)
    if lvl == 1 and p == 2:
        return 0, 4, np.float32(0.5), np.float32(0.5)
    if lvl == 1:
        return 4, 7, np.float32(1.0 - 2.0 / 3.0), np.float32(2.0 / 3.0)
    return 0, 7, np.float32(1.0 - 4.0 / 7.0), np.float32(4.0 / 7.0)


def _lerp(wl, left, wr, right):
    return wl * left + wr * right  # float32: each product and the sum rounded


def _interp_level(w, lvl):
    """x, y and z passes of one level on w = {"a", "b"}: (n, 8 xi, 4 j, 8 z)
    float32 arrays, in place, at the level's chain z only."""
    zs = [z for z in range(8) if _in(lvl, z)]
    for xi in range(8):  # x: lanes (lx, j) and (rx, j), both lines
        if not _fine(lvl, xi):
            continue
        lp, rp, wl, wr = _rule(lvl, xi)
        for s in "ab":
            for z in zs:
                w[s][:, xi, :, z] = _lerp(wl, w[s][:, lp, :, z],
                                          wr, w[s][:, rp, :, z])
    fine_slot = "b" if lvl == 0 else "a"
    for j in range(4):  # y: at most one fine line a lane
        y = 2 * j + (lvl == 0)
        if not _fine(lvl, y):
            continue
        lp, rp, wl, wr = _rule(lvl, y)
        for z in zs:
            # a left neighbour is an "a" line (the lane's own at level 0)
            assert lp % 2 == 0 and (lvl != 0 or lp // 2 == j)
            left = w["a"][:, :, lp // 2, z]
            if rp // 2 == j:  # the lane's own other line
                right = w["b" if rp % 2 else "a"][:, :, j, z]
            else:  # another lane's line, the slot its shuffle sends
                slot = "b" if lvl == 2 else "a"
                assert (rp % 2 == 1) == (slot == "b")
                right = w[slot][:, :, rp // 2, z]
            w[fine_slot][:, :, j, z] = _lerp(wl, left, wr, right)
    for s in "ab":  # z: along the line
        for z in range(8):
            if _fine(lvl, z):
                lp, rp, wl, wr = _rule(lvl, z)
                w[s][..., z] = _lerp(wl, w[s][..., lp], wr, w[s][..., rp])


def _coeff_lanes(lvl):
    """Level-lvl coefficient mask over (8 xi, 4 j, 8 z) for both lines."""
    out = {}
    for s, off in (("a", 0), ("b", 1)):
        m = np.zeros((8, 4, 8), dtype=bool)
        for xi in range(8):
            for j in range(4):
                y = 2 * j + off
                for z in range(8):
                    m[xi, j, z] = (_in(lvl, xi) and _in(lvl, y) and _in(lvl, z)
                                   and (_fine(lvl, xi) or _fine(lvl, y)
                                        or _fine(lvl, z)))
        out[s] = m
    return out


def _to_lines(v):
    """(X, Y, Z) -> ({"a", "b"}: (X/8, Y/8, Z/8, 8 xi, 4 j, 8 z))."""
    X, Y, Z = v.shape
    b = v.reshape(X // 8, 8, Y // 8, 8, Z // 8, 8).transpose(0, 2, 4, 1, 3, 5)
    return {"a": b[..., 0::2, :].copy(), "b": b[..., 1::2, :].copy()}


def _from_lines(lines, shape):
    X, Y, Z = shape
    b = np.empty((X // 8, Y // 8, Z // 8, 8, 8, 8), lines["a"].dtype)
    b[..., 0::2, :], b[..., 1::2, :] = lines["a"], lines["b"]
    return b.transpose(0, 3, 1, 4, 2, 5).reshape(shape)


def _flat(lines):
    return {s: a.reshape((-1,) + a.shape[3:]) for s, a in lines.items()}


def emulate_fwd_lines(v, inv_q, nl, C):
    """K1's schedule: (payload int16, cw int32, rem float32)."""
    X, Y, Z = v.shape
    lines = _to_lines(v)
    flat = _flat(lines)
    for lvl in range(nl):
        w = {s: a.copy() for s, a in flat.items()}
        _interp_level(w, lvl)
        m = _coeff_lanes(lvl)
        for s in "ab":
            flat[s] = np.where(m[s], flat[s] - w[s], flat[s])
    dec = _from_lines({s: a.reshape(lines[s].shape) for s, a in flat.items()},
                      v.shape)
    cols = [p for p in range(8) if _in(nl, p)]
    rem = dec.reshape(X // 8, 8, Y // 8, 8, Z // 8, 8)[:, cols][:, :, :, cols][
        ..., cols].reshape(X // 8 * len(cols), Y // 8 * len(cols), -1)
    cmask = np.zeros((8, 8, 8), dtype=bool)
    cmask[np.ix_(cols, cols, cols)] = True
    cm = np.tile(cmask, (X // 8, Y // 8, Z // 8))
    t = (dec * np.float32(inv_q)).astype(np.float32)
    h = np.where(t < 0, t - np.float32(0.5), t + np.float32(0.5))
    sym = np.where(cm, 0, np.trunc(h)).astype(np.int32)
    zz = ((sym << 1) ^ (sym >> 31)).view(np.uint32)
    # payload runs: grouped slot c*g + jz holds natural z = 8*jz + c
    g = Z // 8
    pay = np.empty((X, Y, Z), dtype=np.uint16)
    nat = zz.reshape(X, Y, g, 8)
    CL, H = C * 32, Z // (C * 32)
    wid = np.frexp(zz.astype(np.float64))[1].reshape(X, Y, g, 8)  # bit length
    cw = np.zeros((X, Y, H), dtype=np.int64)
    NB = _FWD_NB
    for t0 in range(0, g, NB):  # tile t0 // NB
        for c in range(8):
            hc = (c * g + t0) // CL
            run = nat[:, :, t0:t0 + NB, c]
            pay[:, :, c * g + t0:c * g + t0 + NB] = (run & 0xFFFF)
            assert (c * g + t0 + NB - 1) // CL == hc  # a run is in one chunk
            cw[:, :, hc] = np.maximum(cw[:, :, hc],
                                      wid[:, :, t0:t0 + NB, c].max(-1))
    return (torch.from_numpy(pay.view(np.int16)),
            torch.from_numpy(cw.reshape(-1).astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(rem)))


def emulate_inv_lines(pay, rem, q, nl):
    """K4's schedule: the recomposed float32 field."""
    X, Y, Z = pay.shape
    g = Z // 8
    nat = pay.numpy().view(np.uint16).astype(np.uint32).reshape(
        X, Y, 8, g).transpose(0, 1, 3, 2).reshape(X, Y, Z)
    sym = ((nat >> 1) ^ (-(nat & 1).astype(np.int64)).astype(np.uint32)
           ).view(np.int32)
    val = (sym.astype(np.float32) * np.float32(q)).astype(np.float32)
    cols = [p for p in range(8) if _in(nl, p)]
    k = len(cols)
    vb = val.reshape(X // 8, 8, Y // 8, 8, Z // 8, 8)
    rb = rem.numpy().reshape(X // 8, k, Y // 8, k, Z // 8, k)
    for a, xa in enumerate(cols):
        for b, yb in enumerate(cols):
            for c, zc in enumerate(cols):
                vb[:, xa, :, yb, :, zc] = rb[:, a, :, b, :, c]
    lines = _to_lines(vb.reshape(X, Y, Z))
    flat = _flat(lines)
    for lvl in range(nl - 1, -1, -1):
        m = _coeff_lanes(lvl)
        y = {s: np.where(m[s], np.float32(0), flat[s]) for s in "ab"}
        _interp_level(y, lvl)
        for s in "ab":
            flat[s] = np.where(m[s], flat[s] + y[s], flat[s])
    return torch.from_numpy(_from_lines(
        {s: a.reshape(lines[s].shape) for s, a in flat.items()}, (X, Y, Z)))


def _lines_field(kind, shape):
    rng = np.random.default_rng({"smooth": 11, "noise": 12, "wide": 13}[kind])
    if kind == "smooth":
        return _field(shape), 1.0 / 1.7e-4
    v = rng.standard_normal(shape).astype(np.float32)
    if kind == "wide":  # one code with bit 31 set: its chunk's width is 32
        v[3, 5, 77] = np.float32(1.6e9)
        return v, 1.0
    return v, 1.0 / 3e-3


@pytest.mark.parametrize("nl", [1, 2, 3])
@pytest.mark.parametrize("kind,shape,C", [
    ("smooth", (16, 16, 128), 4), ("noise", (8, 24, 384), 1),
    ("wide", (8, 16, 256), 2), ("smooth", (8, 8, 1024), 16),
    ("noise", (24, 8, 384), 3), ("noise", (40, 16, 128), 2)])
def test_register_line_schedule_matches_plain(kind, shape, C, nl):
    v, inv_q = _lines_field(kind, shape)
    inv_q = float(np.float32(inv_q))
    got = emulate_fwd_lines(v, inv_q, nl, C)
    ref = TH.local_transform_v2(torch.from_numpy(v), inv_q, nl, C)
    for name, a, b in zip(("payload", "cw", "rem"), got, ref):
        assert torch.equal(a, b), name
    if kind == "wide":
        assert int(ref[1].max()) == 32
    q = float(np.float32(1.0 / inv_q))
    out = emulate_inv_lines(ref[0], ref[2], q, nl)
    want = TH.local_inverse_v2(ref[0], ref[2], q, nl)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
