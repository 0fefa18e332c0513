"""Hybrid hierarchy refactoring: blockwise 8^3 local decomposition + global
refactor of the coarse remainder (port of ``mgard_tpu/ops/hybrid.py``).

The local chain per axis is 8 -> 5 -> 3 -> 2 over in-block positions
{0..7} -> {0,2,4,6,7} -> {0,4,7} -> {0,7}, with geometric lerp weights
(reference: the IndexTable8x8x8/5x5x5/3x3x3 tables of
DataRefactoring/InCacheBlock/Decompose8x8x8.hpp). Neighbours never leave
their 8-block, so every 8^3 block transforms on its own.

The plain versions below work on a block view of the array,
(n0/8, 8, n1/8, 8, ...), where one level-axis interpolation pass is one
multiply-multiply-add per coefficient position. They compute ``wl*a + wr*b``
and ``v - w`` as separate IEEE float32 operations, exactly as the CUDA
kernels do, so kernel and plain version agree bit for bit on the card.

Six CUDA kernels carry the front end on the GPU: the flag-1 ("v2") pair
``local_transform_fused_v2`` (K1, csrc/hybrid_v2.cu) and
``local_inverse_fused_v2`` (K4), the fused transform+pack flag-2 ("v3")
pair ``local_transform_pack_v3`` (K10, csrc/hybrid_v3.cu) and
``unpack_inverse_v3`` (K11), and the flag-0 pair ``local_transform_fused``
(K7, csrc/hybrid.cu) and ``local_inverse_fused`` (K8) for 2D and 3D
fields. Each wrapper takes the plain version for a
tensor on the CPU and launches its kernel for a tensor on a CUDA device.

u16 payloads are carried as ``torch.int16`` tensors holding the u16 bit
patterns: torch has too few uint16 operators on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from .. import kernels
from ..hierarchy import Hierarchy

_CHAINS = [
    (0, 1, 2, 3, 4, 5, 6, 7),
    (0, 2, 4, 6, 7),
    (0, 4, 7),
    (0, 7),
]

# per local level: (coefficient position, left coarse nbr, right coarse nbr,
# t) with value = (1-t)*v[left] + t*v[right]
_LEVEL_CLASSES: List[List[Tuple[int, int, int, float]]] = []
for _lvl in range(3):
    _fine = _CHAINS[_lvl]
    _coarse = set(_CHAINS[_lvl + 1])
    _classes = []
    for _i, _p in enumerate(_fine):
        if _p in _coarse:
            continue
        _li = _i - 1
        while _fine[_li] not in _coarse:
            _li -= 1
        _ri = _i + 1
        while _fine[_ri] not in _coarse:
            _ri += 1
        _lp, _rp = _fine[_li], _fine[_ri]
        _classes.append((_p, _lp, _rp, (_p - _lp) / (_rp - _lp)))
    _LEVEL_CLASSES.append(_classes)


def _weights(t: float, dtype=torch.float32) -> Tuple[float, float]:
    """Lerp weights (wl, wr) rounded to the field's type, as the JAX
    package rounds them."""
    if dtype == torch.float64:
        return 1.0 - t, t
    return float(np.float32(1.0 - t)), float(np.float32(t))


def _rem_cols(num_levels: int):
    return _CHAINS[num_levels]


def _blocks(x):
    """(n0, n1, ...) -> (n0/8, 8, n1/8, 8, ...) view; all dims % 8 == 0."""
    shp = []
    for n in x.shape:
        shp += [n // 8, 8]
    return x.reshape(shp)


def _pos_mask(D: int, axis: int, positions, device):
    """In-block position mask along one axis, broadcastable over the block
    view of a D-dim array."""
    m = torch.zeros(8, dtype=torch.bool, device=device)
    m[list(positions)] = True
    shp = [1] * (2 * D)
    shp[2 * axis + 1] = 8
    return m.reshape(shp)


def _coeff_mask(D: int, lvl: int, device):
    """Level-lvl coefficient mask (block view): in the level grid on every
    axis and fine on at least one axis."""
    fine_pos = tuple(p for p, _, _, _ in _LEVEL_CLASSES[lvl])
    in_grid = any_fine = None
    for d in range(D):
        gb = _pos_mask(D, d, _CHAINS[lvl], device)
        fb = _pos_mask(D, d, fine_pos, device)
        in_grid = gb if in_grid is None else (in_grid & gb)
        any_fine = fb if any_fine is None else (any_fine | fb)
    return in_grid & any_fine


def corner_mask(shape, num_levels: int = 3, device="cpu"):
    """Boolean mask of the remainder (local-coarse-in-all-axes) positions."""
    D = len(shape)
    m = _pos_mask(D, 0, _rem_cols(num_levels), device)
    for d in range(1, D):
        m = m & _pos_mask(D, d, _rem_cols(num_levels), device)
    bshape = []
    for n in shape:
        bshape += [n // 8, 8]
    return m.expand(bshape).reshape(tuple(shape))


def _interp_pass(w6, axis: int, lvl: int):
    """One level-axis interpolation pass, in place on a block view: writes
    the level's coefficient positions, reads only coarse ones."""
    dim = 2 * axis + 1
    for p, lp, rp, t in _LEVEL_CLASSES[lvl]:
        wl, wr = _weights(t, w6.dtype)
        w6.select(dim, p).copy_(w6.select(dim, lp) * wl
                                + w6.select(dim, rp) * wr)


def local_decompose(v, num_levels: int = 3):
    """After level l the level-l fine positions hold multilinear
    interpolation coefficients; coarse positions keep their values. All
    dims must be multiples of 8."""
    D = v.ndim
    v6 = _blocks(v)
    for lvl in range(num_levels):
        w6 = v6.clone()
        for d in range(D):
            _interp_pass(w6, d, lvl)
        v6 = torch.where(_coeff_mask(D, lvl, v.device), v6 - w6, v6)
    return v6.reshape(v.shape)


def local_recompose(x, num_levels: int = 3):
    """Inverse of local_decompose (coarsest local level first)."""
    D = x.ndim
    x6 = _blocks(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for lvl in range(num_levels - 1, -1, -1):
        mask = _coeff_mask(D, lvl, x.device)
        y6 = torch.where(mask, zero, x6)
        for d in range(D):
            _interp_pass(y6, d, lvl)
        x6 = torch.where(mask, x6 + y6, x6)
    return x6.reshape(x.shape)


def extract_remainder(v, num_levels: int = 3):
    """Gather each 8-block's local-coarse corner grid into a compact array
    of shape n/8*k per axis (k = corners per axis)."""
    cols = torch.tensor(_rem_cols(num_levels), device=v.device)
    x = _blocks(v)
    for d in range(v.ndim):
        x = x.index_select(2 * d + 1, cols)
    k = len(_rem_cols(num_levels))
    return x.reshape(tuple(n // 8 * k for n in v.shape))


def insert_remainder(coeff_field, rem, num_levels: int = 3):
    """Place remainder values at their corner positions; every other
    position keeps coeff_field's value."""
    cols = torch.tensor(_rem_cols(num_levels), device=rem.device)
    k = len(_rem_cols(num_levels))
    shp = []
    for n in rem.shape:
        shp += [n // k, k]
    x = rem.reshape(shp)
    for d in range(rem.ndim):
        full = list(x.shape)
        full[2 * d + 1] = 8
        x = torch.zeros(full, dtype=x.dtype, device=x.device).index_copy_(
            2 * d + 1, cols, x)
    x = x.reshape(coeff_field.shape)
    mask = corner_mask(coeff_field.shape, num_levels, coeff_field.device)
    return torch.where(mask, x, coeff_field)


def zclass_group(sym):
    """Group the minor axis by position class (z mod 8):
    grouped[..., c*g + j] = natural[..., 8*j + c], g = n/8."""
    n = sym.shape[-1]
    x = sym.reshape(sym.shape[:-1] + (n // 8, 8))
    return x.transpose(-1, -2).reshape(sym.shape)


def zclass_ungroup(sym):
    """Inverse of zclass_group."""
    n = sym.shape[-1]
    x = sym.reshape(sym.shape[:-1] + (8, n // 8))
    return x.transpose(-1, -2).reshape(sym.shape)


def quantize(x, inv_q: float):
    """Round half away from zero of x*inv_q to int32 (never torch.round,
    which rounds half to even)."""
    t = x * inv_q
    return torch.trunc(torch.where(t < 0, t - 0.5, t + 0.5)).to(torch.int32)


def bit_length(x):
    """Bit length of non-negative int32 values (0 for 0), exact: every
    int32 is exact in float64 and frexp's exponent is the bit length."""
    e = torch.frexp(x.to(torch.float64)).exponent.to(torch.int32)
    return torch.where(x > 0, e, torch.zeros_like(e))


# ----------------------------------------------------------------------
# The flag-1 front end: plain versions and kernel wrappers
# ----------------------------------------------------------------------
def _tile_shape_v2(shape, vmem_budget_elems=1 << 19):
    """The flag-1 shape gate, kept from the JAX package so both packages
    take the v2 front end for the same shapes: 3D, every axis a multiple
    of 8, Z a multiple of 128 and at most 1024, and the (8, 8|128, Z) tile
    rule of the TPU kernel."""
    D = len(shape)
    if D != 3 or any(s % 8 for s in shape):
        return None
    Z = shape[-1]
    if Z % 128 or Z > 1024:
        return None
    t = [8, 8, Z]
    if int(np.prod(t)) > vmem_budget_elems:
        return None
    size = shape[1]
    best = 8
    cand = 16
    while cand <= size:
        if size % cand == 0 and 8 * cand * Z <= vmem_budget_elems:
            best = cand
        cand *= 2
    t[1] = best
    if t[1] % 128 and t[1] != size:
        if size % 128 == 0 and 8 * 128 * Z <= (1 << 20):
            t[1] = 128
        else:
            return None
    for s, ts in zip(shape, t):
        if s % ts:
            return None
    return tuple(t)


def local_transform_v2(v, inv_q: float, nl: int, C: int):
    """Plain version of K1. Returns (payload int16 (X, Y, Z) [u16 bits of
    the z-class grouped zigzag symbols], cw (X*Y*H,) int32 [true per-chunk
    widths of C*32 grouped symbols; > 16 means the u16 payload truncated
    that chunk and the caller must fall back], rem (X/8*k, Y/8*k, Z/8*k)
    float32 [corner values])."""
    Z = v.shape[-1]
    CL = C * 32
    sym, rem = local_transform(v, inv_q, nl)
    zz = (sym << 1) ^ (sym >> 31)
    grouped = zclass_group(zz)
    g3 = grouped.reshape(v.shape[:-1] + (Z // CL, CL))
    # a negative i32 is a zigzag code with bit 31 set: width 32
    w = bit_length(g3.amax(-1))
    cw = torch.where(g3.amin(-1) < 0, torch.full_like(w, 32), w).reshape(-1)
    pay = (grouped & 0xFFFF).to(torch.int16)
    return pay, cw, rem


def local_inverse_v2(pay, rem, q: float, nl: int):
    """Plain version of K4: int16 (u16 bits) grouped zigzag payload +
    compact remainder -> float32 field."""
    nat = zclass_ungroup(pay.to(torch.int32) & 0xFFFF)
    return local_inverse((nat >> 1) ^ -(nat & 1), rem, q, nl)


def _v2_geometry(shape, nl: int):
    if _tile_shape_v2(tuple(shape)) is None:
        raise ValueError(f"shape {tuple(shape)} fails the flag-1 gate")
    if nl not in (1, 2, 3):
        raise ValueError(f"num_levels must be 1..3, got {nl}")
    return tuple(shape), remainder_shape(shape, nl)


def local_transform_fused_v2(v, inv_q: float, nl: int, C: int):
    """K1 wrapper (replaces mgard_tpu/ops/hybrid.py
    local_transform_fused_v2): the one-pass cf front end. Same outputs as
    local_transform_v2. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    (X, Y, Z), rem_shape = _v2_geometry(v.shape, nl)
    if C < 1 or Z % (C * 32):
        raise ValueError(f"chunk rows of {C}*32 must tile Z={Z}")
    H = Z // (C * 32)
    kernels.check_tensor("v", v, torch.float32, (X, Y, Z), v.device)
    if v.device.type == "cpu":
        return local_transform_v2(v, inv_q, nl, C)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    pay = torch.empty((X, Y, Z), dtype=torch.int16, device=v.device)
    cw = torch.empty((X * Y * H,), dtype=torch.int32, device=v.device)
    rem = torch.empty(rem_shape, dtype=torch.float32, device=v.device)
    kernels.launch("hybrid_fwd_v2", v.data_ptr(), float(np.float32(inv_q)),
                   pay.data_ptr(), cw.data_ptr(), rem.data_ptr(), X, Y, Z,
                   C, nl, kernels.stream(v.device))
    return pay, cw, rem


def local_inverse_fused_v2(pay, rem, q: float, nl: int):
    """K4 wrapper (replaces mgard_tpu/ops/hybrid.py
    local_inverse_fused_v2): ungroup + un-zigzag + dequantize + corner
    insert + local recompose. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    (X, Y, Z), rem_shape = _v2_geometry(pay.shape, nl)
    kernels.check_tensor("pay", pay, torch.int16, (X, Y, Z), pay.device)
    kernels.check_tensor("rem", rem, torch.float32, rem_shape, pay.device)
    if pay.device.type == "cpu":
        return local_inverse_v2(pay, rem, q, nl)
    if pay.device.type != "cuda":
        raise ValueError(f"no kernel for device {pay.device}")
    out = torch.empty((X, Y, Z), dtype=torch.float32, device=pay.device)
    kernels.launch("hybrid_inv_v2", pay.data_ptr(), rem.data_ptr(),
                   float(np.float32(q)), out.data_ptr(), X, Y, Z, nl,
                   kernels.stream(pay.device))
    return out


# ----------------------------------------------------------------------
# The fused flag-2 ("v3") front end: the transform and the BFP pack in one
# entry point. Each (8, 128, Z) tile of the field is one BFP superblock of
# sbc = 1024 chunks (one (x, y) row of Z grouped symbols each, C = Z/32
# blocks), chunks in tile-major order, residual planes in the static-cap
# layout (lossless/bfp.py _static_plan).
# ----------------------------------------------------------------------
V3_SBC = 1024


def _v3_geom(Z: int, E: int):
    """(C, sb, sbc, rows per plane, CAP, BPR) of the tile = superblock
    scheme: C blocks a chunk, sb blocks and sbc chunks a superblock, CAP
    residual rows of 128 words a superblock, BPR rows a band."""
    C = Z // 32
    sb = 32 * Z
    plane_rows = sb // 128
    return C, sb, V3_SBC, plane_rows, E * plane_rows, V3_SBC // 128


def v3_ok_shape(shape) -> bool:
    """Shape gate of the fused scheme: 3D, (8, 128, Z) tiles with
    128 | Z <= 1024, so one tile is exactly one superblock of 1024 chunks."""
    if len(shape) != 3:
        return False
    X, Y, Z = shape
    return X % 8 == 0 and Y % 128 == 0 and Z % 128 == 0 and 128 <= Z <= 1024


def field_rows_tilemajor(pay3d):
    """(X, Y, Z) payload -> (NC, Z) rows in tile-major chunk order: tiles of
    (8, 128) leading positions in (gx, gy) row-major order, row-major
    inside a tile."""
    X, Y, Z = pay3d.shape
    GX, GY = X // 8, Y // 128
    return (pay3d.reshape(GX, 8, GY, 128, Z).permute(0, 2, 1, 3, 4)
            .reshape(GX * GY * V3_SBC, Z))


def rows_tilemajor_field(rows, shape):
    """Inverse of field_rows_tilemajor."""
    X, Y, Z = shape
    GX, GY = X // 8, Y // 128
    return (rows.reshape(GX, GY, 8, 128, Z).permute(0, 2, 1, 3, 4)
            .reshape(X, Y, Z))


def transform_pack_v3(v, inv_q: float, nl: int, K: int, E: int):
    """Plain version of K10. Returns (base (NSB, K, C, 1024) int32 [sorted
    chunk order], resid (NSB*CAP, 128) int32 [static-cap layout], cw (NSB,
    1024) int32 [tile-major widths; one zigzag code over 16 bits sets all
    1024 widths of its tile to 32 and the caller must fall back], rem)."""
    from ..lossless import bfp

    X, Y, Z = v.shape
    C, sb, sbc, _, _, _ = _v3_geom(Z, E)
    pay, cw_rm, rem = local_transform_v2(v, inv_q, nl, C)
    GX, GY = X // 8, Y // 128
    cw = (cw_rm.reshape(GX, 8, GY, 128).permute(0, 2, 1, 3)
          .reshape(GX * GY, sbc))
    over = (cw > 16).any(1, keepdim=True)
    cw = torch.where(over, torch.full_like(cw, 32), cw)
    crl = (cw - K).clamp(0, E).reshape(-1)
    rows = field_rows_tilemajor(pay).contiguous()
    base, resid = bfp.encode_core_zz(rows, crl, K, E, sb, C,
                                     static_cap=True)
    return base, resid, cw, rem


def unpack_inverse_v3_plain(base, crl, resid, rem, q: float, nl: int, K: int,
                            E: int, shape):
    """Plain version of K11: static-cap banded payload + crl (NSB, 1024)
    + compact remainder -> float32 field of ``shape``."""
    from ..lossless import bfp

    Z = shape[-1]
    C, sb, _, _, _, _ = _v3_geom(Z, E)
    NB = int(np.prod(shape)) // 32
    rows = bfp.decode_core_zz(base, crl.reshape(-1), resid, K, E, sb, NB, C,
                              static_cap=True)
    pay = rows_tilemajor_field(rows, shape).contiguous()
    return local_inverse_v2(pay, rem, q, nl)


def _v3_geometry(shape, nl: int, K: int, E: int):
    if not v3_ok_shape(tuple(shape)):
        raise ValueError(f"shape {tuple(shape)} fails the flag-2 gate")
    if nl not in (1, 2, 3):
        raise ValueError(f"num_levels must be 1..3, got {nl}")
    if not (1 <= E <= 15 and K >= 0 and K + E <= 16):
        raise ValueError(f"K={K}, E={E}: need 1 <= E <= 15 and K + E <= 16")
    X, Y, Z = shape
    return (X, Y, Z), remainder_shape(shape, nl), (X // 8) * (Y // 128)


def local_transform_pack_v3(v, inv_q: float, nl: int, K: int, E: int):
    """K10 wrapper (replaces mgard_tpu/ops/hybrid.py
    local_transform_pack_v3): field -> banded BFP payload, same outputs as
    transform_pack_v3. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (one pass, a cluster of 16 blocks per tile)."""
    (X, Y, Z), rem_shape, NSB = _v3_geometry(v.shape, nl, K, E)
    if K < 1:
        raise ValueError("the fused pack needs at least one base plane")
    kernels.check_tensor("v", v, torch.float32, (X, Y, Z), v.device)
    if v.device.type == "cpu":
        return transform_pack_v3(v, inv_q, nl, K, E)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    C, _, sbc, _, CAP, _ = _v3_geom(Z, E)
    dev = v.device
    # every word of base and resid is written by the kernel
    base = torch.empty((NSB, K, C, sbc), dtype=torch.int32, device=dev)
    resid = torch.empty((NSB * CAP, 128), dtype=torch.int32, device=dev)
    cw = torch.empty((NSB, sbc), dtype=torch.int32, device=dev)
    rem = torch.empty(rem_shape, dtype=torch.float32, device=dev)
    kernels.launch("hybrid_pack_v3", v.data_ptr(), float(np.float32(inv_q)),
                   base.data_ptr(), resid.data_ptr(), cw.data_ptr(),
                   rem.data_ptr(), X, Y, Z, nl, K, E, kernels.stream(dev))
    return base, resid, cw, rem


def unpack_inverse_v3(base, crl, resid, rem, q: float, nl: int, K: int,
                      E: int, shape):
    """K11 wrapper (replaces mgard_tpu/ops/hybrid.py unpack_inverse_v3):
    same output as unpack_inverse_v3_plain. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    (X, Y, Z), rem_shape, NSB = _v3_geometry(shape, nl, K, E)
    C, _, sbc, _, CAP, _ = _v3_geom(Z, E)
    dev = base.device
    kernels.check_tensor("base", base, torch.int32,
                         (NSB, max(K, 1), C, sbc), dev)
    kernels.check_tensor("crl", crl, torch.int32, (NSB, sbc), dev)
    kernels.check_tensor("resid", resid, torch.int32, (NSB * CAP, 128), dev)
    kernels.check_tensor("rem", rem, torch.float32, rem_shape, dev)
    if dev.type == "cpu":
        return unpack_inverse_v3_plain(base, crl, resid, rem, q, nl, K, E,
                                       (X, Y, Z))
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    kernels.launch("hybrid_unpack_v3", base.data_ptr(), crl.data_ptr(),
                   resid.data_ptr(), rem.data_ptr(), float(np.float32(q)),
                   out.data_ptr(), X, Y, Z, nl, K, E, kernels.stream(dev))
    return out


def v3_max_active_clusters(Z: int):
    """(K10, K11): how many of the kernels' 16-block clusters the current
    CUDA card holds at once at depth Z (cudaOccupancyMaxActiveClusters)."""
    out = (ctypes.c_int * 2)()
    rc = kernels.lib().hybrid_v3_max_clusters(Z, out)
    if rc:
        raise RuntimeError(f"hybrid_v3_max_clusters: CUDA error {rc}")
    return out[0], out[1]


# ----------------------------------------------------------------------
# The flag-0 front end: plain versions and kernel wrappers
# ----------------------------------------------------------------------
def _tile_shape(shape):
    """The JAX package's gate of its fused flag-0 kernels (a VMEM tile:
    2D/3D, every axis a multiple of 8, the minor axis a multiple of 128
    within the tile budget), kept so both packages agree on which shapes
    the TPU fuses. On the GPU every 2D/3D shape whose axes are multiples of
    8 takes K7/K8; this gate does not route the port."""
    D = len(shape)
    if D > 3 or D < 2 or any(s % 8 for s in shape) or shape[-1] % 128:
        return None
    budget = 1 << 19
    t = [8] * D
    t[-1] = shape[-1]
    if int(np.prod(t)) > budget:
        return None
    d = D - 2
    size = shape[d]
    best = 8
    cand = 8
    while cand <= size:
        if size % cand == 0 and int(np.prod(t[:d])) * cand * t[-1] <= budget:
            best = cand
        cand *= 2
    t[d] = best
    if any(s % ts for s, ts in zip(shape, t)):
        return None
    return tuple(t)


def local_transform(v, inv_q: float, nl: int):
    """Plain version of K7: local decompose + corner split + quantize.
    Returns (sym int32 of v's shape [natural order, 0 at the corners],
    rem float32 (n/8*k per axis) [corner values]). Any rank."""
    dec = local_decompose(v, nl)
    rem = extract_remainder(dec, nl)
    zero = torch.zeros((), dtype=dec.dtype, device=dec.device)
    cf = torch.where(corner_mask(dec.shape, nl, dec.device), zero, dec)
    return quantize(cf, inv_q), rem


def local_inverse(sym, rem, q: float, nl: int):
    """Plain version of K8: dequantize + corner insert + local recompose,
    in the remainder's type. Any rank."""
    cf = sym.to(rem.dtype) * q
    return local_recompose(insert_remainder(cf, rem, nl), nl)


def _fused_geometry(shape, nl: int):
    if len(shape) not in (2, 3) or any(s < 8 or s % 8 for s in shape):
        raise ValueError(f"shape {tuple(shape)}: the flag-0 kernels take 2D "
                         "and 3D fields with every axis a multiple of 8")
    if nl not in (1, 2, 3):
        raise ValueError(f"num_levels must be 1..3, got {nl}")
    X, Y, Z = (1,) + tuple(shape) if len(shape) == 2 else tuple(shape)
    return (X, Y, Z), remainder_shape(shape, nl)


def local_transform_fused(v, inv_q: float, nl: int):
    """K7 wrapper (replaces mgard_tpu/ops/hybrid.py local_transform_fused):
    same outputs as local_transform, for 2D and 3D float32 fields with
    every axis a multiple of 8. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    (X, Y, Z), rem_shape = _fused_geometry(v.shape, nl)
    kernels.check_tensor("v", v, torch.float32, v.shape, v.device)
    if v.device.type == "cpu":
        return local_transform(v, inv_q, nl)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    sym = torch.empty(v.shape, dtype=torch.int32, device=v.device)
    rem = torch.empty(rem_shape, dtype=torch.float32, device=v.device)
    kernels.launch("hybrid_fwd", v.data_ptr(), float(np.float32(inv_q)),
                   sym.data_ptr(), rem.data_ptr(), X, Y, Z, nl,
                   kernels.stream(v.device))
    return sym, rem


def local_inverse_fused(sym, rem, q: float, nl: int):
    """K8 wrapper (replaces mgard_tpu/ops/hybrid.py local_inverse_fused):
    same output as local_inverse, for 2D and 3D fields. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    (X, Y, Z), rem_shape = _fused_geometry(sym.shape, nl)
    kernels.check_tensor("sym", sym, torch.int32, sym.shape, sym.device)
    kernels.check_tensor("rem", rem, torch.float32, rem_shape, sym.device)
    if sym.device.type == "cpu":
        return local_inverse(sym, rem, q, nl)
    if sym.device.type != "cuda":
        raise ValueError(f"no kernel for device {sym.device}")
    out = torch.empty(sym.shape, dtype=torch.float32, device=sym.device)
    kernels.launch("hybrid_inv", sym.data_ptr(), rem.data_ptr(),
                   float(np.float32(q)), out.data_ptr(), X, Y, Z, nl,
                   kernels.stream(sym.device))
    return out


def hybrid_l_total(shape, num_levels: int, rem_hier: Hierarchy) -> int:
    """Total number of coarsening levels of the hybrid hierarchy."""
    return num_levels + rem_hier.l_target


def remainder_shape(shape, num_levels: int):
    k = len(_rem_cols(num_levels))
    return tuple(s // 8 * k for s in shape)


def pad_to8(shape):
    return tuple((s + 7) // 8 * 8 for s in shape)
