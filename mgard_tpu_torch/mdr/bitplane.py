"""Bitplane encoder/decoder with error collection (port of
``mgard_tpu/mdr/bitplane.py``).

Layout: the level stream (n,) is viewed as (32, m) with m = n/32 — element
i sits at (i // m, i % m) — and ALL planes come out of one 32x32 bit
transpose over that view: word j of a plane packs the 32 elements {j, m+j,
2m+j, ...} (bit k = element k*m + j). Plane order is [sign, MSB..LSB]
(sign-magnitude) or [MSB..LSB] (NegaBinary).

float32 streams quantize integer-exactly from the IEEE-754 bit pattern (no
float64 pass): mantissa, exponent and sign give the fixed-point magnitude,
the rounding residue (exactly remi * 2^-kc) and the sign, so every device
produces the same planes. The error tables hold, per number b of magnitude
planes kept, max |d_b| and sum d_b^2 of the reconstruction error in
fixed-point units, with a small relative inflation (``_F32_SLACK*``) that
keeps them true upper bounds. float64 streams take an exact float64 path.

Kernel K9 (``csrc/bitplane.cu``, wrapper ``encode_core``) does the float32
sign-magnitude encode of a level of at least ``_KERNEL_MIN`` elements (a
whole number of them) in one launch: quantize, butterfly, planes and every
table entry's partials, one partial per 32 columns. A block of four warps
owns 32 columns, a column a lane: each warp quantizes eight rows of them
and leaves each element's (magnitude, mask below its top bit, residue,
magnitude as float) in a 16-byte slot of shared memory; warp 0 transposes
the columns and stores the plane words as whole warp rows; then each warp
takes a chunk of at most 9 of the B+1 table entries for the 32 columns
and folds its lanes' column partials through shared memory. The kernel is
bound by instruction issue, not bytes (six instructions per element and
entry where the residual's remainder is below 2^23: the exact difference
of two floats offset by 2^23 in place of an int-to-float conversion; at
B = 32 the other 9 entries convert). Splitting the entries over four
warps also fills the card at the coarse levels, where one thread a column
walked all 33 entries alone. ``encode_core_plain``
beside it is its plain version. Smaller levels take the plain version on
every device, as the JAX package runs XLA for them on a TPU too.
Everything else (decode, NegaBinary, float64) is plain torch.

Packed words are int32 bit patterns (torch lacks shifts on uint32); logical
right shifts mask the sign-extended bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..lossless.bfx import _bit_transpose32
from ..utils.trace import to_device, to_host

LANES = 32

# Kernel tile: _MC columns of the (32, m) view. Streams of >= _KERNEL_MIN
# elements pad to a whole number of tiles — the same padding on every
# device (it is part of the wire format); smaller levels pad to 32.
_MC = 2048
_KERNEL_MIN = LANES * _MC

# Inflation of the float32-path error tables: covers the residue's float32
# representation (2 ulp) and the staged float32 square sums (a 32-term
# stage per column and a 32-term stage per 32 columns, then float64: each
# stage's relative error is below 32 * 2^-24 < 2e-6, K9's fused square
# d*d + sq included), so the tables stay true upper bounds for retrieval
# planning.
_F32_SLACK = 1.0 + 1e-5
_F32_SLACK_SQ = 1.0 + 1e-4

_I32 = torch.int32
_F32 = torch.float32
_F64 = torch.float64
_INT_MIN = -(2**31)


def padded_len(n: int) -> int:
    """Encoded stream length for a level of n elements (padding policy)."""
    if n >= _KERNEL_MIN:
        return n + (-n) % _KERNEL_MIN
    return n + (-n) % LANES


def padded_words(n: int) -> int:
    """Words per plane for a level of n elements."""
    return padded_len(n) // LANES


def pad_stream(stream):
    """Zero-pad a flat level stream to the encoded length."""
    n = int(stream.shape[0])
    p = padded_len(n) - n
    if p:
        stream = torch.cat([stream, stream.new_zeros(p)])
    return stream


def _wrap32(x):
    """int64 -> int32 modulo 2^32 (the JAX package's int32 arithmetic)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(_I32)


# ----------------------------------------------------------------------
# Integer-exact float32 fixed-point quantization
# ----------------------------------------------------------------------
def _int_quantize_f32(v, exp, frac_bits: int, lim: int):
    """p := |v| * 2^(frac_bits - exp), exactly. Returns int32 tensors
      mag  : round-half-away(p), clamped to lim
      remi : residue numerator, p - mag == remi * 2^-kc (modulo 2^32)
      kc   : residue scale in [0, 31] (below 2^-31 the residue magnitude
             is overestimated, so tables built from it stay upper bounds)
      sign : raw IEEE sign bit (negative zero counts negative).
    Requires frac_bits <= 31 and exp >= ceil(log2(max|v|)); ``exp`` is an
    int32 scalar tensor (or int). Shifts run in int64 and wrap to int32 at
    the end, which gives the JAX package's int32 results bit for bit."""
    bits = v.contiguous().view(_I32)
    sign = (bits >> 31) & 1
    ebits = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    issub = ebits == 0
    mant24 = torch.where(issub, mant, mant | 0x800000).long()
    e = torch.where(issub, -126, ebits - 127)
    sh = (e - 23 + (frac_bits - exp)).long()
    pos = sh >= 0
    shl = torch.where(pos, sh, 0)
    kc = torch.where(pos, 0, torch.clamp(-sh, max=31))
    half = (torch.ones_like(kc) << kc) >> 1
    up = mant24 << shl
    f_unc = torch.where(pos, up, (mant24 + half) >> kc)
    mag = torch.clamp(f_unc, max=lim)
    return mag.to(_I32), _wrap32(up - (mag << kc)), kc.to(_I32), sign


def _residue_f32(remi, kc):
    """remi * 2^-kc as float32 (2^-kc from exponent bits; kc in [0, 31])."""
    return remi.to(_F32) * ((127 - kc) << 23).to(_I32).view(_F32)


def _level_exp(amax64):
    """ceil(log2(amax)) as an int32 scalar tensor (0 for amax == 0), on the
    device with no host sync. Exact, from frexp (amax = f * 2^e with f in
    [0.5, 1): the ceiling is e, or e - 1 when f == 0.5), so every device
    gives the same exponent. (The JAX package takes ceil(jnp.log2), which
    XLA's CPU log2 rounds up by one at some exact powers of two.)"""
    f, e = torch.frexp(amax64)
    e = torch.where(f == 0.5, e - 1, e)
    return torch.where(amax64 > 0, e, torch.zeros_like(e)).to(_I32)


def table_scale(exp: int, B: int, negabinary: bool = False) -> float:
    """Physical size of one fixed-point unit for a level (host float)."""
    return 2.0 ** (int(exp) - (B - 2 if negabinary else B - 1))


def scale_tables(err_max_u, err_sq_u, exp: int, B: int,
                 negabinary: bool = False):
    """Unit-space error tables -> physical units, on the host in float64
    (the physical values scale with amax^2 * n)."""
    s = np.float64(table_scale(exp, B, negabinary))
    em = to_host(torch.as_tensor(err_max_u)).astype(np.float64)
    es = to_host(torch.as_tensor(err_sq_u)).astype(np.float64)
    return em * s, es * s * s


def _sm_residual(fxi, r, B: int, b: int):
    """d_b in fixed-point units for the sign-magnitude code: the error of
    reconstructing from b leading magnitude planes (with midpoint
    correction) is |low_b - half_b + r| where low_b = fixed mod 2^(B-b)."""
    if b == 0:
        return fxi.to(_F32) + r
    low = fxi & ((1 << (B - b)) - 1)
    mag = fxi - low
    halfb = (mag > 0).to(_I32) * (1 << max(B - b - 1, 0)) if b < B else 0
    return (low - halfb).to(_F32) + r


def _warp_partials(d):
    """Table partials of one residual d (32, m) float32: max |d| and sum d^2
    over each group of 32 columns (a 32-term float32 stage per column, then
    one per group) — the reduction K9 runs per block of 32 columns."""
    cmax = d.abs().amax(0)
    csq = (d * d).sum(0)
    pad = (-cmax.shape[0]) % LANES
    if pad:
        cmax = torch.cat([cmax, cmax.new_zeros(pad)])
        csq = torch.cat([csq, csq.new_zeros(pad)])
    return cmax.reshape(-1, LANES).amax(1), csq.reshape(-1, LANES).sum(1)


def _finish_tables(emax_p, esq_p):
    """Partials (W, B+1) -> unit tables (B+1,) float64, inflated."""
    em = emax_p.amax(0).to(_F64)
    es = esq_p.to(_F64).sum(0)
    return em * _F32_SLACK, es * _F32_SLACK_SQ


def _sm_planes_from_zt(zt, B: int):
    """Reorder butterfly rows into [sign, MSB..LSB] plane order."""
    m = zt.shape[1]
    if B >= 32:
        # bit 31 carries the sign (magnitude tops out at 2^31 - 1, so the
        # true bit-31 magnitude plane is identically zero)
        return torch.cat([zt[31:32], zt.new_zeros((1, m)), zt[:31].flip(0)])
    return torch.cat([zt[B:B + 1], zt[:B].flip(0)])


# ----------------------------------------------------------------------
# K9: the float32 sign-magnitude encode of one level
# ----------------------------------------------------------------------
def encode_core_plain(v2d, exp, B: int):
    """Plain version of K9: v2d (32, m) float32, exp int32 scalar tensor ->
    (planes (B+1, m) int32 [sign, MSB..LSB], emax (W, B+1) float32,
    esq (W, B+1) float32) with W = ceil(m/32) partials, one per 32
    columns."""
    mag, remi, kc, sign = _int_quantize_f32(v2d, exp, B - 1,
                                            2 ** (B - 1) - 1)
    combined = mag | (sign << min(B, 31))
    planes = _sm_planes_from_zt(_bit_transpose32(combined), B)
    r = _residue_f32(remi, kc)
    em, es = [], []
    for b in range(B + 1):
        pm, ps = _warp_partials(_sm_residual(mag, r, B, b))
        em.append(pm)
        es.append(ps)
    return planes, torch.stack(em, 1), torch.stack(es, 1)


def encode_core(v2d, exp, B: int):
    """K9 wrapper (replaces mgard_tpu/mdr/bitplane.py _encode_pallas_f32
    and the cross-tile finish's inputs): the outputs of encode_core_plain.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel; any other device raises."""
    dev = v2d.device
    if not 1 <= B <= 32:
        raise ValueError(f"K9 takes 1 <= B <= 32, got {B}")
    m = v2d.shape[1] if v2d.ndim == 2 else -1
    if m <= 0 or m % _MC:
        raise ValueError(f"K9 geometry: (32, m) with m % {_MC} == 0, got "
                         f"{tuple(v2d.shape)}")
    kernels.check_tensor("v2d", v2d, _F32, (LANES, m), dev)
    kernels.check_tensor("exp", exp, _I32, (), dev)
    if dev.type == "cpu":
        return encode_core_plain(v2d, exp, B)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    W = m // LANES
    planes = torch.empty((B + 1, m), dtype=_I32, device=dev)
    emax = torch.empty((W, B + 1), dtype=_F32, device=dev)
    esq = torch.empty((W, B + 1), dtype=_F32, device=dev)
    kernels.launch("bitplane_encode", v2d.data_ptr(), exp.data_ptr(),
                   planes.data_ptr(), emax.data_ptr(), esq.data_ptr(), m, B,
                   kernels.stream(dev))
    return planes, emax, esq


def _use_kernel(n: int, dtype, B: int) -> bool:
    """The JAX package's Pallas gate without its TPU test."""
    return (dtype == _F32 and B <= 32 and n >= _KERNEL_MIN
            and n % _KERNEL_MIN == 0)


def encode_kernel(coeff, B: int):
    """Encode one level's flat coefficients into sign+magnitude bitplanes.

    coeff: (n,) float (n a multiple of 32; pad with pad_stream). Returns
    (planes (B+1, n//32) int32 [row 0 = signs, rows 1.. = MSB..LSB],
     exp int32 scalar tensor, err_max (B+1,), err_sq (B+1,) float64 in
     fixed-point units — scale_tables() converts them on the host). Nothing
    here waits for the device."""
    n = coeff.shape[0]
    m = n // LANES
    exp = _level_exp(coeff.abs().max().to(_F64))
    if coeff.dtype == _F64:
        return _encode_f64(coeff, exp, B)
    v2d = coeff.reshape(LANES, m)
    enc = encode_core if _use_kernel(n, coeff.dtype, B) else \
        encode_core_plain
    planes, emax_p, esq_p = enc(v2d, exp, B)
    return (planes, exp, *_finish_tables(emax_p, esq_p))


def _encode_f64(v, exp, B: int):
    """The exact float64 path of encode_kernel (its tables bit-match the
    decoder). torch.round rounds half to even, as jnp.round does here."""
    m = v.shape[0] // LANES
    scale = torch.exp2((B - 1) - exp.to(_F64))
    fixed = torch.clamp(torch.round(v.abs() * scale), max=2 ** (B - 1) - 1)
    fixed = fixed.to(torch.int64)
    sign = (v < 0).to(torch.int64)
    combined = _wrap32(fixed | (sign << min(B, 31)))
    planes = _sm_planes_from_zt(_bit_transpose32(combined.reshape(LANES, m)),
                                B)
    signf = torch.where(sign == 1, -1.0, 1.0).to(_F64)
    err_max, err_sq = [], []
    for b in range(B + 1):
        if b == 0:
            rec = torch.zeros_like(v)
        else:
            mg = fixed & (0xFFFFFFFF << (B - b))
            half = (mg > 0).to(_F64) * (1 << max(B - b - 1, 0)) \
                if b < B else 0.0
            rec = signf * (mg.to(_F64) + half) / scale
        diff = (v - rec) * scale  # fixed-point units (exact 2^k scale)
        err_max.append(diff.abs().max())
        err_sq.append((diff * diff).sum())
    return planes, exp, torch.stack(err_max), torch.stack(err_sq)


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------
def _pow2_scale_f32(x, e):
    """Exact ``x * 2**e`` for integer-valued float32 ``x`` (elements 0 or
    |x| >= 1) and an int32 scalar ``e``, by integer arithmetic on the
    exponent field: no float scale factor that could be subnormal and flush
    to zero. Results below the float32 normal range flush to +-0."""
    xi = x.view(_I32)
    ef = (xi & 0x7F800000) >> 23
    new_e = ef + e
    out = (xi + (e << 23)).view(_F32)
    signb = xi & _INT_MIN
    inf = (signb | 0x7F800000).view(_F32)
    out = torch.where(new_e >= 255, inf, out)
    return torch.where((ef == 0) | (new_e <= 0), torch.zeros_like(out), out)


def _exp_tensor(exp, device):
    if torch.is_tensor(exp):
        return exp.to(device=device, dtype=_I32)
    return to_device(torch.tensor(exp, dtype=_I32), device)


def decode_kernel(planes, exp, B: int, b: int, out_dtype=_F64):
    """Reconstruct coefficients from the sign plane + the b leading
    magnitude planes. planes: (>= 1+b, m) int32. Returns (m*32,) out_dtype
    (float32 output computes in float32)."""
    m = planes.shape[1]
    exp = _exp_tensor(exp, planes.device)
    sbit = min(B, 31)
    zero = planes.new_zeros(m)
    rows = {sbit: planes[0]}
    for i in range(b):
        tb = B - 1 - i
        if 0 <= tb <= 31 and tb != sbit:
            rows[tb] = planes[1 + i]
    cb = _bit_transpose32(torch.stack([rows.get(j, zero) for j in range(32)]))
    mag = (cb & ((1 << sbit) - 1)).long()
    sign = (cb >> sbit) & 1
    if b < B:
        mag = mag + (mag > 0).long() * (1 << max(B - b - 1, 0))
    signf = torch.where(sign == 1, -1.0, 1.0).to(out_dtype)
    fixed = signf * mag.to(out_dtype)
    if out_dtype == _F32:
        vals = _pow2_scale_f32(fixed, exp - (B - 1))
    else:
        vals = fixed * torch.exp2(exp.to(out_dtype) - (B - 1))
    return vals.reshape(m * LANES)


# ----------------------------------------------------------------------
# NegaBinary encoding: signed fixed-point values as base(-2) digits, no
# separate sign plane; truncating trailing planes still yields a signed
# value.
# ----------------------------------------------------------------------
def _nb_mask(B: int) -> int:
    """0b1010...10 over B bits (weights of the odd, negative, positions)."""
    m = 0
    for j in range(1, B, 2):
        m |= 1 << j
    return m


def encode_kernel_negabinary(coeff, B: int):
    """NegaBinary variant of encode_kernel: (planes (B, n//32) int32 [MSB..
    LSB, no sign plane], exp, err_max (B+1,), err_sq (B+1,)). The fixed
    point uses B-2 fraction bits so both signs fit the B-bit negabinary
    range. float64 input, or B > 30 (digits beyond int32), takes the exact
    float64 path; float32 the integer-exact one."""
    n = coeff.shape[0]
    m = n // LANES
    exp = _level_exp(coeff.abs().max().to(_F64))
    M = _nb_mask(B)
    lim = 2 ** (B - 2) - 1
    if coeff.dtype == _F64 or B > 30:
        v = coeff.to(_F64)
        scale = torch.exp2((B - 2) - exp.to(_F64))
        fixed = torch.clamp(torch.round(v * scale), -float(lim), float(lim))
        fixed = fixed.to(torch.int64)
        u = ((fixed + M) ^ M) & 0xFFFFFFFF  # B-bit negabinary digits
        zt = _bit_transpose32(_wrap32(u).reshape(LANES, m))
        planes = zt[:B].flip(0)
        err_max, err_sq = [], []
        for b in range(B + 1):
            if b == 0:
                rec = torch.zeros_like(v)
            else:
                keep = ((1 << B) - 1) & ~((1 << (B - b)) - 1)
                rec = (((u & keep) ^ M) - M).to(_F64) / scale
            diff = (v - rec) * scale
            err_max.append(diff.abs().max())
            err_sq.append((diff * diff).sum())
        return planes, exp, torch.stack(err_max), torch.stack(err_sq)
    magu, remi, kc, sign = _int_quantize_f32(coeff, exp, B - 2, lim)
    signi = 1 - 2 * sign
    fixed = signi * magu
    r = _residue_f32(remi, kc) * signi.to(_F32)
    u = (fixed + M) ^ M
    planes = _bit_transpose32(u.reshape(LANES, m))[:B].flip(0)
    em, es = [], []
    for b in range(B + 1):
        if b == 0:
            d = fixed.to(_F32) + r
        else:
            keep = ((1 << B) - 1) & ~((1 << (B - b)) - 1)
            xt = ((u & keep) ^ M) - M
            d = (fixed - xt).to(_F32) + r
        pm, ps = _warp_partials(d.reshape(LANES, m))
        em.append(pm)
        es.append(ps)
    return (planes, exp,
            *_finish_tables(torch.stack(em, 1), torch.stack(es, 1)))


def decode_kernel_negabinary(planes, exp, B: int, b: int, out_dtype=_F64):
    """Reconstruct from the b leading negabinary planes. planes: (>= b, m)
    int32. Returns (m*32,) out_dtype."""
    m = planes.shape[1]
    exp = _exp_tensor(exp, planes.device)
    zero = planes.new_zeros(m)
    rows = {}
    for i in range(b):
        tb = B - 1 - i
        if 0 <= tb <= 31:
            rows[tb] = planes[i]
    cb = _bit_transpose32(torch.stack([rows.get(j, zero) for j in range(32)]))
    M = _nb_mask(B)
    fixed = (((cb.long() & 0xFFFFFFFF) ^ M) - M).to(out_dtype)
    if out_dtype == _F32:
        vals = _pow2_scale_f32(fixed, exp - (B - 2))
    else:
        vals = fixed * torch.exp2(exp.to(out_dtype) - (B - 2))
    return vals.reshape(m * LANES)


def encode_level(coeff_flat, B: int):
    """Pad to the encoded length, encode, scale the tables on the host.
    Returns (planes, exp, err_max, err_sq, n)."""
    n = int(coeff_flat.shape[0])
    planes, exp, em_u, es_u = encode_kernel(pad_stream(coeff_flat), B)
    em, es = scale_tables(em_u, es_u, int(exp), B)
    return planes, int(exp), em, es, n


def decode_level(planes, exp: int, B: int, b: int, n: int):
    """Decode with b magnitude planes (float64), trim the padding."""
    return decode_kernel(planes, exp, B, b)[:n]
