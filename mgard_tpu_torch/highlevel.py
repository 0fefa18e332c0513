"""High-level API of the PyTorch port: ``compress`` / ``decompress``.

Port of the Hybrid paths of ``mgard_tpu/highlevel.py``: a float32 field at
s=inf under an ABS or REL tolerance, Hybrid decomposition (8^D local levels
plus the multilevel transform of the corner remainder) and the BFP or BFX
lossless stage. It writes the same self-describing streams as the JAX
package, so either package decodes what the other wrote:

- flag 1 ("v2", lossless=BFP, 3D): the cf stream as a prepared BFP5 blob
  (kernels K1 and K2), then the remainder as a lossless section; decode
  runs K3 and K4;
- flag 2 ("v3", ``Config.hybrid_fused_pack``): the same cf blob with its
  chunks in tile-major order, written by the fused transform+pack kernel
  K10 once a base-plane count is known for the shape (the first stream of
  a shape rides flag 1 and primes it); decode runs K11;
- flag 0: one lossless section of all symbols (kernels K7 and K8 for the
  front end of a 2D or 3D field): the path of lossless=BFX, and the
  fallback when a chunk needs more than 16 bits or the shape fails the
  flag-1 gate.

A lossless section of fewer than ``bfp.SB_PALLAS_MIN * 32`` symbols is BFX
(kernels K5 and K6) whatever the backend asked for, as in the JAX package;
the section's backend id keeps the stream self-describing.

The JAX package writes flag 1 only on a TPU; the port writes it on every
device, so its CPU path and its CUDA path produce the same format. A tensor
runs on the device it lives on; a NumPy input goes to ``device``, and
``decompress`` decodes onto ``device``: the CUDA card unless the caller
asks for the CPU (``device="cpu"``). Without a CUDA device a call that asks
for the card raises RuntimeError; it does not run on the CPU instead.
Requests outside the ported paths raise NotImplementedError naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .decomposer import DomainDecomposer, calc_local_abs_tol
from .dtypes import (
    MAX_DIM,
    compress_status_type,
    compressor_type,
    data_structure_type,
    decomposition_type,
    domain_decomposition_type,
    dtype_enum,
    error_bound_type,
    lossless_type,
    norm_type,
)
from .formats.metadata import FormatError, Metadata
from .hierarchy import get_hierarchy
from .lossless import bfp as _bfp, bfx as _bfx
from .lossless.registry import lossless_decompress, section_parts
from .ops import hybrid as Hy
from .ops.refactor import decompose, recompose
from .utils.bytesink import join, parts_size
from .utils.log import Timer, log


def _todo(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def _hybrid_worthwhile(shape) -> bool:
    """Hybrid pays off when the x8 padding is cheap and the array is large
    enough to amortize the remainder stage (the JAX package's rule)."""
    padded = [(s + 7) // 8 * 8 for s in shape]
    pad_factor = float(np.prod([p / s for p, s in zip(padded, shape)]))
    return pad_factor <= 1.25 and int(np.prod(shape)) >= (1 << 18)


def _effective_raw_lt(lt: lossless_type, n: int) -> lossless_type:
    """Streams under SB_PALLAS_MIN*32 symbols use BFX (the section's backend
    id keeps the blob self-describing)."""
    if lt == lossless_type.BFP and n < _bfp.SB_PALLAS_MIN * 32:
        return lossless_type.BFX
    return lt


def _norm_kernel(v):
    """The s=inf norm of a REL bound: max |v|."""
    return v.abs().max()


def _hybrid_quantizer(abs_tol: float, l_total: int) -> float:
    # hierarchical s=inf rule with the hybrid level count
    # (reference: LinearQuantization.hpp:234-298)
    return 2.0 * abs_tol / (l_total + 1)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _inv_q(q: float) -> float:
    """1/q as the JAX package computes it: a float32 division."""
    return float(np.float32(1.0) / np.float32(q))


def _pick_v2_chunk(padded, config: Config) -> int:
    """Sort-chunk size of the v2 cf stream: an explicit Config.bfp_chunk
    wins; otherwise the largest C whose C*32-symbol rows tile the last
    axis."""
    C = int(getattr(config, "bfp_chunk", 0) or 0)
    if C:
        return C
    for cand in (16, 8, 4, 2):
        if (padded[-1] % (cand * 32) == 0
                and _bfp.SB_BLOCKS % (cand * _bfp.LANES) == 0):
            return cand
    return 1


def _v2_sb(config: Config, n_cf: int, C: int) -> int:
    """Superblock of the v2 cf stream: an explicit Config.bfp_sb_blocks
    wins when the stream admits it; otherwise SB_BLOCKS."""
    sb = int(getattr(config, "bfp_sb_blocks", 0) or 0)
    if (sb >= _bfp.SB_PALLAS_MIN and n_cf % (sb * 32) == 0
            and sb % (C * _bfp.LANES) == 0):
        return sb
    return _bfp.SB_BLOCKS


def _hybrid_v2_ok(padded, config: Config) -> bool:
    """Gate of the flag-1 front end (the JAX gate without its TPU term)."""
    C = _pick_v2_chunk(padded, config)
    n_cf = int(np.prod(padded))
    sb = _v2_sb(config, n_cf, C)
    return (
        config.lossless == lossless_type.BFP
        and bool(config.hybrid_level_grouping)
        and Hy._tile_shape_v2(padded) is not None
        and C >= 1
        and padded[-1] % (C * 32) == 0
        and sb % (C * _bfp.LANES) == 0
        and n_cf % (sb * 32) == 0
    )


def _v3_params(config: Config, padded):
    """(K, E, C) of the fused flag-2 path; K is None while no base-plane
    count is known: an explicit Config.bfp_base_planes, else the sticky
    per-shape cache that the flag-1 serializer fills (the first stream of a
    shape rides flag 1 and primes it, every later one fuses)."""
    C = padded[-1] // 32
    E = int(getattr(config, "bfp_resid_planes", 0) or _bfp.E_DEFAULT)
    n_cf = int(np.prod(padded))
    K_cfg = int(getattr(config, "bfp_base_planes", 0) or 0)
    if K_cfg:
        return K_cfg, E, C
    # the flag-1 serializer keys the cache by its own chunk size, not by
    # C = Z/32 (Z = 768: 8 against 24), so look under both; a K chosen for
    # another chunk size costs ratio only, the serializer's cw_max check
    # guards the stream
    for key in (("v2", n_cf, E, C, 0),
                ("v2", n_cf, E, _pick_v2_chunk(padded, config), 0)):
        ent = _bfp._K_CACHE.get(key)
        if ent:
            return int(ent[0]), E, C
    return None, E, C


def _hybrid_v3_ok(padded, config: Config) -> bool:
    """Gate of the fused transform+pack front end (the JAX gate without its
    TPU term): asked for, the (8, 128, Z) tile = superblock scheme fits,
    and a base-plane count K >= 1 with K + E <= 16 is already known."""
    if not (
        bool(getattr(config, "hybrid_fused_pack", False))
        and config.lossless == lossless_type.BFP
        and bool(config.hybrid_level_grouping)
        and not int(getattr(config, "bfp_chunk", 0) or 0)
        and not int(getattr(config, "bfp_sb_blocks", 0) or 0)
        and Hy.v3_ok_shape(padded)
    ):
        return False
    K, E, _ = _v3_params(config, padded)
    return K is not None and K >= 1 and 1 <= E <= 15 and K + E <= 16


def _edge_pad(v, padded):
    for d, (s, p) in enumerate(zip(v.shape, padded)):
        if p > s:
            last = v.narrow(d, s - 1, 1)
            v = torch.cat([v, last.expand(*v.shape[:d], p - s,
                                          *v.shape[d + 1:])], dim=d)
    return v


def _compress_core_hybrid_v2(v, q: float, padded, nl: int, rem_hier, C: int):
    """One-pass front end: (payload int16 [u16 grouped zigzag cf codes],
    cw (NC,) int32 [true chunk widths], rem_sym (n_rem,) int32)."""
    v = _edge_pad(v, padded).contiguous()
    inv_q = _inv_q(q)
    pay, cw, rem = Hy.local_transform_fused_v2(v, inv_q, nl, C)
    rem_dec = decompose(rem, rem_hier, orthogonal=False)
    return pay, cw, Hy.quantize(rem_dec, inv_q).reshape(-1)


def _decompress_core_hybrid_v2(zz_rows, rem_sym, q: float, shape, padded,
                               nl: int, rem_hier):
    q = _f32(q)
    rem_dec = (rem_sym.to(torch.float32) * q).reshape(rem_hier.shape)
    rem = recompose(rem_dec, rem_hier, orthogonal=False).contiguous()
    out = Hy.local_inverse_fused_v2(zz_rows.reshape(padded), rem, q, nl)
    return out[tuple(slice(0, s) for s in shape)]


def _compress_core_hybrid_v3(v, q: float, padded, nl: int, rem_hier, K: int,
                             E: int):
    """Fused front end: (base, resid [static-cap layout], cw (NSB, 1024)
    int32 [tile-major widths], rem_sym (n_rem,) int32)."""
    v = _edge_pad(v, padded).contiguous()
    inv_q = _inv_q(q)
    base, resid, cw, rem = Hy.local_transform_pack_v3(v, inv_q, nl, K, E)
    rem_dec = decompose(rem, rem_hier, orthogonal=False)
    return base, resid, cw, Hy.quantize(rem_dec, inv_q).reshape(-1)


def _decompress_core_hybrid_v3(base, crl, resid, rem_sym, q: float, shape,
                               padded, nl: int, rem_hier, K: int, E: int):
    q = _f32(q)
    rem_dec = (rem_sym.to(torch.float32) * q).reshape(rem_hier.shape)
    rem = recompose(rem_dec, rem_hier, orthogonal=False).contiguous()
    out = Hy.unpack_inverse_v3(base, crl, resid, rem, q, nl, K, E, padded)
    return out[tuple(slice(0, s) for s in shape)]


def _compress_core_hybrid(v, q: float, padded, nl: int, rem_hier,
                          zgroup: bool):
    """Flag-0 symbols: the cf field (z-class grouped when zgroup) followed
    by the quantized remainder transform. A 2D or 3D field takes K7 (a
    CUDA tensor launches it); other ranks run the plain version on every
    device, as the JAX package runs XLA for them."""
    v = _edge_pad(v, padded).contiguous()
    inv_q = _inv_q(q)
    front = (Hy.local_transform_fused if v.ndim in (2, 3)
             else Hy.local_transform)
    cf_sym, rem = front(v, inv_q, nl)
    rem_dec = decompose(rem, rem_hier, orthogonal=False)
    if zgroup:
        cf_sym = Hy.zclass_group(cf_sym)
    return torch.cat([cf_sym.reshape(-1),
                      Hy.quantize(rem_dec, inv_q).reshape(-1)])


def _decompress_core_hybrid(sym, q: float, shape, padded, nl: int, rem_hier,
                            zgroup: bool):
    n_cf = int(np.prod(padded))
    q = _f32(q)
    rem_dec = (sym[n_cf:].to(torch.float32) * q).reshape(rem_hier.shape)
    rem = recompose(rem_dec, rem_hier, orthogonal=False)
    cf_sym = sym[:n_cf].reshape(padded)
    if zgroup:
        cf_sym = Hy.zclass_ungroup(cf_sym)
    back = (Hy.local_inverse_fused if len(padded) in (2, 3)
            else Hy.local_inverse)
    out = back(cf_sym.contiguous(), rem.contiguous(), q, nl)
    return out[tuple(slice(0, s) for s in shape)]


# ----------------------------------------------------------------------
# Sections
# ----------------------------------------------------------------------
def _skip_outliers(data: bytes, offset: int) -> int:
    """Length of an outlier section (raw-symbol backends write it empty)."""
    _count, ni, nv = struct.unpack_from("<QQQ", data, offset)
    return 24 + ni + nv


# The outlier section raw-symbol backends write: count 0, then the zlib
# streams of the (empty) index deltas and values.
_Z0 = zlib.compress(b"", 3)
_EMPTY_OUTLIERS = struct.pack("<QQQ", 0, len(_Z0), len(_Z0)) + _Z0 + _Z0


def _raw_encode_device(sym, config: Config):
    """Returns (effective lossless id, the codec's device state)."""
    lt = _effective_raw_lt(config.lossless, int(sym.shape[0]))
    if lt == lossless_type.BFX:
        return lt, _bfx.encode_device(sym, config.bfx_sb_blocks)
    return lt, _bfp.encode_device(sym, config)


def _raw_section_parts(lt_eff, dev_state) -> list:
    codec = _bfx if lt_eff == lossless_type.BFX else _bfp
    return section_parts(lt_eff, codec.serialize_device_parts(dev_state))


def _dispatch_subdomain(v, hier, config: Config, abs_tol: float):
    """Device phase of one subdomain: launch its pipeline and return an
    opaque state for _serialize_subdomain."""
    nl = max(1, min(3, int(config.num_local_refactoring_level)))
    padded = Hy.pad_to8(hier.shape)
    rem_hier = get_hierarchy(Hy.remainder_shape(padded, nl), hier.dtype, None,
                             config)
    q = _hybrid_quantizer(abs_tol, Hy.hybrid_l_total(padded, nl, rem_hier))
    if _hybrid_v3_ok(padded, config):
        K, E, _ = _v3_params(config, padded)
        base, resid, cw, rem_sym = _compress_core_hybrid_v3(
            v, q, padded, nl, rem_hier, K, E)
        rem_state = _raw_encode_device(rem_sym, config)
        return ("hybrid_v3", (base, resid, cw, rem_state, v, q, padded, nl,
                              rem_hier, K, E))
    if _hybrid_v2_ok(padded, config):
        C = _pick_v2_chunk(padded, config)
        pay, cw, rem_sym = _compress_core_hybrid_v2(v, q, padded, nl,
                                                    rem_hier, C)
        rem_state = _raw_encode_device(rem_sym, config)
        return ("hybrid_v2",
                (pay, cw, rem_state, v, q, padded, nl, rem_hier, C))
    sym = _compress_core_hybrid(v, q, padded, nl, rem_hier,
                                bool(config.hybrid_level_grouping))
    return ("hybrid_raw", _raw_encode_device(sym, config))


def _flag0_parts(lt_eff, dev_state) -> list:
    return ([_EMPTY_OUTLIERS + struct.pack("<B", 0)]
            + _raw_section_parts(lt_eff, dev_state))


def _serialize_hybrid_v2(st, config: Config) -> list:
    """Flag byte 1, the cf stream as a prepared BFP5 blob, the remainder as
    a lossless section. Falls back to the flag-0 layout when the chunk
    widths exceed the u16 budget (K+E > 16 or an over-wide chunk)."""
    pay, cw, rem_state, v, q, padded, nl, rem_hier, C = st
    E = int(getattr(config, "bfp_resid_planes", 0) or _bfp.E_DEFAULT)
    if not 1 <= E <= 15:
        raise ValueError(f"bfp_resid_planes must be in [1, 15], got {E}")
    n_cf = int(np.prod(padded))
    K_cfg = int(getattr(config, "bfp_base_planes", 0) or 0)
    key = ("v2", n_cf, E, C, K_cfg)
    cw_h = cw.cpu().numpy()
    if K_cfg:
        # an explicit base-plane count wins; an undersized one takes the
        # flag-0 path through the cw_max check below
        K = K_cfg
    elif key in _bfp._K_CACHE:
        K = _bfp._K_CACHE[key][0]
    else:
        hist = np.bincount(np.clip(cw_h, 0, 32), minlength=33)
        K = _bfp.choose_K(hist, E, C)
        _bfp._K_CACHE[key] = (K, None)
    cw_max = int(cw_h.max())
    if not K_cfg and K + E < cw_max <= 16:
        # a stale sticky K (chosen for a coarser tolerance on this shape):
        # re-choose from these widths, clamped into [cw_max - E, 16 - E] so
        # the stream stays exception-free and inside the u16 budget
        hist = np.bincount(np.clip(cw_h, 0, 32), minlength=33)
        K = min(max(_bfp.choose_K(hist, E, C), cw_max - E), 16 - E)
        _bfp._K_CACHE[key] = (K, None)
    if K + E > 16 or cw_max > K + E:
        sym = _compress_core_hybrid(v, q, padded, nl, rem_hier,
                                    bool(config.hybrid_level_grouping))
        return _flag0_parts(*_raw_encode_device(sym, config))
    crl = (cw - K).clamp(0, E).to(torch.int32)
    sb = _v2_sb(config, n_cf, C)
    out = _bfp.encode_core_zz(pay.reshape(-1, C * 32), crl, K, E, sb, C)
    cf_parts = _bfp.serialize_prepared_parts(n_cf, K, E, sb, C, crl, *out)
    return ([_EMPTY_OUTLIERS + struct.pack("<B", 1)
             + struct.pack("<Q", parts_size(cf_parts))]
            + cf_parts + _raw_section_parts(*rem_state))


def _serialize_hybrid_v3(st, config: Config) -> list:
    """Flag byte 2, the cf stream as a BFP5 blob with tile-major chunks
    (its device planes in the static-cap layout), the remainder as a
    lossless section. A chunk wider than K + E (a stale sticky K: the
    tolerance tightened on a primed shape; or a code over 16 bits) makes
    the packed planes unusable: where the flag-1 front end takes the shape
    its serializer re-chooses K from fresh widths, refreshes the cache, so
    the next stream fuses again, and keeps flag 1 or drops to flag 0 on a
    true u16 overflow; elsewhere the stream is flag 0."""
    (base, resid, cw, rem_state, v, q, padded, nl, rem_hier, K, E) = st
    if int(cw.max()) > K + E:
        if _hybrid_v2_ok(padded, config):
            C2 = _pick_v2_chunk(padded, config)
            pay, cw2, _ = _compress_core_hybrid_v2(v, q, padded, nl,
                                                   rem_hier, C2)
            # the remainder was encoded for this same quantizer already
            return _serialize_hybrid_v2(
                (pay, cw2, rem_state, v, q, padded, nl, rem_hier, C2), config)
        sym = _compress_core_hybrid(v, q, padded, nl, rem_hier,
                                    bool(config.hybrid_level_grouping))
        return _flag0_parts(*_raw_encode_device(sym, config))
    n_cf = int(np.prod(padded))
    Z = padded[-1]
    crl = (cw.reshape(-1) - K).clamp(0, E)
    cf_parts = _bfp.serialize_prepared_parts(n_cf, K, E, 32 * Z, Z // 32, crl,
                                             base, resid, 0, static_cap=True)
    return ([_EMPTY_OUTLIERS + struct.pack("<B", 2)
             + struct.pack("<Q", parts_size(cf_parts))]
            + cf_parts + _raw_section_parts(*rem_state))


def _sections_wire_minor(sections) -> int:
    """The least minor file version the payload needs: 1 (file 2.1) only
    when a flag-2 section was written, so 2.0 readers go on parsing every
    stream they can decode."""
    off = len(_EMPTY_OUTLIERS)
    for sec in sections:
        first = bytes(sec[0])
        if len(first) > off and first[off] == 2:
            return 1
    return 0


def _serialize_subdomain(state, config: Config) -> list:
    if state[0] == "hybrid_v3":
        return _serialize_hybrid_v3(state[1], config)
    if state[0] == "hybrid_v2":
        return _serialize_hybrid_v2(state[1], config)
    return _flag0_parts(*state[1])


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, else the CUDA card.
    Raises RuntimeError when that is a CUDA device and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mgard_tpu_torch runs on the CUDA device unless asked otherwise, "
            "and no CUDA device is available: pass device='cpu' (or a CPU "
            "tensor) to run on the CPU")
    return dev


def as_tensor(data, device=None):
    """A torch tensor runs where it lives (``device``, if given, must name
    that place); anything else becomes a float tensor on
    ``resolve_device(device)``."""
    if isinstance(data, torch.Tensor):
        if device is not None and torch.device(device) != data.device:
            raise ValueError(f"tensor lives on {data.device}, device={device}")
        return data
    dev = resolve_device(device)
    arr = np.asarray(data)
    if arr.dtype.kind != "f":
        raise TypeError(f"unsupported dtype {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _check_slice(s: float, config: Config, dtype) -> None:
    """Raise NotImplementedError for requests outside the ported slice."""
    if dtype == torch.float64:
        _todo("float64 compression (demotion and the native f64 transform)",
              "ROADMAP queue 1 item 9")
    if not math.isinf(s):
        _todo("finite-s error bounds", "ROADMAP queue 1 item 9")
    if config.compressor != compressor_type.MGARD:
        _todo("the ZFP compressor", "ROADMAP queue 1 item 9")
    if config.decomposition != decomposition_type.Hybrid:
        _todo(f"{config.decomposition.name} decomposition",
              "ROADMAP queue 1 item 9")
    if config.lossless not in (lossless_type.BFP, lossless_type.BFX):
        _todo(f"lossless backend {config.lossless.name}",
              "ROADMAP queue 1 item 11")
    if config.adjust_shape:
        _todo("shape adjustment on compress", "ROADMAP queue 1 item 9")


def compress(data, tol: float, s: float = math.inf,
             mode: error_bound_type = error_bound_type.ABS,
             config: Optional[Config] = None,
             device=None) -> Tuple[bytes, compress_status_type]:
    """Compress a 3D float32 field under an L-inf error bound.

    ``data`` is a torch tensor (compressed on its own device) or a NumPy
    array (moved to ``device``, default the CUDA card). Returns (blob,
    status)."""
    config = config or Config()
    if config.log_level:
        log.level = max(log.level, int(config.log_level))
    t_total = Timer()
    t_total.start()
    try:
        v = as_tensor(data, device)
    except TypeError:
        return b"", compress_status_type.NotSupportDataTypeFailure
    if v.ndim < 1 or v.ndim > MAX_DIM:
        return b"", compress_status_type.NotSupportHigherNumberOfDimensionsFailure
    try:
        dt = dtype_enum(str(v.dtype).replace("torch.", ""))
    except TypeError:
        return b"", compress_status_type.NotSupportDataTypeFailure
    shape = tuple(int(x) for x in v.shape)
    _check_slice(s, config, v.dtype)
    if not _hybrid_worthwhile(shape):
        _todo(f"the MultiDim fallback for shape {shape}",
              "ROADMAP queue 1 item 9")
    try:
        dd = DomainDecomposer(shape, np.float32, config, device=v.device)
        S = dd.num_subdomains
        norm = 0.0
        if mode == error_bound_type.REL:
            norm = max(float(_norm_kernel(v[dd.subdomain_slices(i)]))
                       for i in range(S))
            if norm == 0.0:
                norm = float(np.finfo(np.float32).eps)
        local_tol = calc_local_abs_tol(mode, norm, tol, s, S)
        payload, sections = [], []
        for i in range(S):
            hier = get_hierarchy(dd.subdomain_shape(i), np.float32, None,
                                 config)
            state = _dispatch_subdomain(v[dd.subdomain_slices(i)], hier,
                                        config, local_tol)
            sec = _serialize_subdomain(state, config)
            sections.append(sec)
            payload += [struct.pack("<Q", parts_size(sec))] + sec
        var_sizes = ()
        if (dd.domain_decomposed and config.domain_decomposition
                == domain_decomposition_type.Variable):
            var_sizes = tuple(dd.subdomain_shape(i)[dd.domain_decomposed_dim]
                              for i in range(S))
        meta = Metadata(
            dtype=dt,
            shape=shape,
            dstype=data_structure_type.Cartesian_Grid_Uniform,
            decomposition=config.decomposition,
            l_target=get_hierarchy(dd.subdomain_shape(0), np.float32, None,
                                   config).l_target,
            reorder=config.reorder,
            hybrid_grouping=bool(config.hybrid_level_grouping),
            domain_decomposed=dd.domain_decomposed,
            ddtype=config.domain_decomposition,
            domain_decomposed_dim=dd.domain_decomposed_dim,
            domain_decomposed_size=dd.domain_decomposed_size,
            dd_variable_sizes=var_sizes,
            ebtype=mode,
            norm=norm,
            tol=float(tol),
            ntype=norm_type.L_Inf,
            s=float(s),
            ltype=config.lossless,
            huff_dict_size=config.huff_dict_size,
            huff_block_size=config.huff_block_size,
            block_delta_block_size=config.block_delta_block_size,
            nlocal=max(1, min(3, int(config.num_local_refactoring_level))),
            wire_minor=_sections_wire_minor(sections),
        )
        blob = join([meta.serialize()] + payload)
        t_total.end()
        t_total.print("compress total", v.numel() * 4)
        log.info(f"compressed {v.numel() * 4} -> {len(blob)} bytes over "
                 f"{S} subdomain(s)")
        return blob, compress_status_type.Success
    except NotImplementedError:
        raise
    except FormatError:
        return b"", compress_status_type.Failure
    except Exception:  # the reference's catch-all translation to a status
        import traceback

        traceback.print_exc()
        return b"", compress_status_type.Failure


def _decode_section(blob, pos: int, meta, hier, cfg: Config, local_tol,
                    device):
    """Decode one subdomain's section -> float32 tensor of hier.shape."""
    pos += _skip_outliers(blob, pos)
    (flag,) = struct.unpack_from("<B", blob, pos)
    pos += 1
    if flag > 2:
        raise FormatError(f"unknown hybrid front-end flag {flag}")
    nl = max(1, min(3, int(meta.nlocal) or 1))
    padded = Hy.pad_to8(hier.shape)
    rem_shape = Hy.remainder_shape(padded, nl)
    rem_hier = get_hierarchy(rem_shape, np.float32, None, cfg)
    q = _hybrid_quantizer(local_tol, Hy.hybrid_l_total(padded, nl, rem_hier))
    if flag == 0:
        sym, _ = lossless_decompress(blob, pos, device)
        expected = int(np.prod(padded)) + int(np.prod(rem_shape))
        if int(sym.shape[0]) != expected:
            raise FormatError(f"payload has {int(sym.shape[0])} symbols, "
                              f"expected {expected}")
        return _decompress_core_hybrid(sym, q, hier.shape, padded, nl,
                                       rem_hier, bool(meta.hybrid_grouping))
    vtag = "v3" if flag == 2 else "v2"
    (cf_len,) = struct.unpack_from("<Q", blob, pos)
    pos += 8
    base, crl, rbuf, (n_cf, K, E, sb, C), _ = _bfp.deserialize_prepared(
        blob, pos, device, static_cap=flag == 2)
    pos += cf_len
    if n_cf != int(np.prod(padded)):
        raise FormatError(f"hybrid-{vtag} cf stream has {n_cf} symbols, "
                          f"expected {int(np.prod(padded))}")
    if K + E > 16 or padded[-1] % (C * 32):
        raise FormatError(f"hybrid-{vtag} cf stream geometry K={K} E={E} "
                          f"C={C}")
    if flag == 2 and not (Hy.v3_ok_shape(padded) and sb == 32 * padded[-1]
                          and C == padded[-1] // 32):
        # flag 2 is defined on the tile = superblock scheme only
        raise FormatError(f"hybrid-v3 cf stream geometry (sb={sb}, C={C}, "
                          f"K={K}, E={E}) does not match the v3 scheme for "
                          f"domain {padded}")
    rem_sym, _ = lossless_decompress(blob, pos, device)
    if int(rem_sym.shape[0]) != int(np.prod(rem_shape)):
        raise FormatError(f"hybrid-{vtag} rem stream has "
                          f"{int(rem_sym.shape[0])} symbols, expected "
                          f"{int(np.prod(rem_shape))}")
    if flag == 2:
        return _decompress_core_hybrid_v3(
            base, crl.reshape(-1, Hy.V3_SBC), rbuf, rem_sym, q, hier.shape,
            padded, nl, rem_hier, K, E)
    zz_rows = _bfp.decode_core_zz(base, crl, rbuf, K, E, sb, n_cf // 32, C)
    return _decompress_core_hybrid_v2(zz_rows, rem_sym, q, hier.shape,
                                      padded, nl, rem_hier)


def decompress(blob: bytes, config: Optional[Config] = None,
               device=None) -> Tuple[Optional[torch.Tensor],
                                     compress_status_type]:
    """Decompress a stream of either package onto ``device`` (default the
    CUDA card). Returns (tensor, status)."""
    device = resolve_device(device)
    try:
        meta, off = Metadata.deserialize(blob)
    except (FormatError, struct.error):
        return None, compress_status_type.Failure
    t_total = Timer()
    t_total.start()
    try:
        cfg = config or Config()
        if config is not None and config.log_level:
            log.level = max(log.level, int(config.log_level))
        if meta.ctype != compressor_type.MGARD:
            _todo("the ZFP compressor", "ROADMAP queue 1 item 9")
        if meta.dstype != data_structure_type.Cartesian_Grid_Uniform:
            _todo("non-uniform grids", "ROADMAP queue 1 item 9")
        if meta.dtype != dtype_enum(np.float32) and not meta.demoted:
            _todo("float64 streams", "ROADMAP queue 1 item 9")
        if not math.isinf(meta.s):
            _todo("finite-s streams", "ROADMAP queue 1 item 9")
        if meta.roi_enabled:
            _todo("region-of-interest streams", "ROADMAP queue 1 item 9")
        if meta.decomposition != decomposition_type.Hybrid:
            _todo(f"{meta.decomposition.name} streams",
                  "ROADMAP queue 1 item 9")
        if meta.ltype not in (lossless_type.BFP, lossless_type.BFX):
            _todo(f"lossless backend {meta.ltype.name}",
                  "ROADMAP queue 1 item 11")
        if meta.adjusted:
            _todo("shape-adjusted streams", "ROADMAP queue 1 item 9")
        shape = tuple(int(n) for n in meta.shape)
        dd = DomainDecomposer.from_metadata(shape, np.float32, meta, cfg)
        S = dd.num_subdomains
        local_tol = calc_local_abs_tol(meta.ebtype, meta.norm, meta.tol,
                                       meta.s, S)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        for i in range(S):
            (sec_len,) = struct.unpack_from("<Q", blob, off)
            off += 8
            hier = get_hierarchy(dd.subdomain_shape(i), np.float32, None, cfg)
            out[dd.subdomain_slices(i)] = _decode_section(
                blob, off, meta, hier, cfg, local_tol, device)
            off += sec_len
        if meta.demoted:
            out = out.to(torch.float64)
        t_total.end()
        t_total.print("decompress total", out.numel() * out.element_size())
        return out, compress_status_type.Success
    except NotImplementedError:
        raise
    except FormatError:
        return None, compress_status_type.Failure
    except Exception:
        import traceback

        traceback.print_exc()
        return None, compress_status_type.Failure
