"""MDR high-level API: MDRefactor / MDRequest / MDReconstruct (port of
``mgard_tpu/mdr/api.py``; the two packages read each other's metadata,
planes and files).

Refactor runs on the device: hierarchical decompose, per-level interleave,
bitplane encode with error collection (kernel K9 for float32 levels of at
least 65,536 elements, ``bitplane.py``), and with
``Config.mdr_level_compressor="bfx"`` the BFX pack of every plane of at
least ``PLANE_BFX_MIN_WORDS`` words (kernel K5). Every level is dispatched
before the host serializes any (the device queue runs back to back).
Retrieval is error-driven and incremental: MDRequest plans per-level
bitplane counts, MDReconstruct decodes only the requested planes (a BFX
plane with kernel K6 on the card), deinterleaves and recomposes on the
device, and records what it consumed for later refinement rounds.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); a torch tensor runs where it lives.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..dtypes import bitplane_encoding_type, data_type, dtype_enum, np_dtype
from ..formats.metadata import FormatError
from ..hierarchy import Hierarchy, get_hierarchy
from ..highlevel import as_tensor, resolve_device
from ..lossless import bfx as _bfx
from ..ops.refactor import decompose, recompose
from ..utils.bytesink import join
from ..utils.trace import (count, host_scratch, span, to_device_each,
                           to_host, to_host_into, traced)
from . import bitplane
from .components import (
    interleave_level,
    interpret_retrieve_size,
    level_num_elems,
    level_regions,
    region_deinterleave,
)

# The format revision of the JAX package: older MDR streams are rejected
# instead of mis-parsed.
_MAGIC = b"MDRTPU2\x00"

# per-plane codec ids (reference: MDR-X/LosslessCompressor component kit)
PLANE_RAW = 0
PLANE_ZLIB = 1
PLANE_BFX = 2
# smallest plane (u32 words) worth a device-BFX dispatch
PLANE_BFX_MIN_WORDS = 8192

_INTERLEAVERS = {"direct": 0, "blocked": 1, "sfc": 2}
_PLANE_COUNTERS = {PLANE_RAW: "mdr.plane.raw", PLANE_ZLIB: "mdr.plane.zlib",
                   PLANE_BFX: "mdr.plane.bfx"}
_TORCH_TYPES = {torch.float32: np.float32, torch.float64: np.float64}


def choose_plane_blob(raw_bytes: bytes, candidate, codec_id: int):
    """Best-of plane selection (raw vs one encoded candidate): the single
    policy point of every writer."""
    if candidate is not None and len(candidate) < len(raw_bytes):
        return candidate, codec_id
    return raw_bytes, PLANE_RAW


def decode_plane_rows(blobs, codecs, m: int, device="cpu"):
    """Decode a level's stored plane blobs to its (len(blobs), m) int32
    rows on ``device`` (u32 words as int32 bit patterns): the single decode
    point of every reader. A BFX plane decodes on ``device`` (kernel K6 on
    the card); a raw or zlib plane is copied there as it is inflated."""
    rows, host, words = [None] * len(blobs), [], []
    for i, (blob, codec) in enumerate(zip(blobs, codecs)):
        if codec == PLANE_BFX:
            syms, _ = _bfx.decode(blob, 0, device)
            if int(syms.shape[0]) < m:
                raise FormatError(f"BFX plane holds {int(syms.shape[0])} "
                                  f"words, expected {m}")
            rows[i] = syms[:m]
            continue
        if codec == PLANE_ZLIB:
            raw = zlib.decompress(blob)
        elif codec == PLANE_RAW:
            raw = blob
        else:
            raise FormatError(f"unsupported MDR plane codec id {codec}")
        host.append(i)
        words.append(_bfx._blob_tensor(np.frombuffer(raw, "<i4", count=m)))
    for i, t in zip(host, to_device_each(words, device)):
        rows[i] = t
    return torch.stack(rows)


@dataclasses.dataclass
class LevelMetadata:
    exp: int
    n: int  # number of coefficients (unpadded)
    plane_sizes: List[int]  # compressed bytes per stored plane (0=sign)
    plane_raw: List[int]  # per-plane codec id (PLANE_RAW/ZLIB/BFX)
    err_max: np.ndarray  # (B+1,)
    err_sq: np.ndarray  # (B+1,)


@dataclasses.dataclass
class RefactoredMetadata:
    dtype: data_type
    shape: tuple
    l_target: int
    number_bitplanes: int
    total_num_elems: int
    levels: List[LevelMetadata]
    # retrieval state
    requested: List[int] = dataclasses.field(default_factory=list)
    prev_used: List[int] = dataclasses.field(default_factory=list)
    coords: Optional[List[np.ndarray]] = None
    # encoding variant and decomposition basis
    encoding: bitplane_encoding_type = bitplane_encoding_type.SignMagnitude
    orthogonal: bool = False
    # file segments stored in error-impact order instead of level-major
    reorganized: bool = False
    # the s-norm of the reorganizer's greedy gain, persisted so that readers
    # recompute the identical segment order
    reorg_s: float = float("inf")
    # interleaver mode: Direct=0, Blocked=1, SFC/Morton=2
    interleaver: int = 0

    @property
    def sign_rows(self) -> int:
        return 0 if self.encoding == bitplane_encoding_type.NegaBinary else 1

    def serialize(self) -> bytes:
        body = bytearray()
        body += struct.pack(
            "<BBIQBBBBd",
            int(self.dtype),
            len(self.shape),
            self.number_bitplanes,
            self.total_num_elems,
            1 if self.coords is not None else 0,
            int(self.encoding),
            1 if self.orthogonal else 0,
            1 if self.reorganized else 0,
            float(self.reorg_s),
        )
        body += struct.pack("<B", int(self.interleaver))
        for n in self.shape:
            body += struct.pack("<Q", n)
        if self.coords is not None:
            for c in self.coords:
                body += np.asarray(c, "<f8").tobytes()
        body += struct.pack("<I", self.l_target)
        body += struct.pack("<I", len(self.levels))
        for lm in self.levels:
            body += struct.pack("<iQ", lm.exp, lm.n)
            body += struct.pack("<I", len(lm.plane_sizes))
            for sz, raw in zip(lm.plane_sizes, lm.plane_raw):
                # the full codec id, not a boolean
                body += struct.pack("<IB", sz, int(raw))
            body += np.asarray(lm.err_max, "<f8").tobytes()
            body += np.asarray(lm.err_sq, "<f8").tobytes()
        crc = zlib.crc32(bytes(body)) & 0xFFFFFFFF
        return _MAGIC + struct.pack("<II", len(body), crc) + bytes(body)

    @classmethod
    def deserialize(cls, data: bytes) -> tuple["RefactoredMetadata", int]:
        if data[:8] != _MAGIC:
            if data[:6] == b"MDRTPU":
                raise FormatError(
                    "mdr-tpu stream written by an incompatible format "
                    "revision — re-refactor with this version"
                )
            raise FormatError("not an mdr-tpu stream")
        size, crc = struct.unpack_from("<II", data, 8)
        body = bytes(data[16 : 16 + size])
        if len(body) != size or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            raise FormatError("corrupted MDR metadata")
        p = 0
        dt, nd, B, total, has_coords, enc, orth, reorg, reorg_s = \
            struct.unpack_from("<BBIQBBBBd", body, p)
        p += struct.calcsize("<BBIQBBBBd")
        (ilv,) = struct.unpack_from("<B", body, p)
        p += 1
        shape = []
        for _ in range(nd):
            (n,) = struct.unpack_from("<Q", body, p)
            p += 8
            shape.append(n)
        coords = None
        if has_coords:
            coords = []
            for n in shape:
                coords.append(np.frombuffer(body, "<f8", count=n, offset=p).copy())
                p += 8 * n
        (l_target,) = struct.unpack_from("<I", body, p)
        p += 4
        (nlev,) = struct.unpack_from("<I", body, p)
        p += 4
        levels = []
        for _ in range(nlev):
            exp, n = struct.unpack_from("<iQ", body, p)
            p += struct.calcsize("<iQ")
            (nplanes,) = struct.unpack_from("<I", body, p)
            p += 4
            sizes, raws = [], []
            for _ in range(nplanes):
                sz, codec = struct.unpack_from("<IB", body, p)
                p += 5
                sizes.append(sz)
                raws.append(int(codec))
            err_max = np.frombuffer(body, "<f8", count=B + 1, offset=p).copy()
            p += 8 * (B + 1)
            err_sq = np.frombuffer(body, "<f8", count=B + 1, offset=p).copy()
            p += 8 * (B + 1)
            levels.append(LevelMetadata(exp, n, sizes, raws, err_max, err_sq))
        meta = cls(
            dtype=data_type(dt),
            shape=tuple(shape),
            l_target=l_target,
            number_bitplanes=B,
            total_num_elems=total,
            levels=levels,
            coords=coords,
            encoding=bitplane_encoding_type(enc),
            orthogonal=bool(orth),
            reorganized=bool(reorg),
            reorg_s=float(reorg_s),
            interleaver=int(ilv),
        )
        return meta, 16 + size


@dataclasses.dataclass
class RefactoredData:
    # planes[l][p] = compressed bytes of plane p of level l (0 = sign plane)
    planes: List[List[bytes]]


@dataclasses.dataclass
class ReconstructedData:
    data: Optional[torch.Tensor] = None  # on the reconstruct's device
    used: List[int] = dataclasses.field(default_factory=list)


# ----------------------------------------------------------------------
def _field_tensor(data, device):
    v = as_tensor(data, device)
    if v.dtype not in _TORCH_TYPES:
        raise TypeError(f"unsupported dtype {v.dtype}; MDR takes float32 "
                        "or float64")
    return v


@traced("kernel.mdr_decompose")
def _refactor_levels(v, hier: Hierarchy, B: int, negabinary: bool,
                     orthogonal: bool, interleaver: int):
    """Device phase of MDRefactor: decompose, then per level interleave,
    pad and encode. Returns [(planes, exp, err_max_u, err_sq_u)] as device
    tensors, without waiting for the device."""
    enc = (bitplane.encode_kernel_negabinary if negabinary
           else bitplane.encode_kernel)
    dec = decompose(v, hier, orthogonal=orthogonal)
    return [enc(bitplane.pad_stream(interleave_level(dec, hier, l,
                                                     interleaver)), B)
            for l in range(hier.l_target + 1)]


def _encode_planes(planes_h, dispatched, lvl_codec):
    """One level's planes as stored: each row of the host bit patterns
    ``planes_h`` as its zlib or BFX blob (``dispatched``: the level's BFX
    packs, None where a plane has none) or raw, whichever is smaller.
    Returns (sizes, codecs, blobs); a raw blob is copied out of
    ``planes_h``."""
    sizes, raws, blobs = [], [], []
    with span("codec.plane_encode"):
        for p in range(planes_h.shape[0]):
            raw_bytes = memoryview(planes_h[p]).cast("B")
            cand, cid = None, PLANE_RAW
            if lvl_codec == "zlib":
                cand, cid = zlib.compress(raw_bytes, 1), PLANE_ZLIB
            elif dispatched[p] is not None:
                cand = join(_bfx.serialize_device_parts(dispatched[p]))
                cid = PLANE_BFX
            best, codec = choose_plane_blob(raw_bytes, cand, cid)
            if codec == PLANE_RAW:
                best = bytes(best)
            blobs.append(best)
            sizes.append(len(best))
            raws.append(codec)
            count(_PLANE_COUNTERS[codec])
            count("mdr.plane.bytes_in", len(raw_bytes))
            count("mdr.plane.bytes_out", len(best))
    return sizes, raws, blobs


@traced("api.mdr_refactor")
def MDRefactor(data, config: Optional[Config] = None,
               coords: Optional[Sequence[np.ndarray]] = None, device=None):
    """Refactor a float32/float64 field into progressive bitplane
    components. ``data`` is a torch tensor (refactored where it lives) or
    a NumPy array (moved to ``device``, default the CUDA card). Returns
    (RefactoredMetadata, RefactoredData).
    Reference: MDR::MDRefactor (mdr_x.hpp:16, MDRHighLevel.hpp:74-173)."""
    config = config or Config()
    v = _field_tensor(data, device)
    ndt = _TORCH_TYPES[v.dtype]
    shape = tuple(int(s) for s in v.shape)
    coords_list = [np.asarray(c, np.float64) for c in coords] if coords else None
    hier = get_hierarchy(shape, ndt, coords_list, config)
    B = int(config.total_num_bitplanes)
    negabinary = config.mdr_encoding == bitplane_encoding_type.NegaBinary
    orthogonal = bool(config.mdr_orthogonal_basis)
    interleaver = _INTERLEAVERS[config.mdr_interleaver]
    results = _refactor_levels(v, hier, B, negabinary, orthogonal,
                               interleaver)

    # dispatch the BFX pack of every (level, plane) row before serializing
    # anything: the device runs them back to back
    lvl_codec = config.mdr_level_compressor
    dispatched = [
        [_bfx.encode_device(planes[p])
         if lvl_codec == "bfx" and planes.shape[1] >= PLANE_BFX_MIN_WORDS
         else None for p in range(planes.shape[0])]
        for planes, _exp, _em, _es in results]
    levels = []
    planes_data: List[List[bytes]] = []
    for l, (planes, exp, err_max, err_sq) in enumerate(results):
        exp = int(to_host(exp))
        err_max, err_sq = bitplane.scale_tables(err_max, err_sq, exp, B,
                                                negabinary)
        # (B+1 or B, m) u32 bit patterns: a bulk copy staged like a stream's,
        # into the process's warm scratch
        with host_scratch(planes.numel() * planes.element_size()) as buf:
            to_host_into(planes.contiguous(), buf)
            sizes, raws, blobs = _encode_planes(
                buf.view("<i4").reshape(tuple(planes.shape)), dispatched[l],
                lvl_codec)
        levels.append(LevelMetadata(exp, level_num_elems(hier, l), sizes,
                                    raws, err_max, err_sq))
        planes_data.append(blobs)

    meta = RefactoredMetadata(
        dtype=dtype_enum(ndt),
        shape=shape,
        l_target=hier.l_target,
        number_bitplanes=B,
        total_num_elems=hier.total_num_elems,
        levels=levels,
        coords=coords_list,
        encoding=config.mdr_encoding,
        orthogonal=orthogonal,
        interleaver=interleaver,
    )
    return meta, RefactoredData(planes=planes_data)


@traced("api.mdr_request")
def MDRequest(meta: RefactoredMetadata, tol: float,
              s: float = float("inf")) -> List[int]:
    """Plan per-level bitplane counts for a target tolerance.
    Reference: MDR::MDRequest -> GreedyBasedSizeInterpreter."""
    counts = interpret_retrieve_size(meta, tol, s)
    meta.requested = counts
    return counts


def retrieve_size(meta: RefactoredMetadata, counts: Sequence[int]) -> int:
    """Bytes needed to satisfy a retrieval plan (incremental over prev_used)."""
    prev = meta.prev_used or [0] * len(counts)
    sr = meta.sign_rows
    total = 0
    for lm, c, pu in zip(meta.levels, counts, prev):
        if sr and c > 0 and pu == 0:
            total += lm.plane_sizes[0]  # sign plane
        for b in range(pu, c):
            total += lm.plane_sizes[b + sr]
    return total


@traced("kernel.mdr_recompose")
def _reconstruct_levels(planes_list, exps, hier: Hierarchy, B: int, counts,
                        negabinary: bool, orthogonal: bool, dtype,
                        interleaver: int, device):
    """Device phase of MDReconstruct: per-level bitplane decode,
    deinterleave into the nested-box layout, recompose."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    dec_fn = (bitplane.decode_kernel_negabinary if negabinary
              else bitplane.decode_kernel)
    dec = torch.zeros(hier.shape, dtype=tdt, device=device)
    for l, planes in enumerate(planes_list):
        b = counts[l]
        if b == 0:
            continue
        vals = dec_fn(planes, exps[l], B, b, tdt)
        off = 0
        for r in level_regions(hier, l):
            shp = tuple(s.stop - s.start for s in r)
            n = int(np.prod(shp))
            dec[r] = region_deinterleave(vals[off:off + n], shp, interleaver)
            off += n
    return recompose(dec, hier, orthogonal=orthogonal)


@traced("api.mdr_reconstruct")
def MDReconstruct(meta: RefactoredMetadata, data: RefactoredData,
                  counts: Optional[Sequence[int]] = None,
                  config: Optional[Config] = None,
                  state: Optional[ReconstructedData] = None,
                  device=None) -> ReconstructedData:
    """Reconstruct on ``device`` (default the CUDA card) using counts[l]
    magnitude planes per level; ``.data`` is a tensor there.
    Reference: MDR::MDReconstruct -> ComposedReconstructor::
    ProgressiveReconstruct (MDRHighLevel.hpp:215-357)."""
    dev = resolve_device(device)
    config = config or Config()
    counts = list(counts if counts is not None else meta.requested)
    dtype = np_dtype(meta.dtype)
    hier = get_hierarchy(meta.shape, dtype, meta.coords, config)
    sr = meta.sign_rows
    planes_list, exps = [], []
    for l, lm in enumerate(meta.levels):
        b = counts[l]
        m = bitplane.padded_words(lm.n)
        # a level with no requested planes contributes nothing (its plane
        # blobs may not even have been retrieved)
        nrows = (sr + b) if b > 0 else 0
        rows = None
        if nrows:
            with span("codec.plane_decode"):
                rows = decode_plane_rows(
                    data.planes[l][:nrows],
                    [int(c) for c in lm.plane_raw[:nrows]], m, dev)
        planes_list.append(rows)
        exps.append(lm.exp)
    rec = _reconstruct_levels(planes_list, exps, hier, meta.number_bitplanes,
                              counts, sr == 0, bool(meta.orthogonal), dtype,
                              int(meta.interleaver), dev)
    out = state or ReconstructedData()
    out.data = rec
    out.used = counts
    meta.prev_used = counts
    return out


# ----------------------------------------------------------------------
# File writer/retriever (reference: ConcatLevelFileWriter /
# ConcatLevelFileRetriever) and Reorganizer (reference: BasicReorganizer —
# segments in error-impact order, so a byte-range prefix read retrieves the
# most useful planes)
# ----------------------------------------------------------------------
def segment_order(meta: RefactoredMetadata):
    """Deterministic storage order of (level, row) segments: level-major
    when not reorganized; otherwise greedy error-impact order (each level's
    sign plane right before its first magnitude plane) under the persisted
    meta.reorg_s norm. Readers recompute it from the metadata alone."""
    L = len(meta.levels)
    sr = meta.sign_rows
    if not meta.reorganized:
        return [(l, p) for l in range(L)
                for p in range(len(meta.levels[l].plane_sizes))]
    s = meta.reorg_s

    def gain(l, b):
        lm = meta.levels[l]
        red = float(lm.err_max[b] - lm.err_max[b + 1]) if math.isinf(s) \
            else float(lm.err_sq[b] - lm.err_sq[b + 1])
        cost = lm.plane_sizes[b + sr] + (lm.plane_sizes[0]
                                         if (b == 0 and sr) else 0)
        return red / max(cost, 1)

    order = []
    heap = [(-gain(l, 0), l, 0) for l in range(L)]
    heapq.heapify(heap)
    B = meta.number_bitplanes
    while heap:
        _, l, b = heapq.heappop(heap)
        if b == 0 and sr:
            order.append((l, 0))
        order.append((l, b + sr))
        if b + 1 < B:
            heapq.heappush(heap, (-gain(l, b + 1), l, b + 1))
    return order


def write_mdr(path: str, meta: RefactoredMetadata, data: RefactoredData,
              s: float = float("inf")) -> None:
    if meta.reorganized:
        meta.reorg_s = float(s)  # persisted; readers re-derive the order
    header = meta.serialize()
    with open(path, "wb") as f:
        f.write(header)
        for l, p in segment_order(meta):
            f.write(data.planes[l][p])


def read_mdr_metadata(path: str) -> tuple[RefactoredMetadata, int]:
    with open(path, "rb") as f:
        head = f.read(16)
        size, _ = struct.unpack_from("<II", head, 8)
        body = f.read(size)
    return RefactoredMetadata.deserialize(head + body)


def read_mdr_planes(path: str, meta: RefactoredMetadata, counts: Sequence[int],
                    header_size: int) -> RefactoredData:
    """Retrieve only the planes a plan needs (byte-ranged reads); the
    segment order comes from the header (meta.reorg_s)."""
    offsets = [[None] * len(lm.plane_sizes) for lm in meta.levels]
    off = header_size
    for l, p in segment_order(meta):
        sz = meta.levels[l].plane_sizes[p]
        offsets[l][p] = (off, sz)
        off += sz
    planes: List[List[bytes]] = []
    with open(path, "rb") as f:
        for l, lm in enumerate(meta.levels):
            need = meta.sign_rows + counts[l] if counts[l] > 0 else 0
            lvl = []
            for p in range(len(lm.plane_sizes)):
                if p < need:
                    f.seek(offsets[l][p][0])
                    lvl.append(f.read(offsets[l][p][1]))
                else:
                    lvl.append(b"")
            planes.append(lvl)
    return RefactoredData(planes=planes)


# ----------------------------------------------------------------------
# MDR over a decomposed domain (reference: MDRHighLevel.hpp:74-173 runs
# MDRefactor/MDReconstruct per DomainDecomposer subdomain; subdomains are
# halo-free and independent)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DecomposedMDR:
    shape: tuple
    subdomain_slices: List[tuple]
    metas: List[RefactoredMetadata]
    datas: List[RefactoredData]


def MDRefactorDecomposed(data, config: Optional[Config] = None,
                         coords: Optional[Sequence[np.ndarray]] = None,
                         device=None) -> DecomposedMDR:
    """Refactor each DomainDecomposer subdomain independently."""
    from ..decomposer import DomainDecomposer

    config = config or Config()
    v = _field_tensor(data, device)
    shape = tuple(int(s) for s in v.shape)
    dd = DomainDecomposer(shape, _TORCH_TYPES[v.dtype], config,
                          device=v.device)
    metas, datas, sls = [], [], []
    coords_list = [np.asarray(c, np.float64) for c in coords] if coords else None
    for i in range(dd.num_subdomains):
        sl = dd.subdomain_slices(i)
        sub_coords = (
            [c[s] for c, s in zip(coords_list, sl)] if coords_list else None
        )
        m, d = MDRefactor(v[sl], config, sub_coords)
        metas.append(m)
        datas.append(d)
        sls.append(sl)
    return DecomposedMDR(shape=shape, subdomain_slices=sls, metas=metas,
                         datas=datas)


def MDRequestDecomposed(dmdr: DecomposedMDR, tol: float,
                        s: float = float("inf")) -> List[List[int]]:
    """Per-subdomain plans for a global tolerance. estimate_error returns
    RMS-normalized bounds and the global RMS is a weighted mean of the
    subdomains' RMS, so each subdomain meeting tol implies the global bound
    for s=inf and finite s alike."""
    return [MDRequest(m, tol, s) for m in dmdr.metas]


def MDReconstructDecomposed(dmdr: DecomposedMDR,
                            counts: Optional[List[List[int]]] = None,
                            config: Optional[Config] = None, device=None):
    """Reconstruct the full domain from per-subdomain plans: a tensor on
    ``device`` (default the CUDA card)."""
    dev = resolve_device(device)
    config = config or Config()
    tdt = torch.float32 if np_dtype(dmdr.metas[0].dtype) == np.float32 \
        else torch.float64
    out = torch.empty(dmdr.shape, dtype=tdt, device=dev)
    for i, (m, d, sl) in enumerate(
        zip(dmdr.metas, dmdr.datas, dmdr.subdomain_slices)
    ):
        c = counts[i] if counts is not None else None
        out[sl] = MDReconstruct(m, d, c, config, device=dev).data
    return out
