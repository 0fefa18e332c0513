"""Self-describing compressed-file metadata header.

Re-design of the reference Metadata (reference: include/mgard-x/Metadata/
Metadata.hpp:20-262, src/mgard-x/Metadata/Metadata.cpp:28-38): a binary
header carrying everything needed to decompress with zero external state —
magic signature, versions, dtype/shape/coords, decomposition type, error
bound (type, tol, s, norm), lossless backend and its knobs, domain
decomposition — protected by CRC32.

The byte layout is this framework's own (little-endian, struct-packed); the
field set matches the reference's so the format is equally self-describing.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from ..dtypes import (
    bitplane_encoding_type,
    compressor_type,
    data_structure_type,
    data_type,
    decomposition_type,
    domain_decomposition_type,
    endiness_type,
    error_bound_type,
    lossless_type,
    norm_type,
    operation_type,
    processor_type,
)
from ..utils.trace import traced

MAGIC = b"MGARDTPU"
SOFTWARE_VERSION = (0, 2, 0)
# Bumped 1.0.0 -> 2.0.0 when the body layout changed (hybrid_grouping byte
# added, Huffman_LZ4 payload switched zlib -> native LZ4): older streams are
# rejected with a clean unsupported-version error instead of parsing with
# shifted offsets (reference analogue: version gate in Metadata.hpp:20-75).
FILE_VERSION = (2, 2, 0)  # 2.1: hybrid front-end flag 2 (fused v3 tile-major
# streams); 2.2: f64 precision-demotion flag (payload is the f32 image of a
# double field, cast error pre-deducted from the stored tolerance)


class FormatError(ValueError):
    pass


@dataclasses.dataclass
class Metadata:
    dtype: data_type = data_type.Float
    shape: Sequence[int] = ()
    dstype: data_structure_type = data_structure_type.Cartesian_Grid_Uniform
    coords: Optional[List[np.ndarray]] = None  # float64 per-dim, non-uniform only

    decomposition: decomposition_type = decomposition_type.MultiDim
    l_target: int = 0
    reorder: int = 0

    domain_decomposed: bool = False
    ddtype: domain_decomposition_type = domain_decomposition_type.MaxDim
    domain_decomposed_dim: int = 0
    domain_decomposed_size: int = 0
    # per-subdomain sizes along domain_decomposed_dim (Variable strategy only)
    dd_variable_sizes: Sequence[int] = ()

    otype: operation_type = operation_type.Compression
    betype: bitplane_encoding_type = bitplane_encoding_type.SignMagnitude
    number_bitplanes: int = 0

    ebtype: error_bound_type = error_bound_type.ABS
    norm: float = 0.0
    tol: float = 0.0
    ntype: norm_type = norm_type.L_Inf
    s: float = float("inf")

    ltype: lossless_type = lossless_type.Huffman
    huff_dict_size: int = 8192
    huff_block_size: int = 1024
    block_delta_block_size: int = 256

    ptype: processor_type = processor_type.X_TPU
    # low-level compressor selection (reference: compressor_type in
    # Types.h:85 - MGARD multigrid pipeline or the ZFP-style transform
    # compressor behind the same interface)
    ctype: compressor_type = compressor_type.MGARD
    # Hybrid decomposition: number of local (blockwise 8^3) refactoring
    # levels (reference: Config.num_local_refactoring_level)
    nlocal: int = 0
    # input shape was padded by ShapeAdjustment before compression
    # (reference: CompressionHighLevel/ShapeAdjustment.hpp); the stored
    # shape is the ORIGINAL, the adjusted one is recomputed
    adjusted: bool = False
    # Hybrid decomposition: symbols were zclass-grouped before the entropy
    # stage (Config.hybrid_level_grouping); its own field, NOT aliased onto
    # reorder (user-settable reorder must not corrupt decode)
    hybrid_grouping: bool = False

    # region-of-interest adaptive bounds (ops/roi.py); the ROI mask itself
    # travels in the payload
    roi_enabled: bool = False
    roi_factor: float = 1.0

    # f64 precision demotion (file 2.2): the payload encodes float32 data;
    # dtype above records the ORIGINAL (Double) so decompress returns f64.
    # The f64->f32 cast error was deducted from tol at compress time, so
    # the stored (ABS) tolerance certifies the final double output.
    demoted: bool = False

    # NOT a wire field: the minimum minor file version the stream's
    # features actually require (0 unless a 2.1+ section — hybrid flag 2 —
    # is written). Stamping the minimum keeps older readers able to parse
    # everything they understand, despite the minor forward-gate below.
    wire_minor: int = 0

    @traced("api.metadata")
    def serialize(self) -> bytes:
        body = bytearray()
        # a demoted stream decodes to the wrong dtype on pre-2.2 readers
        # (they ignore the trailing flag byte), so it must carry minor >= 2
        # and be cleanly rejected there; plain streams keep the minimum
        minor = max(int(self.wire_minor), 2 if self.demoted else 0)
        minor = min(minor, FILE_VERSION[1])
        body += struct.pack(
            "<3B3B", *SOFTWARE_VERSION,
            FILE_VERSION[0], minor, FILE_VERSION[2],
        )
        body += struct.pack("<B", endiness_type.Little_Endian)
        body += struct.pack("<BB", int(self.dtype), int(self.dstype))
        body += struct.pack("<B", len(self.shape))
        for n in self.shape:
            body += struct.pack("<Q", int(n))
        if self.dstype == data_structure_type.Cartesian_Grid_Non_Uniform:
            if self.coords is None or len(self.coords) != len(self.shape):
                raise FormatError("non-uniform metadata requires per-dim coords")
            for c in self.coords:
                body += np.asarray(c, dtype="<f8").tobytes()
        body += struct.pack(
            "<BII", int(self.decomposition), int(self.l_target), int(self.reorder)
        )
        body += struct.pack(
            "<BBBQ",
            1 if self.domain_decomposed else 0,
            int(self.ddtype),
            int(self.domain_decomposed_dim),
            int(self.domain_decomposed_size),
        )
        body += struct.pack("<I", len(self.dd_variable_sizes))
        for v in self.dd_variable_sizes:
            body += struct.pack("<Q", int(v))
        body += struct.pack("<BBQ", int(self.otype), int(self.betype), int(self.number_bitplanes))
        body += struct.pack(
            "<BddBd", int(self.ebtype), float(self.norm), float(self.tol), int(self.ntype), float(self.s)
        )
        body += struct.pack(
            "<BIII",
            int(self.ltype),
            int(self.huff_dict_size),
            int(self.huff_block_size),
            int(self.block_delta_block_size),
        )
        body += struct.pack("<B", int(self.ptype))
        body += struct.pack(
            "<BBBB", int(self.ctype), int(self.nlocal),
            1 if self.adjusted else 0,
            1 if self.hybrid_grouping else 0,
        )
        body += struct.pack("<Bd", 1 if self.roi_enabled else 0, float(self.roi_factor))
        # trailing 2.2 field: 2.0/2.1 readers parse positionally and never
        # check for trailing bytes, so appending is forward-safe for every
        # stream whose features they support (demoted ones are version-gated)
        body += struct.pack("<B", 1 if self.demoted else 0)

        crc = zlib.crc32(bytes(body)) & 0xFFFFFFFF
        header = MAGIC + struct.pack("<II", len(body), crc)
        return header + bytes(body)

    @classmethod
    @traced("api.metadata")
    def deserialize(cls, data: bytes) -> tuple["Metadata", int]:
        """Parse header; returns (metadata, total header size in bytes)."""
        if len(data) < len(MAGIC) + 8 or data[: len(MAGIC)] != MAGIC:
            # Interop decision (SURVEY sanctions "byte-compatible where
            # practical"): streams produced by the reference C++/CUDA
            # libraries (signature "MGARD", MGARDConfig.hpp.in:22) carry
            # backend-specific Huffman/LZ4 payloads this framework does
            # not decode; sniff and say so explicitly instead of a
            # generic signature error.
            if data[:5] == b"MGARD" and data[5:8] != b"TPU":
                raise FormatError(
                    "stream was produced by the reference MGARD/MGARD-X "
                    "library; cross-decoding foreign payloads is not "
                    "supported — re-compress with mgard-tpu"
                )
            raise FormatError("not an mgard-tpu stream (bad signature)")
        off = len(MAGIC)
        size, crc = struct.unpack_from("<II", data, off)
        off += 8
        body = bytes(data[off : off + size])
        if len(body) != size:
            raise FormatError("truncated metadata")
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            raise FormatError("metadata CRC32 mismatch (corrupted header)")

        m = cls()
        p = 0
        sv = struct.unpack_from("<3B", body, p)
        p += 3
        fv = struct.unpack_from("<3B", body, p)
        p += 3
        if fv[0] != FILE_VERSION[0] or fv[1] > FILE_VERSION[1]:
            # minor versions are forward-incompatible additions (e.g. 2.1's
            # hybrid front-end flag 2): a stream whose minor exceeds this
            # build's would misparse, so reject it cleanly — older streams
            # (lower minor) always parse
            raise FormatError(
                f"unsupported mgard-tpu file version {fv[0]}.{fv[1]}.{fv[2]} "
                f"(this build reads {FILE_VERSION[0]}.0.x through "
                f"{FILE_VERSION[0]}.{FILE_VERSION[1]}.x); re-compress with "
                "a matching version"
            )
        (_endian,) = struct.unpack_from("<B", body, p)
        p += 1
        dt, ds = struct.unpack_from("<BB", body, p)
        p += 2
        m.dtype = data_type(dt)
        m.dstype = data_structure_type(ds)
        (d,) = struct.unpack_from("<B", body, p)
        p += 1
        shape = []
        for _ in range(d):
            (n,) = struct.unpack_from("<Q", body, p)
            p += 8
            shape.append(n)
        m.shape = tuple(shape)
        if m.dstype == data_structure_type.Cartesian_Grid_Non_Uniform:
            m.coords = []
            for n in shape:
                c = np.frombuffer(body, dtype="<f8", count=n, offset=p).copy()
                p += 8 * n
                m.coords.append(c)
        dec, lt, ro = struct.unpack_from("<BII", body, p)
        p += 9
        m.decomposition = decomposition_type(dec)
        m.l_target, m.reorder = lt, ro
        dd, ddt, dddim, ddsize = struct.unpack_from("<BBBQ", body, p)
        p += 11
        m.domain_decomposed = bool(dd)
        m.ddtype = domain_decomposition_type(ddt)
        m.domain_decomposed_dim, m.domain_decomposed_size = dddim, ddsize
        (nvar,) = struct.unpack_from("<I", body, p)
        p += 4
        var_sizes = []
        for _ in range(nvar):
            (vs,) = struct.unpack_from("<Q", body, p)
            p += 8
            var_sizes.append(vs)
        m.dd_variable_sizes = tuple(var_sizes)
        ot, bt, nbp = struct.unpack_from("<BBQ", body, p)
        p += 10
        m.otype, m.betype, m.number_bitplanes = operation_type(ot), bitplane_encoding_type(bt), nbp
        eb, norm, tol, nt, s = struct.unpack_from("<BddBd", body, p)
        p += 26
        m.ebtype, m.norm, m.tol, m.ntype, m.s = (
            error_bound_type(eb),
            norm,
            tol,
            norm_type(nt),
            s,
        )
        ltp, hds, hbs, bdbs = struct.unpack_from("<BIII", body, p)
        p += 13
        m.ltype = lossless_type(ltp)
        m.huff_dict_size, m.huff_block_size, m.block_delta_block_size = hds, hbs, bdbs
        (pt,) = struct.unpack_from("<B", body, p)
        p += 1
        m.ptype = processor_type(pt)
        ct, nloc, adj, hg = struct.unpack_from("<BBBB", body, p)
        p += 4
        m.ctype = compressor_type(ct)
        m.nlocal = nloc
        m.adjusted = bool(adj)
        m.hybrid_grouping = bool(hg)
        roi_en, roi_f = struct.unpack_from("<Bd", body, p)
        p += 9
        m.roi_enabled = bool(roi_en)
        m.roi_factor = roi_f
        if p < len(body):  # 2.2+ trailing field; absent in older streams
            (dem,) = struct.unpack_from("<B", body, p)
            p += 1
            m.demoted = bool(dem)
        return m, len(MAGIC) + 8 + size
