"""Streams of the reference MGARD libraries: reader and writer (port of
``mgard_tpu/formats/ref_stream.py``).

The reference's self-describing format (reference:
src/mgard-x/Metadata/Metadata.cpp:267-492) is

    b"MGARD" | header_size: u64 LE | header_crc32: u32 LE | protobuf Header

followed by, per subdomain, `compressed_size: u64 LE` + the low-level
compressor's payload (reference: GPUPipelines.hpp:187-191). The header is
the `mgard::pb::Header` protobuf message (reference: src/mgard.proto:175-193);
it is parsed here with a minimal dependency-free wire-format reader, so no
generated protobuf bindings are needed. A stream of this package starts
with ``b"MGARDTPU"`` instead (``metadata.MAGIC``), which ``sniff`` tells
apart.

Every lossless class the reference serializes is decoded: X_LZ4 (the
portable block-LZ4 container, reference include/mgard-x/Lossless/LZ4/
LZ4.hpp:24-30, each chunk a standard LZ4 block decoded by the port's
``native/lz4.cpp``, holding the raw little-endian int64 quantized
stream), the GPU-Huffman container bare or inside LZ4 or Zstd,
BlockDelta, SymbolRans and ZeroRLE+rANS; a CPU-generation stream goes to
``formats/cpu_stream.py``. The section decoders are host NumPy, as in the
JAX package: they walk bytes. The symbols then go to the caller's device,
where the port's own dequantize and recompose (``ops/quantize.py``,
``ops/refactor.py``) rebuild the field; they are pinned ulp-class to the
reference MGARD-X serial transform. ``compress_reference`` writes an
X_LZ4 stream that the reference library reads, from the transform and
quantizer on the field's device.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from typing import List, Optional

import numpy as np

from ..dtypes import error_bound_type
from .metadata import FormatError

SIGNATURE = b"MGARD"

# mgard::pb::Encoding::Compressor values (reference: src/mgard.proto:138-150)
ENC_NOOP = 0
ENC_CPU_HUFFMAN_ZLIB = 1
ENC_CPU_HUFFMAN_ZSTD = 2
ENC_X_HUFFMAN = 3
ENC_X_HUFFMAN_LZ4 = 4
ENC_X_HUFFMAN_ZSTD = 5
ENC_X_BLOCK_DELTA = 6
ENC_X_LZ4 = 8
ENC_X_SYMBOL_RANS = 9
ENC_X_ZERORLE_RANS = 10


# ----------------------------------------------------------------------
# Minimal protobuf wire-format reader (proto3, no codegen)
# ----------------------------------------------------------------------
def _read_varint(buf: bytes, p: int):
    out = 0
    shift = 0
    while True:
        if p >= len(buf):
            raise FormatError("truncated varint in reference header")
        b = buf[p]
        p += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, p
        shift += 7
        if shift > 70:
            raise FormatError("malformed varint in reference header")


def _parse_message(buf: bytes):
    """field number -> list of raw values (int for varint/fixed, bytes for
    length-delimited)."""
    fields: dict = {}
    p = 0
    n = len(buf)
    while p < n:
        key, p = _read_varint(buf, p)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, p = _read_varint(buf, p)
        elif wtype == 1:  # 64-bit
            val = struct.unpack_from("<Q", buf, p)[0]
            p += 8
        elif wtype == 2:  # length-delimited
            ln, p = _read_varint(buf, p)
            val = buf[p : p + ln]
            p += ln
        elif wtype == 5:  # 32-bit
            val = struct.unpack_from("<I", buf, p)[0]
            p += 4
        else:
            raise FormatError(f"unsupported protobuf wire type {wtype}")
        fields.setdefault(fnum, []).append(val)
    return fields


def _first(fields, num, default=None):
    v = fields.get(num)
    return v[0] if v else default


def _as_double(v) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]


def _packed_u64s(vals) -> List[int]:
    """repeated uint64: packed (length-delimited varints) or unpacked."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, bytes):
            p = 0
            while p < len(v):
                x, p = _read_varint(v, p)
                out.append(x)
        else:
            out.append(int(v))
    return out


@dataclasses.dataclass
class RefHeader:
    shape: tuple
    dtype: np.dtype
    uniform: bool
    coords: Optional[List[np.ndarray]]
    ebtype: error_bound_type
    s: float
    tol: float
    norm: float
    decomposition: str  # "multidim" | "singledim" | "hybrid"
    l_target: int
    compressor: int  # Encoding.Compressor enum value
    huff_dict_size: int
    huff_block_size: int
    dd_method: int  # DomainDecomposition.Method (0 = none)
    dd_dim: int
    dd_size: int
    header_bytes: int  # total header size incl. preamble


def parse_header(blob: bytes) -> RefHeader:
    if blob[: len(SIGNATURE)] != SIGNATURE:
        raise FormatError("not a reference MGARD stream (bad signature)")
    p = len(SIGNATURE)
    # The MGARD-X generation serializes header size/CRC little-endian
    # (mgard-x/Metadata); the CPU generation big-endian (src/mgard/
    # format.cpp serialize<> shifts bytes out MSB-first). Accept whichever
    # order the CRC32 validates.
    body = None
    for order in ("<", ">"):
        (hsize,) = struct.unpack_from(order + "Q", blob, p)
        (crc,) = struct.unpack_from(order + "I", blob, p + 8)
        cand = bytes(blob[p + 12 : p + 12 + hsize])
        if len(cand) == hsize and (zlib.crc32(cand) & 0xFFFFFFFF) == crc:
            body = cand
            break
    if body is None:
        raise FormatError(
            "truncated reference header or header CRC32 mismatch"
        )
    total_header = p + 12 + hsize

    top = _parse_message(body)
    # Header field numbers (reference: src/mgard.proto:175-193)
    domain = _parse_message(_first(top, 4, b""))
    dataset = _parse_message(_first(top, 5, b""))
    err = _parse_message(_first(top, 6, b""))
    dd = _parse_message(_first(top, 7, b""))
    fdec = _parse_message(_first(top, 8, b""))
    enc = _parse_message(_first(top, 11, b""))

    topo = _parse_message(_first(domain, 2, b""))
    shape = tuple(_packed_u64s(topo.get(2, [])))
    geometry = int(_first(domain, 3, 0))
    coords = None
    uniform = geometry == 0  # UNIT_CUBE
    if not uniform:
        cube = _parse_message(_first(domain, 4, b""))
        flat = np.frombuffer(b"".join(
            v for v in cube.get(2, []) if isinstance(v, bytes)
        ), "<f8")
        coords = []
        off = 0
        for n in shape:
            coords.append(flat[off : off + n].copy())
            off += n

    dtype = np.dtype(np.float64 if int(_first(dataset, 1, 0)) == 1 else np.float32)

    mode = int(_first(err, 1, 0))  # 0 ABS, 1 REL
    ntype = int(_first(err, 2, 0))  # 0 L_INFINITY, 1 S_NORM
    s = _as_double(_first(err, 3, 0))
    norm = _as_double(_first(err, 4, 0)) if 4 in err else 0.0
    tol = _as_double(_first(err, 5, 0))
    if ntype == 0:
        s = math.inf

    hierarchy = int(_first(fdec, 2, 1))
    decomposition = {1: "multidim", 2: "singledim", 3: "hybrid"}.get(
        hierarchy, "multidim"
    )
    l_target = int(_first(fdec, 3, 0))

    return RefHeader(
        shape=shape,
        dtype=dtype,
        uniform=uniform,
        coords=coords,
        ebtype=error_bound_type.REL if mode == 1 else error_bound_type.ABS,
        s=s,
        tol=tol,
        norm=norm,
        decomposition=decomposition,
        l_target=l_target,
        compressor=int(_first(enc, 2, 0)),
        huff_dict_size=int(_first(enc, 3, 0)),
        huff_block_size=int(_first(enc, 4, 0)),
        dd_method=int(_first(dd, 1, 0)),
        dd_dim=int(_first(dd, 2, 0)),
        dd_size=int(_first(dd, 3, 0)),
        header_bytes=total_header,
    )


# ----------------------------------------------------------------------
# Payload decoders
# ----------------------------------------------------------------------
def _decode_x_lz4(payload: bytes) -> bytes:
    """Reference portable-LZ4 container -> raw bytes (reference:
    include/mgard-x/Lossless/LZ4/LZ4.hpp:24-30 layout, per-chunk standard
    LZ4 block format decoded by native/lz4.cpp)."""
    from ..lossless import lz4 as _lz4

    if payload[:7] != b"MGXLZ4P":
        raise FormatError("bad reference LZ4 container signature")
    p = 8
    n, chunk_size, nchunks = struct.unpack_from("<QQQ", payload, p)
    p += 24
    comp_bytes = np.frombuffer(payload, "<u8", nchunks, p)
    p += 8 * nchunks
    (packed_bytes,) = struct.unpack_from("<Q", payload, p)
    p += 8
    out = bytearray()
    off = p
    for i in range(nchunks):
        clen = int(comp_bytes[i])
        want = min(chunk_size, n - i * chunk_size)
        try:
            out += _lz4.decompress(payload[off : off + clen], int(want))
        except RuntimeError as exc:
            # the native decoder reports malformed/truncated blocks as a
            # RuntimeError; surface it as a clean format failure
            raise FormatError(f"corrupt reference LZ4 chunk: {exc}") from exc
        off += clen
    if len(out) != n:
        raise FormatError("reference LZ4 container length mismatch")
    return bytes(out)


def _decode_x_huffman(raw: bytes, expected=None) -> np.ndarray:
    """Decode the reference's serialized GPU-Huffman stream into the
    UNSHIFTED signed int64 quantized symbols.

    Layout (reference: Lossless/ParallelHuffman/Huffman.hpp Serialize /
    ComputeSerializedLayout, all fields sizeof(T)-aligned per
    RuntimeX/Utilities/Serializer.hpp advance_with_align; the quantized
    stream type is T=QUANTIZED_INT=int64 so Q=S=H are all 64-bit):
      'MGXHUFF' | primary_count u64 | dict_size i32 | chunk_size i32 |
      huffmeta_size u64 | per-chunk bit lengths u64[nchunk] |
      per-chunk word offsets u64[nchunk] | decodebook_size u64 |
      decodebook = first H[64] + entry H[64] + keys Q[dict_size] |
      ddata_size u64 | packed words H[ddata_size] (bits MSB-first) |
      outlier_count u64 | outlier idx u64[n] | outlier values i64[n]
    Canonical per-chunk decode mirrors ParallelHuffman/Decode.hpp; the
    reference folds the +dict_size/2 dictionary shift into its quantizer
    (Huffman.hpp Compress comment), so the shift is undone here and the
    generic dequantizer applies unchanged."""

    out, p, dict_size = _parse_huffman_container(raw, "<u8", expected=expected)
    (outlier_count,) = struct.unpack_from("<Q", raw, p)
    p += 8
    out_idx = np.frombuffer(raw, "<u8", int(outlier_count), p)
    p += 8 * int(outlier_count)
    out_val = np.frombuffer(raw, "<i8", int(outlier_count), p)
    if outlier_count:
        out[out_idx] = out_val.view(np.uint64)
    return out.view(np.int64) - dict_size // 2


def _parse_huffman_container(raw: bytes, key_dtype, *, expected=None):
    """Walk the serialized GPU-Huffman container layout (shared between the
    X quantized streams, Q=S=H=64-bit, and MDR-X HybridLevelCompressor's
    byte-alphabet Huffman<u8,u8,u64> groups) and canonically decode the
    primary stream. Returns (symbols as u64, offset of the trailing
    outlier section, dict_size); outlier handling differs per caller."""

    def _al(p, a):
        return (p + a - 1) // a * a

    if raw[:7] != b"MGXHUFF":
        raise FormatError("bad reference Huffman signature")
    p = _al(7, 8)
    (primary_count,) = struct.unpack_from("<Q", raw, p)
    p += 8
    _check_declared("Huffman stream", primary_count, expected)
    dict_size, chunk_size = struct.unpack_from("<ii", raw, p)
    p += 8
    (huffmeta_size,) = struct.unpack_from("<Q", raw, p)
    p += 8
    nchunk = (primary_count - 1) // chunk_size + 1
    if huffmeta_size != 2 * nchunk:
        raise FormatError("reference Huffman metadata size mismatch")
    bitlens = np.frombuffer(raw, "<u8", nchunk, p)
    p += 8 * nchunk
    woffs = np.frombuffer(raw, "<u8", nchunk, p)
    p += 8 * nchunk
    (decodebook_size,) = struct.unpack_from("<Q", raw, p)
    p += 8
    # first[] holds unsigned sentinels (0xFFFF...) for unused code lengths:
    # keep everything as unbounded Python ints, never signed numpy
    first = np.frombuffer(raw, "<u8", 64, p)
    entry = np.frombuffer(raw, "<u8", 64, p + 512)
    keys = np.frombuffer(raw, key_dtype, dict_size, p + 1024)
    p += int(decodebook_size)
    p = _al(p, 8)
    (ddata_size,) = struct.unpack_from("<Q", raw, p)
    p += 8
    p = _al(p, 8)
    packed = np.frombuffer(raw, "<u8", int(ddata_size), p)
    p += 8 * int(ddata_size)
    out = _canonical_decode_chunks(
        packed, woffs, bitlens, first, entry, keys,
        int(primary_count), int(chunk_size)
    )
    return out, p, int(dict_size)


def _canonical_decode_chunks(packed, woffs, bitlens, first, entry, keys,
                             primary_count: int, chunk_size: int):
    """Vectorized canonical Huffman decode: every chunk advances ONE bit per
    iteration in lockstep (numpy over all chunks), mirroring Decode.hpp's
    per-chunk walk exactly — including the u64 wraparound semantics of
    `v = (v << 1) | bit`. O(max chunk bits) python iterations instead of
    O(total bits): ~1 s for a 512^3 stream instead of minutes."""
    nchunk = len(bitlens)
    nb = bitlens.astype(np.int64)
    # (chunk, chunk_size)-flat grid: full chunks are dense, only the final
    # chunk is short, so out[:primary_count] is the stream in order
    out = np.zeros(nchunk * chunk_size, np.uint64)
    # per-chunk cursors; chunks whose bits are exhausted go inactive
    i = np.zeros(nchunk, np.int64)       # bit position (next bit to read)
    base = woffs.astype(np.int64)        # word offset of each chunk
    v = np.zeros(nchunk, np.uint64)
    l = np.zeros(nchunk, np.int64)       # current code length - 1
    cnt = np.zeros(nchunk, np.int64)     # symbols emitted per chunk
    with np.errstate(over="ignore"):
        # prime: v = first bit of each chunk
        w = packed[base + (i >> 6)]
        v = (w >> np.uint64(63)) & np.uint64(1)
        l[:] = 1
        active = i < nb
        while active.any():
            # emit where the current code is complete (v >= first[l])
            emit = active & (v >= first[l])
            if emit.any():
                idx = (entry[l[emit]] + v[emit] - first[l[emit]]).astype(
                    np.int64
                )
                flat = np.where(emit)[0] * chunk_size + cnt[emit]
                out[flat] = keys[idx]
                cnt[emit] += 1
                l[emit] = 0  # reset: the next bit starts a fresh code
            # consume one bit everywhere still active
            i = np.where(active, i + 1, i)
            active = i < nb
            if not active.any():
                break
            word_idx = base + (i >> 6)
            bit = (
                packed[np.where(active, word_idx, 0)]
                >> (np.uint64(63) - (i & 63).astype(np.uint64))
            ) & np.uint64(1)
            grow = active & (l > 0)
            fresh = active & (l == 0)
            v = np.where(grow, (v << np.uint64(1)) | bit, v)
            v = np.where(fresh, bit, v)
            l = np.where(active, l + 1, l)
    # last chunk may be short; every full chunk must have decoded exactly
    # chunk_size symbols
    expect = np.minimum(
        chunk_size,
        primary_count - np.arange(nchunk, dtype=np.int64) * chunk_size,
    )
    expect = np.where(nb == 0, 0, expect)
    if not np.array_equal(cnt, expect):
        bad = int(np.argmax(cnt != expect))
        raise FormatError(
            f"reference Huffman chunk {bad} decoded {int(cnt[bad])} symbols,"
            f" expected {int(expect[bad])}"
        )
    return out[:primary_count]


def _decode_x_blockdelta(payload: bytes, expected=None) -> np.ndarray:
    """Decode the reference's BlockDelta container into signed int64
    symbols (reference: Lossless/BlockDelta/BlockDelta.hpp Serialize /
    ComputeLayout layout, BlockDeltaKernels.hpp encoding: per-block
    zigzag [delta] values LSB-first bit-packed at a per-block width;
    Outlier mode peels wide values into (u16 pos, u64 zigzag) records).

    Layout (natural alignment between sections): MGXBLKD\\0 | u64 n |
    i32 block_size | u8 mode | u64 nblocks | u64 bitwidth_bytes |
    u8 bitwidth[nblocks] | [Outlier: u64 oc_bytes | u16 oc[nblocks]] |
    u64 packed_bytes | packed[] (each block byte-aligned, disjoint)."""
    MODE_FIXED, MODE_OUTLIER = 0, 2

    def _align(off, a):
        return off if off % a == 0 else (off + a - 1) // a * a

    if payload[:8] != b"MGXBLKD\x00":
        raise FormatError("bad reference BlockDelta signature")
    off = _align(8, 8)
    (n,) = struct.unpack_from("<Q", payload, off)
    off = _align(off + 8, 4)
    (block_size,) = struct.unpack_from("<i", payload, off)
    off += 4
    mode = payload[off]
    off = _align(off + 1, 8)
    (nblocks,) = struct.unpack_from("<Q", payload, off)
    off += 8
    (bw_bytes,) = struct.unpack_from("<Q", payload, off)
    off += 8
    if bw_bytes != nblocks or block_size <= 0 or nblocks != -(-n // block_size):
        raise FormatError("malformed reference BlockDelta header")
    if mode > MODE_OUTLIER:
        raise FormatError(f"unknown reference BlockDelta mode {mode}")
    _check_declared("BlockDelta stream", n, expected)
    bw = np.frombuffer(payload, np.uint8, count=nblocks, offset=off)
    off += nblocks
    oc = None
    if mode == MODE_OUTLIER:
        off = _align(off, 8)
        off += 8  # oc_bytes (redundant with nblocks)
        off = _align(off, 2)
        oc = np.frombuffer(payload, "<u2", count=nblocks, offset=off)
        off += 2 * nblocks
    off = _align(off, 8)
    (packed_bytes,) = struct.unpack_from("<Q", payload, off)
    off += 8
    packed = np.frombuffer(payload, np.uint8, count=packed_bytes, offset=off)

    # per-block byte counts -> exclusive-scan offsets (recomputed, as the
    # reference's Deserialize does)
    lens = np.minimum(block_size, n - np.arange(nblocks) * block_size)
    main_bytes = (bw.astype(np.int64) * lens + 7) // 8
    if mode == MODE_OUTLIER:
        bc = 2 + main_bytes + oc.astype(np.int64) * 10
    else:
        bc = main_bytes
    starts = np.zeros(nblocks, np.int64)
    np.cumsum(bc[:-1], out=starts[1:])
    if nblocks and starts[-1] + bc[-1] > packed.size:
        raise FormatError("reference BlockDelta packed stream truncated")

    out = np.empty(n, np.int64)
    use_delta = mode != MODE_FIXED
    for b in range(nblocks):
        w = int(bw[b])
        ln = int(lens[b])
        base = int(starts[b]) + (2 if mode == MODE_OUTLIER else 0)
        if w == 0:
            z = np.zeros(ln, np.uint64)
        else:
            nb = (w * ln + 7) // 8
            bits = np.unpackbits(packed[base : base + nb],
                                 bitorder="little")[: w * ln]
            weights = (np.uint64(1) << np.arange(w, dtype=np.uint64))
            z = (bits.reshape(ln, w).astype(np.uint64) * weights).sum(
                axis=1, dtype=np.uint64
            )
        if mode == MODE_OUTLIER and int(oc[b]):
            rp = int(starts[b]) + 2 + int(main_bytes[b])
            rec = packed[rp : rp + int(oc[b]) * 10]
            pos = rec.reshape(-1, 10)[:, :2].copy().view("<u2").ravel()
            val = rec.reshape(-1, 10)[:, 2:].copy().view("<u8").ravel()
            z[pos.astype(np.int64)] = val
        # unzigzag ((z>>1) ^ -(z&1)), then undo the delta chain
        v = ((z >> np.uint64(1)) ^ (np.uint64(0) - (z & np.uint64(1)))).astype(
            np.int64
        )
        if use_delta:
            v = np.cumsum(v)
        out[b * block_size : b * block_size + ln] = v
    return out


def _decode_x_rans(payload: bytes, expected=None,
                   expected_max=None) -> np.ndarray:
    """Decode one reference rANS container into its symbol stream
    (reference: Lossless/rANS/Rans.hpp Serialize layout + RansDecode.hpp
    DecodeFunctor semantics: static byte-renormalized 32-bit rANS, 2^23
    lower bound, per-stream segments with the block-interleaved position
    mapping RansStreamBase; ryg_rans construction).

    Layout (natural alignment): MGXRANS | u64 scale_bits | u64 alphabet |
    u64 original_length | u64 segment_size | u64 interleaved |
    u64 num_segments | u64 stream_bytes | u16 hnorm[alphabet] |
    u32 seg_offset[num_segments] | stream bytes.

    All segments decode in lockstep (one numpy step per symbol slot with a
    masked renormalization inner loop), the same chunk-vectorization as
    `_canonical_decode_chunks`."""
    if payload[:7] != b"MGXRANS":
        raise FormatError("bad reference rANS signature")
    (scale_bits, alphabet, n, S, interleaved, num_segments,
     stream_bytes) = struct.unpack_from("<7Q", payload, 8)
    _check_declared("rANS stream", n, expected)
    if expected_max is not None and int(n) > int(expected_max):
        raise FormatError(
            f"reference rANS stream declares {int(n)} symbols, more than "
            f"the {int(expected_max)} the header admits"
        )
    if not 1 <= int(scale_bits) <= 24 or not 1 <= int(alphabet) <= (1 << 20):
        raise FormatError("implausible reference rANS parameters")
    off = 8 + 56
    hnorm = np.frombuffer(payload, "<u2", int(alphabet), off)
    off += 2 * int(alphabet)
    off = (off + 3) // 4 * 4
    seg_off = np.frombuffer(payload, "<u4", int(num_segments), off)
    off += 4 * int(num_segments)
    stream = np.frombuffer(payload, np.uint8, int(stream_bytes), off)
    if interleaved:
        raise FormatError(
            "reference rANS shared-stream interleaved layout not supported"
        )
    freq = hnorm.astype(np.uint32)
    cum = np.zeros(int(alphabet) + 1, np.uint32)
    np.cumsum(freq, out=cum[1:])
    if int(cum[-1]) != (1 << int(scale_bits)):
        raise FormatError("reference rANS frequency table not normalized")
    slot2sym = np.repeat(
        np.arange(int(alphabet), dtype=np.uint32), freq.astype(np.int64)
    )
    L = np.uint32(1 << 23)
    mask = np.uint32((1 << int(scale_bits)) - 1)
    sb = np.uint32(scale_bits)
    NL = 32
    n = int(n)
    S = int(S)
    p = np.arange(int(num_segments), dtype=np.int64)
    base = (p // NL) * (NL * S) + (p % NL)
    count = np.where(base < n,
                     np.minimum((n - 1 - base) // NL + 1, S), 0)
    rp = seg_off.astype(np.int64)
    x = np.full(p.size, L, np.uint32)
    live = count > 0
    if live.any():
        r = rp[live]
        x[live] = (stream[r].astype(np.uint32)
                   | stream[r + 1].astype(np.uint32) << np.uint32(8)
                   | stream[r + 2].astype(np.uint32) << np.uint32(16)
                   | stream[r + 3].astype(np.uint32) << np.uint32(24))
        rp[live] += 4
    out = np.zeros(n, np.uint32)
    for j in range(int(count.max()) if count.size else 0):
        act = j < count
        slot = x & mask
        s = slot2sym[slot]
        out[(base + j * NL)[act]] = s[act]
        xn = freq[s] * (x >> sb) + slot - cum[s]
        need = act & (xn < L)
        while need.any():
            xn[need] = (xn[need] << np.uint32(8)) | stream[rp[need]]
            rp[need] += 1
            need = act & (xn < L)
        x = np.where(act, xn, x)
    return out


def _decode_x_symbolrans(payload: bytes, expected=None) -> np.ndarray:
    """Reference SymbolRans container -> UNSHIFTED signed int64 symbols
    (reference: Lossless/SymbolRans/SymbolRans.hpp layout: MGXSRAN |
    u64 n | u64 dict_size | u64 outlier_count | u64 rans_bytes |
    u64 outlier_idx[] | i64 outlier_val[] | rANS container over the
    dict_size alphabet). Outliers are scattered back, then the quantizer's
    +dict/2 dictionary shift is undone (LinearQuantization.hpp:108-110)."""
    if payload[:7] != b"MGXSRAN":
        raise FormatError("bad reference SymbolRans signature")
    n, dict_size, oc, rans_bytes = struct.unpack_from("<4Q", payload, 8)
    _check_declared("SymbolRans stream", n, expected)
    off = 8 + 32
    idx = np.frombuffer(payload, "<u8", int(oc), off)
    off += 8 * int(oc)
    val = np.frombuffer(payload, "<i8", int(oc), off)
    off += 8 * int(oc)
    sym = _decode_x_rans(payload[off : off + int(rans_bytes)],
                         expected=expected)
    if sym.size != int(n):
        raise FormatError("reference SymbolRans length mismatch")
    out = sym.astype(np.int64)
    if int(oc):
        out[idx.astype(np.int64)] = val
    return out - int(dict_size) // 2


def _decode_x_zerorle_rans(payload: bytes, dict_size: int,
                           expected=None) -> np.ndarray:
    """Reference ZeroRLE+rANS composite -> UNSHIFTED signed int64 symbols.
    The outer container is one byte-alphabet rANS stream whose decoded
    payload is the zero-RLE blob (Lossless.hpp:167-174): MGXZRL0 |
    u64 num_symbols | u64 original_length | u32 zero-run counts[] |
    i64 nonzero symbols[]; position[s] = inclusive_scan(counts+1)-1
    (ZeroDecode.hpp ZeroStrideFunctor). dict_size comes from the proto
    header (the quantizer shift applies to this class too)."""
    # the RLE blob cannot exceed a (u32 count, i64 symbol) pair per
    # element plus slack (Lossless.hpp rle_rans_bound)
    cap = None if expected is None else int(expected) * 12 + 64
    blob = _decode_x_rans(payload, expected_max=cap).astype(np.uint8).tobytes()
    if blob[:7] != b"MGXZRL0":
        raise FormatError("bad reference ZeroRLE signature")
    ns, orig = struct.unpack_from("<2Q", blob, 8)
    _check_declared("ZeroRLE blob", orig, expected)
    off = 8 + 16
    counts = np.frombuffer(blob, "<u4", int(ns), off)
    off += 4 * int(ns)
    off = (off + 7) // 8 * 8
    symbols = np.frombuffer(blob, "<i8", int(ns), off)
    out = np.zeros(int(orig), np.int64)
    if int(ns):
        pos = np.cumsum(counts.astype(np.int64) + 1) - 1
        if int(pos[-1]) >= int(orig):
            raise FormatError("reference ZeroRLE positions out of range")
        out[pos] = symbols
    return out - int(dict_size) // 2


def _check_declared(name: str, declared: int, expected) -> None:
    """Reject header-declared element counts that disagree with the count
    implied by the proto header's shape BEFORE allocating output — a tiny
    forged blob must produce a clean FormatError, not a multi-TB
    allocation (fuzz contract)."""
    if expected is not None and int(declared) != int(expected):
        raise FormatError(
            f"reference {name} declares {int(declared)} symbols, the "
            f"stream header implies {int(expected)}"
        )


def _decode_section(payload: bytes, compressor: int,
                    dict_size: int = 8192, expected=None) -> np.ndarray:
    """One subdomain section -> signed int64 quantized symbols. `expected`
    is the element count implied by the stream header's shape; decoders
    validate their own declared sizes against it before allocating."""
    if compressor == ENC_X_LZ4:
        if expected is not None and len(payload) > 0:
            # container's declared raw size is at offset 8 (MGXLZ4P | n)
            if len(payload) >= 16:
                (nraw,) = struct.unpack_from("<Q", payload, 8)
                _check_declared("LZ4 container", nraw // 8, expected)
        return np.frombuffer(_decode_x_lz4(payload), "<i8").copy()
    if compressor == ENC_X_BLOCK_DELTA:
        return _decode_x_blockdelta(payload, expected)
    if compressor == ENC_X_SYMBOL_RANS:
        return _decode_x_symbolrans(payload, expected)
    if compressor == ENC_X_ZERORLE_RANS:
        return _decode_x_zerorle_rans(payload, dict_size, expected)
    if compressor == ENC_X_HUFFMAN:
        return _decode_x_huffman(payload, expected)
    if compressor == ENC_X_HUFFMAN_LZ4:
        return _decode_x_huffman(_decode_x_lz4(payload), expected)
    if compressor == ENC_X_HUFFMAN_ZSTD:
        # reference Zstd container: u64 raw size + zstd frame
        # (Lossless/Zstd.hpp Compress); without the zstandard package a
        # real frame raises host.ZstdNotAvailable
        from ..lossless.host import zstd_decompress

        (n,) = struct.unpack_from("<Q", payload, 0)
        return _decode_x_huffman(zstd_decompress(payload[8:], int(n)),
                                 expected)
    raise FormatError(f"unsupported reference lossless backend {compressor}")


# ----------------------------------------------------------------------
# Reference-stream WRITER: emit files the reference library decompresses
# ----------------------------------------------------------------------
def _w_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _w_vfield(num: int, val: int) -> bytes:
    if not val:
        return b""  # proto3 omits default values
    return _w_varint(num << 3 | 0) + _w_varint(int(val))


def _w_dfield(num: int, val: float) -> bytes:
    return _w_varint(num << 3 | 1) + struct.pack("<d", float(val))


def _w_msg(num: int, payload: bytes) -> bytes:
    if not payload:
        return b""
    return _w_varint(num << 3 | 2) + _w_varint(len(payload)) + payload


def _w_packed_u64(num: int, vals) -> bytes:
    body = b"".join(_w_varint(int(v)) for v in vals)
    return _w_varint(num << 3 | 2) + _w_varint(len(body)) + body


def _encode_x_lz4(raw: bytes, chunk_size: int = 1 << 15) -> bytes:
    """Write the reference's portable-LZ4 container (LZ4.hpp:25-29 layout:
    signature(8) | n | chunk_size | nchunks | comp_bytes[nchunks] |
    packed_bytes | packed). Each chunk is a standard LZ4 block."""
    from ..lossless import lz4 as _lz4

    n = len(raw)
    nchunks = (n - 1) // chunk_size + 1
    chunks = [
        _lz4.compress(raw[i * chunk_size : (i + 1) * chunk_size])
        for i in range(nchunks)
    ]
    packed = b"".join(chunks)
    return (
        b"MGXLZ4P\x00"
        + struct.pack("<QQQ", n, chunk_size, nchunks)
        + b"".join(struct.pack("<Q", len(c)) for c in chunks)
        + struct.pack("<Q", len(packed))
        + packed
    )


def serialize_reference_header(shape, dtype, tol: float, s: float,
                               ebtype, norm: float, l_target: int) -> bytes:
    """Build the reference's binary metadata preamble + proto3 header
    (field ids from the reference's src/mgard.proto:175-193; values mirror
    Metadata.cpp FillForCompression for a whole-domain uniform MultiDim
    X_LZ4 stream on the SERIAL backend)."""
    D = len(shape)
    s_inf = math.isinf(s)
    topo = _w_vfield(1, D) + _w_packed_u64(2, shape)
    domain = _w_msg(2, topo)  # topology + geometry default UNIT_CUBE
    dataset = _w_vfield(1, 1 if np.dtype(dtype) == np.float64 else 0) + \
        _w_vfield(2, 1)
    errctl = (
        _w_vfield(1, 1 if ebtype == error_bound_type.REL else 0)
        + _w_vfield(2, 0 if s_inf else 1)
        + _w_dfield(3, 0.0 if s_inf else s)
        + _w_dfield(4, norm)
        + _w_dfield(5, tol)
    )
    fdec = _w_vfield(2, 1) + _w_vfield(3, l_target)  # MULTIDIM ghost nodes
    quant = _w_vfield(1, 1) + _w_vfield(3, 3)  # COEFFICIENTWISE_LINEAR i64
    enc = _w_vfield(2, ENC_X_LZ4)
    dev = _w_vfield(1, 1)  # X_SERIAL
    body = (
        _w_msg(2, _w_vfield(1, 1) + _w_vfield(2, 6))   # mgard_version 1.6
        + _w_msg(3, _w_vfield(1, 1))                   # file version 1.0
        + _w_msg(4, domain)
        + _w_msg(5, dataset)
        + _w_msg(6, errctl)
        + _w_msg(8, fdec)
        + _w_msg(9, quant)
        + _w_msg(11, enc)
        + _w_msg(12, dev)
    )
    return (SIGNATURE + struct.pack("<Q", len(body))
            + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF) + body)


def compress_reference(data, tol: float, s: float = math.inf,
                       mode=error_bound_type.ABS, device=None) -> bytes:
    """Compress into a REFERENCE-format MGARD-X stream (whole-domain,
    uniform grid, X_LZ4 lossless) that the reference library's own
    decompressor reads. The transform/quantizer match the reference to ulp
    (tests/golden decomposition parity), so the reference's reconstruction
    of this stream holds the certified bound. The bidirectional half of
    the reference's own any-stream-anywhere contract
    (compress_internal.cpp:5-13).

    A tensor is transformed and quantized where it lives; anything else on
    ``device`` (the CUDA card unless the caller asks for the CPU). The
    symbols then come to the host for the LZ4 container."""
    import torch

    from ..config import Config
    from ..hierarchy import get_hierarchy
    from ..highlevel import (
        _compress_core_sym,
        as_tensor,
        infer_orthogonal_projection,
    )

    v = as_tensor(data, device)
    if v.dtype not in (torch.float32, torch.float64):
        raise FormatError("reference streams carry float32/float64 data")
    v = v.contiguous()
    dtype = np.dtype(np.float32 if v.dtype == torch.float32 else np.float64)
    shape = tuple(v.shape)
    s_inf = math.isinf(s)
    orthogonal = infer_orthogonal_projection(s)
    hier = get_hierarchy(shape, dtype, None, Config())
    norm = 0.0
    if mode == error_bound_type.REL:
        if s_inf:
            norm = float(v.abs().max())
        else:
            norm = float(torch.sqrt(torch.sum(v.to(torch.float64) ** 2)))
    quant = hier.quantizers(tol, s, norm, mode,
                            orthogonal_projection=orthogonal)
    sym = _compress_core_sym(v, quant, hier, orthogonal, s_inf, False)
    raw = sym.cpu().numpy().astype("<i8").tobytes()
    section = _encode_x_lz4(raw)
    header = serialize_reference_header(
        shape, dtype, tol, s, mode, norm, hier.l_target
    )
    return header + struct.pack("<Q", len(section)) + section


def decompress_reference(blob: bytes, device=None):
    """Decompress a reference stream onto ``device`` (the CUDA card unless
    the caller asks for the CPU).

    Returns (tensor, RefHeader). Raises FormatError for reference payloads
    this build cannot decode, and lossless.host.ZstdNotAvailable for a
    zstd section on a host without the zstandard package."""
    import torch

    from ..config import Config
    from ..hierarchy import get_hierarchy
    from ..highlevel import (
        _TORCH_DTYPE,
        _decompress_core_sym,
        infer_orthogonal_projection,
        resolve_device,
    )

    device = resolve_device(device)
    h = parse_header(blob)
    if h.compressor in (ENC_CPU_HUFFMAN_ZLIB, ENC_CPU_HUFFMAN_ZSTD):
        # older CPU-generation stream (mgard::compress): CPU-Huffman +
        # zstd/zlib payload, shuffled-order quantization, CPU-convention
        # transform — decoded host-side by formats.cpu_stream, the result
        # moved to the device
        from .cpu_stream import decompress_cpu

        return torch.from_numpy(decompress_cpu(blob, h)).to(device), h
    if h.compressor not in (ENC_X_LZ4, ENC_X_HUFFMAN, ENC_X_HUFFMAN_LZ4,
                            ENC_X_HUFFMAN_ZSTD, ENC_X_BLOCK_DELTA,
                            ENC_X_SYMBOL_RANS, ENC_X_ZERORLE_RANS):
        raise FormatError(
            "reference stream uses unknown lossless backend "
            f"{h.compressor}; this build cross-decodes every class the "
            "reference serializes (LZ4, Huffman[-LZ4/-Zstd], BlockDelta, "
            "SymbolRans, ZeroRLE+rANS, CPU_HUFFMAN_*)"
        )
    if h.decomposition not in ("multidim", "singledim"):
        raise FormatError(
            f"reference {h.decomposition} decomposition not supported for "
            "cross-decoding (MultiDim and SingleDim only)"
        )

    cfg = Config()
    # the reference derives l_target from the shape inside Hierarchy (its
    # FunctionDecomposition.L_target field is not populated on compress),
    # so the hierarchy is rebuilt with the default level rule here too
    s_inf = math.isinf(h.s)
    orthogonal = infer_orthogonal_projection(h.s)

    # subdomain shapes: none (whole domain) or the reference MaxDim split
    if h.dd_method == 0:
        sub_shapes = [h.shape]
        sub_slices = [tuple(slice(0, n) for n in h.shape)]
    elif h.dd_method == 1:  # MAX_DIMENSION
        d, sz = h.dd_dim, h.dd_size
        sub_shapes, sub_slices = [], []
        pos = 0
        while pos < h.shape[d]:
            take = min(sz, h.shape[d] - pos)
            shp = list(h.shape)
            shp[d] = take
            sub_shapes.append(tuple(shp))
            sub_slices.append(tuple(
                slice(pos, pos + take) if i == d else slice(0, n)
                for i, n in enumerate(h.shape)
            ))
            pos += take
    else:
        raise FormatError("unsupported reference domain decomposition method")

    if int(np.prod(h.shape, dtype=np.float64)) > (1 << 34) or len(h.shape) > 7:
        # forged-header guard: a legitimate constant field can expand
        # enormously, but 16 Gi elements / >7 dims is beyond anything the
        # reference itself supports — fail before allocating the output
        raise FormatError("implausible reference stream shape "
                          f"{h.shape}")
    out = torch.empty(h.shape, dtype=_TORCH_DTYPE[h.dtype], device=device)
    # the reference quantizes each subdomain at tol/sqrt(S) for finite-s
    # bounds (the L2 budget splits over independent subdomains; same rule
    # as decomposer.calc_local_abs_tol and mgard-x's domain decomposer);
    # for s=inf the pointwise bound needs no split
    S = len(sub_shapes)
    local_tol = h.tol if (s_inf or S == 1) else h.tol / math.sqrt(S)
    p = h.header_bytes
    for shp, sls in zip(sub_shapes, sub_slices):
        (sec_size,) = struct.unpack_from("<Q", blob, p)
        p += 8
        payload = blob[p : p + sec_size]
        p += sec_size
        n_elems = int(np.prod(shp))
        sym = _decode_section(payload, h.compressor,
                              h.huff_dict_size or 8192, expected=n_elems)
        if sym.size != n_elems:
            raise FormatError(
                f"reference payload has {sym.size} symbols, expected {n_elems}"
            )
        sub_coords = (
            [c[sl] for c, sl in zip(h.coords, sls)] if h.coords else None
        )
        hier = get_hierarchy(shp, h.dtype, sub_coords, cfg)
        sym_t = torch.from_numpy(sym.reshape(shp)).to(device)
        if h.decomposition == "singledim":
            # the reference's SingleDim layout and boundary-guarded
            # correction (ops/refactor.recompose_single_x) with the
            # SingleDim quantizer constant (LinearQuantization.hpp:267-270)
            from ..dtypes import decomposition_type as _dt
            from ..ops import quantize as _Q
            from ..ops.refactor import recompose_single_x

            quant = hier.quantizers(
                local_tol, h.s, h.norm, h.ebtype,
                decomposition=_dt.SingleDim,
            )
            dec = _Q.dequantize_symbols(sym_t, hier, quant, s_inf)
            rec = recompose_single_x(dec.to(torch.float64), hier)
            out[sls] = rec.to(out.dtype)
            continue
        quant = hier.quantizers(
            local_tol, h.s, h.norm, h.ebtype,
            orthogonal_projection=orthogonal,
        )
        out[sls] = _decompress_core_sym(sym_t, quant, hier, orthogonal,
                                        s_inf, False)
    return out, h


def sniff(blob: bytes) -> bool:
    """True when the bytes start with the reference MGARD signature (and not
    this framework's MGARDTPU magic)."""
    return blob[:5] == SIGNATURE and blob[5:8] != b"TPU"
