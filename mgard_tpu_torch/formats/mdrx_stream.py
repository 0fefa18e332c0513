"""Reference MDR-X refactored-data directories: reader and writer (port of
``mgard_tpu/formats/mdrx_stream.py``).

The reference's ``mdr-x`` executable persists progressive refactorings as
a directory (reference: src/mgard-x/Executables/mdr-x.cpp
write_mdr/read_mdr):

    header                      mgard-x Metadata (same framing as X streams)
    metadata                    RefactoredMetadata raw struct dump
    component_<sub>_<lvl>_<bp>  one blob per 4-bitplane group

This module reconstructs data from such a directory at a requested
tolerance, reproducing the reference pipeline end to end (defaults of
ComposedRefactor.hpp:25-57: Hierarchical basis, DirectInterleaver,
BPEncoderRegisterBlock with NegaBinary over uint32 batches, and the
HybridLevelCompressor's 4-plane groups):

  greedy plane request    GreedyBasedSizeInterpreter + MaxErrorCollector
                          (GenerateRequest, ComposedReconstructor.hpp:186)
  bitplane decode         RegisterBlock batch layout: bit bp of 32
                          strided values packs MSB-first into one u32;
                          values are NegaBinary fixed-point with
                          exp = frexp(level abs_max) + 2
                          (BPEncoderRegisterBlock.hpp:330-447)
  reposition              LevelLinearizer nested-box <-> level-buffer
                          mapping (LevelLinearizer.hpp:27-215)
  recompose               this framework's transform with the
                          hierarchical basis (pinned ulp-class to the
                          reference MGARD-X serial transform)

The metadata, the plane request, the group decoders, the bitplane decode
and the LevelLinearizer offsets are host NumPy, as in the JAX package: they
walk bytes and small tables. The transform runs on the caller's device
(``device``, the CUDA card unless the caller asks for the CPU), with the
port's ``ops/refactor.py``: ``reconstruct`` returns a tensor there and
``write_mdrx`` decomposes a tensor where it lives. Bitplane groups come in
all three wire forms HybridLevelCompressor emits
(HybridLevelCompressor.hpp:86-115): raw (always, below the 1 MB merged-
group threshold), MGXRLEC run-length containers, and MGXHUFF byte-alphabet
GPU-Huffman containers (groups > 1 MB whose compression ratio clears the 2x
gate). `MDRXArchive` caches the parsed metadata, hierarchy, linearizer
offsets, and decoded groups so progressive multi-tolerance reconstruction
only decodes each group once.
"""

import math
import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from .metadata import FormatError

_GROUP = 4  # HybridLevelCompressor.num_merged_bitplanes
_BATCH = 32  # sizeof(uint32) * 8


# ----------------------------------------------------------------------
# metadata parsing
# ----------------------------------------------------------------------
class MDRXMetadata:
    """One subdomain's MDRMetadata (RuntimeX/DataStructures/MDRMetadata.hpp
    Serialize: u64 num_levels | u64 num_bitplanes | f64 bounds[nl] |
    f64 sq_errors[nl][nb+1] | u64 sizes[nl][nb] | u64 num_elems[nl])."""

    def __init__(self, buf: bytes):
        if len(buf) < 16:
            raise FormatError("truncated MDR-X metadata")
        self.num_levels, self.num_bitplanes = struct.unpack_from("<2Q", buf, 0)
        nl, nb = int(self.num_levels), int(self.num_bitplanes)
        if not (1 <= nl <= 64 and 1 <= nb <= 64):
            raise FormatError("implausible MDR-X metadata")
        if len(buf) < 16 + 8 * (nl + nl * (nb + 1) + nl * nb + nl):
            raise FormatError("truncated MDR-X metadata")
        off = 16
        self.level_error_bounds = np.frombuffer(buf, "<f8", nl, off)
        off += 8 * nl
        self.level_squared_errors = np.frombuffer(
            buf, "<f8", nl * (nb + 1), off
        ).reshape(nl, nb + 1)
        off += 8 * nl * (nb + 1)
        self.level_sizes = np.frombuffer(buf, "<u8", nl * nb, off).reshape(
            nl, nb
        )
        off += 8 * nl * nb
        self.level_num_elems = np.frombuffer(buf, "<u8", nl, off)
        off += 8 * nl
        self.nbytes = off


def read_metadata(path: str) -> List[MDRXMetadata]:
    with open(os.path.join(path, "metadata"), "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise FormatError("truncated MDR-X metadata")
    (num_subdomains,) = struct.unpack_from("<Q", buf, 0)
    if not 1 <= num_subdomains <= 1 << 20:
        raise FormatError("implausible MDR-X subdomain count")
    out = []
    off = 8
    for _ in range(int(num_subdomains)):
        if off + 8 > len(buf):
            raise FormatError("truncated MDR-X metadata")
        (sz,) = struct.unpack_from("<Q", buf, off)
        off += 8
        if off + int(sz) > len(buf):
            raise FormatError("truncated MDR-X metadata")
        md = MDRXMetadata(buf[off : off + int(sz)])
        off += int(sz)
        out.append(md)
    return out


# ----------------------------------------------------------------------
# greedy plane request (GreedyBasedSizeInterpreter + MaxErrorCollector,
# hierarchical-basis estimator: errors add up across levels)
# ----------------------------------------------------------------------
def _collect_level_error(bound: float, nb: int) -> np.ndarray:
    """MaxErrorCollector.collect_level_error (MaxErrorCollector.hpp:15-27):
    entry 0 is the level bound; entry k >= 1 is 2^(exp-1) / 2^(k-1)."""
    out = np.zeros(nb + 1, np.float64)
    out[0] = bound
    _, exp = math.frexp(bound)
    err = math.ldexp(1.0, exp - 1)
    for k in range(1, nb + 1):
        out[k] = err
        err /= 2
    return out


def request_planes(md: MDRXMetadata, tol: float, s: float = math.inf,
                   num_dims: Optional[int] = None) -> List[int]:
    """Per-level bitplane counts — the reference's greedy max-heap on
    error-gain per byte (GreedyBasedSizeInterpreter.hpp:26-105),
    including the zero-size planes inside a 4-plane group (their
    gain/size is +inf: already-paid-for planes come first).

    s = inf: MaxErrorCollector absolute-error tables from the level
    bounds. Finite s (the mdr-x `-s` flag): the hierarchical-basis
    branch of GenerateRequest (ComposedReconstructor.hpp:186-254) runs
    L2ErrorEstimator_HB over the level_squared_errors tables with target
    tol^2 — estimate weight 2 * 2^(D(L-l)), gain weight 2^(D(L-l))
    (SquaredErrorEstimator.hpp:11-39; note the reference ignores the
    numeric s for hierarchical archives: any finite s means L2)."""
    from .cpu_stream import _heap_pop, _heap_push

    nl = int(md.num_levels)
    nb = int(md.num_bitplanes)
    if math.isinf(s):
        errors = [
            _collect_level_error(float(md.level_error_bounds[l]), nb)
            for l in range(nl)
        ]
        w_est = [1.0] * nl
        w_gain = [1.0] * nl
        target = tol
    else:
        if num_dims is None:
            raise ValueError("finite-s requests need num_dims")
        # the reference's shipped refactor ships UNINITIALIZED squared
        # tables (heap garbage) and silently returns a wrong-bound
        # reconstruction for finite-s requests on its own archives.
        # Honest tables are non-increasing in the plane count and bounded
        # by n * bound^2; error clearly instead of reproducing that.
        for l in range(nl):
            tab = md.level_squared_errors[l].astype(np.float64)
            bound = float(md.level_error_bounds[l])
            n_l = float(md.level_num_elems[l])
            cap = n_l * bound * bound * 1.0000001 + 1e-300
            if np.any(np.diff(tab) > 1e-12 * tab[:-1] + 1e-300) or \
                    np.any(np.isnan(tab)) or float(tab[0]) > cap or \
                    (bound > 0 and float(tab[0]) <= 0):
                raise FormatError(
                    "archive carries no usable squared-error tables (the "
                    "reference refactor leaves them uninitialized) — "
                    "finite-s requests need an archive written with "
                    "honest tables (write_mdrx)"
                )
        L = nl - 1
        w_gain = [math.ldexp(1.0, num_dims * (L - l)) for l in range(nl)]
        w_est = [2.0 * w for w in w_gain]
        errors = [md.level_squared_errors[l].astype(np.float64)
                  for l in range(nl)]
        target = tol * tol
    index = [0] * nl
    acc = sum(w_est[l] * float(errors[l][0]) for l in range(nl))

    # emulated std::priority_queue<UnitErrorGain> (max-heap by gain; reuse
    # the exact libstdc++ heap movement from cpu_stream — comparator here
    # is "less by gain" so cnt = -gain under the min-heap-by-cnt helpers)
    heap: list = []
    cnt: list = []
    items: list = []

    def push(gain, level):
        items.append(level)
        cnt.append(-gain)
        _heap_push(heap, cnt, len(items) - 1)

    def pop():
        node = _heap_pop(heap, cnt)
        return -cnt[node], items[node]

    min_error = acc
    for i in range(nl):
        min_error -= w_est[i] * float(errors[i][index[i]])
        min_error += w_est[i] * float(errors[i][-1])
        if index[i] == 0:
            acc -= w_est[i] * float(errors[i][index[i]])
            acc += w_est[i] * float(errors[i][index[i] + 1])
            index[i] += 1
        if index[i] != nb:
            gain = w_gain[i] * (float(errors[i][index[i]])
                                - float(errors[i][index[i] + 1]))
            size = float(md.level_sizes[i][index[i]])
            push(gain / size if size else math.inf, i)
        if min_error < target:
            break

    tolerance_met = acc < target
    while not tolerance_met and heap:
        _, i = pop()
        j = index[i]
        acc -= w_est[i] * float(errors[i][j])
        acc += w_est[i] * float(errors[i][j + 1])
        if acc < target:
            tolerance_met = True
        index[i] += 1
        if index[i] < nb:
            gain = w_gain[i] * (float(errors[i][index[i]])
                                - float(errors[i][index[i] + 1]))
            size = float(md.level_sizes[i][index[i]])
            push(gain / size if size else math.inf, i)
    # round up to whole 4-plane groups (ComposedReconstructor.hpp:288-295).
    # NOTE the reference's `((n - 1) / m + 1) * m` on uint8 n promotes to
    # int, so n=0 becomes (-1)/4 + 1 = 1 group: zero-plane levels still
    # fetch their first group — mirrored faithfully.
    return [_GROUP if k == 0 else -(-k // _GROUP) * _GROUP for k in index]


# ----------------------------------------------------------------------
# bitplane decode (BPEncoderRegisterBlock, NegaBinary, T_bitplane=u32)
# ----------------------------------------------------------------------
def decode_level(planes: np.ndarray, k: int, abs_max: float,
                 n_elems: int) -> np.ndarray:
    """planes: (>=k, 2*NF) u32 rows; returns n_elems f64 values.

    Mirrors DecodeBinary (BPEncoderRegisterBlock.hpp:343-404; the
    reference's NegaBinary constant is false in both ComposedRefactor and
    ComposedReconstructor, so the shipped layout is sign-magnitude):
    value data_idx*NF+batch takes bit (31-data_idx) of plane rows 0..k-1
    at column `batch`, forming the k-bit magnitude prefix; its sign bit
    lives in ROW 0 at column NF+batch; data = ±fp * 2^(exp - k) with
    exp = frexp(level abs_max)."""
    NF = planes.shape[1] // 2
    if k == 0:
        return np.zeros(n_elems, np.float64)
    shifts = np.arange(_BATCH - 1, -1, -1, dtype=np.uint32)  # per data_idx
    fp = np.zeros((_BATCH, NF), np.uint64)
    for bp in range(k):
        bits = ((planes[bp, :NF][None, :] >> shifts[:, None])
                & np.uint32(1)).astype(np.uint64)
        fp |= bits << np.uint64(k - 1 - bp)
    sign = ((planes[0, NF:][None, :] >> shifts[:, None])
            & np.uint32(1)).astype(bool)
    _, exp = math.frexp(abs_max)
    data = fp.astype(np.float64) * math.pow(2.0, -k + exp)
    data = np.where(sign, -data, data)
    # value index = data_idx * NF + batch  ->  row-major of (BATCH, NF)
    return data.ravel()[:n_elems]


# ----------------------------------------------------------------------
# HybridLevelCompressor group payloads (RLE / byte-alphabet Huffman / raw)
# ----------------------------------------------------------------------
def _decode_group_rle(blob: bytes, expected_bytes: int) -> bytes:
    """General RLE container (Lossless/ParallelRLE/RunLengthEncoding.hpp:
    180-210): MGXRLEC | u64 total_run_length | u64 original_length |
    u32 run counts[] | u8 symbols[]; expansion repeats each symbol by its
    count."""
    nruns, orig = struct.unpack_from("<2Q", blob, 8)
    if int(orig) != expected_bytes:
        raise FormatError("MDR-X RLE group length mismatch")
    off = 24
    counts = np.frombuffer(blob, "<u4", int(nruns), off)
    off += 4 * int(nruns)
    symbols = np.frombuffer(blob, np.uint8, int(nruns), off)
    out = np.repeat(symbols, counts.astype(np.int64))
    if out.size != expected_bytes:
        raise FormatError("MDR-X RLE group expansion mismatch")
    return out.tobytes()


def _decode_group_huffman(blob: bytes, expected_bytes: int) -> bytes:
    """Byte-alphabet GPU-Huffman (HybridLevelCompressor's
    Huffman<u8,u8,u64>, dict 256, block 1024): same serialized layout as
    the X streams' Huffman (Huffman.hpp ComputeSerializedLayout) with
    Q=S=u8 keys/outliers, so the container walk is shared with
    ref_stream."""
    from .ref_stream import _parse_huffman_container

    out, p, _ = _parse_huffman_container(blob, np.uint8,
                                         expected=expected_bytes)
    (outlier_count,) = struct.unpack_from("<Q", blob, p)
    if outlier_count:
        # byte alphabet covers [0,256): the separator never fires
        raise FormatError("MDR-X Huffman group has outliers (unexpected "
                          "for a byte alphabet)")
    return out.astype(np.uint8).tobytes()


def _decode_group(blob: bytes, expected_bytes: int) -> bytes:
    """One 4-plane group: raw when exactly the expected size, else the
    RLE/Huffman container HybridLevelCompressor picked
    (HybridLevelCompressor.hpp:86-115)."""
    if len(blob) == expected_bytes:
        return blob
    try:
        if blob[:7] == b"MGXRLEC":
            return _decode_group_rle(blob, expected_bytes)
        if blob[:7] == b"MGXHUFF":
            return _decode_group_huffman(blob, expected_bytes)
    except (struct.error, ValueError) as e:
        # short/corrupt container: np.frombuffer/struct overruns
        raise FormatError(f"corrupt MDR-X bitplane group: {e}") from None
    raise FormatError("unrecognized MDR-X bitplane group payload")


# ----------------------------------------------------------------------
# LevelLinearizer reposition (nested box <- level buffers)
# ----------------------------------------------------------------------
def level_offsets(hier) -> List[np.ndarray]:
    """For each level, the flat indices (into the full nested-box array)
    of that level's entries, ordered by the reference's LevelLinearizer
    level_offset (LevelLinearizer.hpp:27-215)."""
    shape = hier.shape
    D = len(shape)
    ranges = np.array(
        [[0] * D] + [list(hier.level_shape[l]) for l in
                     range(hier.l_target + 1)],
        dtype=np.int64,
    )  # level_ranges[l+1] = level_shape[l]; row 0 = zeros
    # per-dim level marks: smallest level whose range covers the index
    marks = []
    for d in range(D):
        m = np.empty(shape[d], np.int64)
        for i in range(shape[d]):
            for l in range(hier.l_target + 1):
                if i < ranges[l + 1][d]:
                    m[i] = l
                    break
        marks.append(m)

    idx = np.indices(shape).reshape(D, -1)
    level = np.maximum.reduce([marks[d][idx[d]] for d in range(D)])

    out = []
    for l in range(hier.l_target + 1):
        sel = np.nonzero(level == l)[0]
        pos = idx[:, sel]  # (D, n_l)
        coarse = ranges[l]  # level_ranges(level, d)
        fine = ranges[l + 1]  # level_ranges(level+1, d)
        diff = fine - coarse
        region_bit = np.stack(
            [(marks[d][pos[d]] == l).astype(np.int64) for d in range(D)]
        )  # (D, n_l); bit d set when this dim is at the new part
        curr_region = np.zeros(sel.size, np.int64)
        for d in range(D):
            curr_region += region_bit[d] << d

        # thread idx within the region, then the global (fine-grid) index
        g = np.empty_like(pos)
        for d in range(D):
            bit = region_bit[d].astype(bool)
            t = np.where(bit, pos[d] - coarse[d], pos[d])
            if l == 0:
                g[d] = t
            else:
                gd = t * 2 + bit
                even_last = (fine[d] % 2 == 0) & (t == fine[d] // 2)
                g[d] = np.where(even_last, fine[d] - 1, gd)

        thread_off = np.zeros(sel.size, np.int64)
        stride = 1
        for d in range(D - 1, -1, -1):
            thread_off += g[d] * stride
            stride *= int(fine[d])

        coarse_off = np.zeros(sel.size, np.int64)
        stride = 1
        for d in range(D - 1, -1, -1):
            odd_interior = (g[d] % 2 != 0) & (g[d] != fine[d] - 1)
            coarse_off = np.where(odd_interior, 0, coarse_off)
            coarse_off = coarse_off + np.where(
                g[d] > 0, ((g[d] - 1) // 2 + 1) * stride, 0
            )
            stride *= int(fine[d]) // 2 + 1
        if l == 0:
            coarse_off = np.zeros(sel.size, np.int64)
        level_off = thread_off - coarse_off

        order = np.empty(sel.size, np.int64)
        order[level_off] = sel
        out.append(order)
    return out


# ----------------------------------------------------------------------
# end-to-end read
# ----------------------------------------------------------------------
class MDRXArchive:
    """A reference MDR-X directory opened for progressive reconstruction.

    Parses and validates the header/metadata once, builds the hierarchy
    and LevelLinearizer offsets lazily, and caches decoded bitplane
    groups — so reconstructing the same archive at several tolerances
    (the CLI's ``-e t1 t2 ...``) re-decodes nothing."""

    def __init__(self, path: str, device=None):
        from ..config import Config
        from ..hierarchy import get_hierarchy
        from ..highlevel import resolve_device
        from .ref_stream import parse_header

        self.device = resolve_device(device)
        self.path = path
        with open(os.path.join(path, "header"), "rb") as f:
            self.header = parse_header(f.read())
        if self.header.decomposition != "multidim":
            # the archive's bitplanes hold a different transform's
            # coefficients; recomposing them MultiDim would be silent junk
            raise FormatError(
                f"reference {self.header.decomposition} decomposition not "
                "supported for MDR-X cross-reading (MultiDim only)"
            )
        mds = read_metadata(path)
        if len(mds) != 1:
            raise FormatError(
                "MDR-X cross-reading supports whole-domain archives (one "
                f"subdomain; this one has {len(mds)})"
            )
        self.md = mds[0]
        cfg = Config()
        cfg.normalize_coordinates = False
        self.hier = get_hierarchy(self.header.shape, self.header.dtype,
                                  self.header.coords, cfg)
        if self.hier.l_target + 1 != int(self.md.num_levels):
            raise FormatError("MDR-X level count mismatch with header shape")
        self._offsets: Optional[List[np.ndarray]] = None
        self._groups: dict = {}  # (level, first_bp) -> (GROUP, row_len) u32

    def request(self, tol: float, s: float = math.inf) -> List[int]:
        return request_planes(self.md, tol, s=s,
                              num_dims=len(self.header.shape))

    def _group_rows(self, l: int, bp: int, row_len: int) -> np.ndarray:
        key = (l, bp)
        if key in self._groups:
            return self._groups[key]
        size = int(self.md.level_sizes[l][bp])
        if size == 0:
            # the reference writer only creates component files for
            # non-zero sizes (mdr-x.cpp write_mdr); an absent file here is
            # a legitimate all-zero group, not a partial archive
            rows = np.zeros((_GROUP, row_len), np.uint32)
        else:
            fname = os.path.join(self.path, f"component_0_{l}_{bp}")
            try:
                with open(fname, "rb") as f:
                    blob = f.read()
            except FileNotFoundError:
                raise FormatError(
                    f"MDR-X archive is missing component_0_{l}_{bp} "
                    f"(partial archive? tolerance needs more planes than "
                    f"were retrieved)"
                ) from None
            if len(blob) != size:
                raise FormatError(f"MDR-X component size mismatch at "
                                  f"level {l} plane {bp}")
            raw = _decode_group(blob, row_len * 4 * _GROUP)
            rows = np.frombuffer(raw, "<u4").reshape(_GROUP, row_len)
        self._groups[key] = rows
        return rows

    def reconstruct(self, tol: float,
                    planes: Optional[Sequence[int]] = None,
                    s: float = math.inf):
        """Reconstruct at tolerance `tol` (s = inf absolute-error
        requests, the mdr-x default; finite s = the L2 request the
        reference runs for hierarchical archives). `planes` overrides
        the greedy request with explicit per-level bitplane counts.
        Returns a tensor on the archive's device."""
        md, hier = self.md, self.hier
        nb = int(md.num_bitplanes)
        counts = list(planes) if planes is not None else self.request(tol, s)

        dec = np.zeros(hier.shape, np.float64)
        if self._offsets is None:
            self._offsets = level_offsets(hier)
        for l in range(int(md.num_levels)):
            k = min(int(counts[l]), nb)
            if k == 0:
                continue
            n_elems = int(md.level_num_elems[l])
            NF = (n_elems + _BATCH - 1) // _BATCH
            row_len = 2 * NF  # bitplane_length: data + sign-plane words
            ngroups = (k + _GROUP - 1) // _GROUP
            rows = np.concatenate(
                [self._group_rows(l, g * _GROUP, row_len)
                 for g in range(ngroups)]
            )
            vals = decode_level(rows, k, float(md.level_error_bounds[l]),
                                n_elems)
            dec.ravel()[self._offsets[l]] = vals

        import torch

        from ..ops.refactor import recompose

        dec_t = torch.from_numpy(dec.astype(self.header.dtype)).to(
            self.device)
        return recompose(dec_t, hier, orthogonal=False)


def reconstruct_mdrx(path: str, tol: float, s: float = math.inf,
                     planes: Optional[Sequence[int]] = None, device=None):
    """One-shot reconstruction of a reference-written MDR-X directory at
    tolerance `tol` onto `device` (use MDRXArchive directly for
    multi-tolerance reads)."""
    return MDRXArchive(path, device).reconstruct(tol, planes=planes, s=s)


# ----------------------------------------------------------------------
# end-to-end write (the bidirectional half: reference reads OUR archive)
# ----------------------------------------------------------------------
def write_mdrx(path: str, data, num_bitplanes: int = 32,
               device=None) -> None:
    """Write a reference-format mdr-x DIRECTORY archive of `data` that the
    reference build itself progressively reconstructs (pinned by
    tests/golden/mdrxw_*; reference read path: mdr-x.cpp read_mdr ->
    MDReconstruct).

    Exact mirror of the read side: f32 MultiDim hierarchical decompose,
    LevelLinearizer ordering, RegisterBlock sign-magnitude batches
    (BPEncoderRegisterBlock.hpp:111-183: shifted = coef * 2^(B - exp) in
    f32, fp = trunc(|shifted|), plane bp holds bit B-1-bp, signs in row
    0's upper half), MaxError bounds + the squared-error tables of
    error_collect_binary (:44-75), and the MDRMetadata struct dump.
    Groups are written raw — what the reference itself emits below its
    1 MB merged-group gate (HybridLevelCompressor.hpp:86-115).

    A tensor is decomposed where it lives, anything else on ``device``
    (the CUDA card unless the caller asks for the CPU); the coefficients
    then come to the host, where the planes are cut."""
    import torch

    from ..config import Config
    from ..hierarchy import get_hierarchy
    from ..highlevel import as_tensor
    from ..ops.refactor import decompose
    from .ref_stream import serialize_reference_header

    v = as_tensor(data, device)
    if v.dtype != torch.float32:
        raise FormatError("MDR-X archive writing supports float32 data")
    v = v.contiguous()
    B = int(num_bitplanes)
    if B != 32:
        raise FormatError("MDR-X archive writing supports 32 bitplanes "
                          "(T_bitplane=u32, the ComposedRefactor default)")
    cfg = Config()
    cfg.normalize_coordinates = False
    shape = tuple(v.shape)
    hier = get_hierarchy(shape, np.float32, None, cfg)
    nl = hier.l_target + 1

    dec = decompose(v, hier, orthogonal=False).cpu().numpy()
    offsets = level_offsets(hier)
    os.makedirs(path, exist_ok=True)

    bounds = np.zeros(nl, np.float64)
    sq_errors = np.zeros((nl, B + 1), np.float64)
    sizes = np.zeros((nl, B), np.uint64)
    num_elems = np.zeros(nl, np.uint64)
    shifts = np.arange(_BATCH - 1, -1, -1, dtype=np.uint32)  # per data_idx

    for l in range(nl):
        coefs = dec.ravel()[offsets[l]].astype(np.float32)
        n = coefs.size
        num_elems[l] = n
        bound = float(np.max(np.abs(coefs))) if n else 0.0
        bounds[l] = bound
        _, exp = math.frexp(bound)

        NF = (n + _BATCH - 1) // _BATCH
        pad = np.zeros(NF * _BATCH, np.float32)
        # power-of-two scale, multiplied in f64 then rounded to f32 like
        # the reference's pow path (the factor itself can exceed f32
        # range for tiny level bounds; the product never does)
        scale = math.ldexp(1.0, B - exp)
        if not math.isfinite(scale):
            raise FormatError(
                f"level {l} bound {bound:g} is too small to bitplane-"
                f"encode (scale 2^{B - exp} overflows)"
            )
        pad[:n] = (coefs.astype(np.float64) * scale).astype(np.float32)
        fp = np.abs(pad).astype(np.uint32).reshape(_BATCH, NF)
        sign = np.signbit(pad).reshape(_BATCH, NF)

        rows = np.zeros((B, 2 * NF), np.uint32)
        for bp in range(B):
            bits = (fp >> np.uint32(B - 1 - bp)) & np.uint32(1)
            rows[bp, :NF] = ((bits << shifts[:, None]).sum(
                axis=0, dtype=np.uint64)).astype(np.uint32)
        rows[0, NF:] = (sign.astype(np.uint32) << shifts[:, None]).sum(
            axis=0, dtype=np.uint64).astype(np.uint32)

        # error tables (f64, like T_error=double): entry B-bp = sum over
        # values of ((fp & ((1<<bp)-1)) + frac)^2, entry 0 = sum shifted^2,
        # all scaled by 2^(2(exp-B))
        absf = np.abs(pad[:n]).astype(np.float64)
        fpn = np.abs(pad[:n]).astype(np.uint32)
        frac = absf - fpn
        scale = math.ldexp(1.0, 2 * (exp - B))
        sq_errors[l, 0] = float(np.sum(absf * absf)) * scale
        for bp in range(B):
            resid = (fpn & np.uint32((1 << bp) - 1)).astype(np.float64) + frac
            sq_errors[l, B - bp] = float(np.sum(resid * resid)) * scale

        for g in range(0, B, _GROUP):
            blob = rows[g : g + _GROUP].astype("<u4").tobytes()
            sizes[l, g] = len(blob)
            with open(os.path.join(path, f"component_0_{l}_{g}"), "wb") as f:
                f.write(blob)

    body = struct.pack("<2Q", nl, B)
    body += bounds.astype("<f8").tobytes()
    body += sq_errors.astype("<f8").tobytes()
    body += sizes.astype("<u8").tobytes()
    body += num_elems.astype("<u8").tobytes()
    with open(os.path.join(path, "metadata"), "wb") as f:
        f.write(struct.pack("<2Q", 1, len(body)) + body)
    from ..dtypes import error_bound_type

    with open(os.path.join(path, "header"), "wb") as f:
        f.write(serialize_reference_header(
            shape, np.float32, 0.0, math.inf,
            error_bound_type.ABS, 0.0, hier.l_target))
