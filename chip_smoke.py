"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits nonzero before the result):
  1. device: require CUDA; print the card's name and power limit;
  2. build the CUDA kernels K1-K13 and the probes P1-P3 from
     mgard_tpu_torch/csrc with nvcc (one process per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     512^3 geometries of the main path and of Hybrid+BFX (K7/K8 also at
     8192^2, and all at a few small geometries) and, for K9, at the 384^3
     MDR field's finest-level stream, with times from CUDA events (K9 also
     per level of one MDRefactor, replayed from a CUDA graph); K7/K8 at
     512^3 timed at nl 1, 2 and 3 (with their ptxas lines, PyTorch's
     casts of the same bytes and the copies around K7 on the Hybrid+BFX
     compress), at 8192^2 with its
     bound, at eight small shapes (a partial 2D group, a ragged last tile,
     z walks split into segments), refusing views one element off 16-byte
     alignment while compress of such a view holds its bound; K1/K4
     on ten small shapes (Z = 1024, C = 1, 2, 16, X and Y not powers of
     two, nl 1-3) and a field with a width-32 chunk, and at 512^3 timed at
     nl 1, 2 and 3, beside PyTorch casts that move the same bytes; K10/K11
     (the fused transform+pack pair) at 512^3 with the main path's K (with
     their ptxas lines, the clusters the card holds at each Z the gate
     admits, and PyTorch's casts of the field as yardsticks), at
     (8,128,128), (16,256,256), (8,128,768) and (8,128,1024) with K=1/E=15
     and K=8/E=8, on a field with one value over the u16 budget, and K11
     on residual words made random above every chunk's width;
     K2/K3 on the cf and remainder streams of the main path (timed per
     stream beside a copy of the rows that moves the same bytes, with
     their ptxas lines), on the edge cases of bfp.BAND_CASES, and on wide
     rows at sb=256; rows one element off 16-byte alignment are refused;
     K12/K13 (BFP's wire compaction) on the cf stream: the blob and band
     rows equal to those of the same tensors on the CPU (the plain
     versions), each kernel to its plain version, timed beside a copy of
     the wire words, with their ptxas lines;
     K5/K6 (the BFX codec) on the 512^3 Hybrid+BFX stream, on 8192
     symbols at sb=256/align=1 (a small remainder), on an MDR plane of the
     384^3 finest level and on a stream of 32-bit blocks at sb=4096 (each
     timed, beside PyTorch's int32 <-> uint8 casts of the 512^3 stream as
     yardsticks, with their ptxas lines), on three small streams, and
     refusing views one element off 16-byte alignment; K5 also timed over
     the 99 bfx planes of one 384^3 MDRefactor; K14 (the MultiDim level
     kernel of a 3D field) against its plain version (the dense
     operators) on small shapes in both types, bases and kinds of
     coordinates, on the cells' float32 inputs (the main path's remainder
     as one compress and decompress hand it over, MDR's 384^3 field in
     MDR's basis), and at 500^3 float64 in the L2 basis, timed whole and
     at its finest level beside the level steps' byte floor, the plain
     version and a clone of the field, with its ptxas lines;
  4. the main path: one timed compress + decompress of a 512^3 float32
     field at tol=1e-3 (s=inf, ABS, default Config) through the public API
     (nyx512.bfp.roundtrip measures its speed), with the launch counters
     reset just before and read just after (K1-K4, K12, K13): each BFP
     blob (cf stream and remainder) compacted and expanded on the card,
     none on the host (the bfp.wire.* counters); the copies staged through
     the pinned ring on the compress and on the decompress
     (copy.staged.calls/bytes/chunks, none copy.direct.calls) and the
     ring's pinned bytes;
  5. Hybrid+BFX (Config.lossless=BFX, flag 0): the same field and
     tolerance, the same counters (K5-K8, the staged copies);
  6. the main path at 128^3: flag 1 with a BFX remainder (K1-K6);
  7. 256^3 streams across devices: written on the card and decoded on the
     CPU (plain path) and on the card, for the flag-1 path, the flag-0
     fallback, Hybrid+BFX and the fused flag-2 path; and a Hybrid+BFX and a
     flag-2 stream written on the CPU decoded on the card;
  8. MDR, the progressive refactor/retrieval path, on the 384^3 bench field
     (float32, default Config: B=32, zlib planes, direct interleaver):
     one timed MDRefactor (mdr384.zlib.progressive measures its speed),
     then MDRequest + MDReconstruct at tol 1e-2, 1e-3 and 1e-4 (the bytes
     fetched must rise strictly with the tightness), with the launch
     counters reset just before and read just after (K9, four levels);
  9. the same field with mdr_level_compressor="bfx" (K5 on refactor, K6 on
     reconstruct; mdr384.bfx.progressive measures its speed), with the
     plane bytes stored and retrieved at tol 1e-2, 1e-3 and 1e-4;
 10. MDR across devices at 128^3: a stream written on the card reconstructs
     on the CPU and one written on the CPU on the card;
 11. MDReconstructQoI (V_TOT) over three 128^3 variables on the card;
 12. the fused transform+pack path (Config.hybrid_fused_pack, flag 2) on
     the 512^3 field at tol=1e-3: the first stream of the shape rides flag 1
     and primes the sticky K, the next ones are flag 2 (file minor 1); the
     launch counters are reset just before one flag-2 compress + decompress
     and read just after (K10 and K11 launched, K1 and K4 not, K2 and K3
     once each, for the remainder section); then a tighter tolerance on the
     primed shape takes the stale-K fallback (flag 1, K refreshed) and the
     stream after it fuses again;
 13. the layout probes P1-P3 (mgard_tpu_torch/probes.py): every variant at
     the probe's own shape and at one production shape (P2 also at a
     ragged tail shape), called, compared (max_abs_err 0) and timed here
     against its plain version and, where there is one, the PyTorch call
     that computes the same (P2's direct variant against it in alternating
     rounds, medians of single launches; P1's four variants as CUDA-graph
     replays of the wrapper, one launch a call, beside a clone of the
     content rows' bytes as a yardstick); then one counted run of the
     probes' own entry point (probes.run_all), which must launch P1's run
     and bulk variants;
 14. the generic compress surface at full size, each run checking its bound
     on the card and, for every call, the exact K2/K3 counts (one
     pre-sorted bfp.encode_core section each way, at most one
     exception-bucket re-run on a first compress): a 1D 2^20 float64
     sinusoid at s=0, tol=1e-3 (MultiDim, the split/lerp/merge path,
     orthogonal basis; the achieved error measured by ``norm``; K2/K3 in
     their pre-sorted mode);
 15. a 5D (12,8,96,33,33) float32 field at s=inf, tol=1e-3 (falls back to
     MultiDim), and at s=0 under a REL bound;
 16. a 257^3 float32 field on a stretched grid (``coords=``),
     decomposition=MultiDim, at s=inf and s=0; and SingleDim at 129^3;
 17. a 256^3 float64 field at tol=1e-3: demoted (float32 payload, float64
     header, K1-K4 launched, the bound held on the double data); and the
     field scaled by 0.01 at tol=1e-9: native float64, not demoted;
 18. compress_roi at 128^3 with an explicit mask and with roi_mask=None:
     error <= tol/16 inside the mask, <= tol outside, and the launches of
     each call (K2/K3, K12/K13, and K14 a level);
 19. one small stream of each new kind written on the card and decoded on
     the CPU, and the reverse;
 20. streams of the reference libraries (formats/ref_stream.py,
     cpu_stream.py, mdrx_stream.py) on the card: the native host codecs
     (native/lz4.cpp, huffdec.cpp) built with g++ into build/native/; each
     reference-format golden of tests/golden decoded with
     decompress(..., device="cuda") to a CUDA tensor and held as the tests
     hold it (the reference decoder's output, or the input and the bound);
     the Hybrid one refused (Failure); those with real zstd frames must
     give BackendNotAvailableFailure on a host without zstandard, and are
     printed by name; a 512^3 float32 X_LZ4 stream of the bench field
     (tol 1e-3, s=inf, ABS) written with compress_reference on the card
     and decoded there within the bound (ms each way, medians of 3, and
     bytes); an MDR-X archive of a 256^3 field written with write_mdrx and
     read back through MDRXArchive on the card at tol 1e-2 / 1e-3 / 1e-4,
     each bound held, the bytes fetched printed;
 21. XGC's f0 shape, (8,39,16395,39) float64, the xgc4d_f64 field of
     bench_torch/configs (xgc4d.l2.roundtrip measures its speed): one
     compress at REL 1e-3, s=0 (the MultiDim transform on the slice route:
     an axis over 4096) and one decompress on the card, the L2 bound held
     (bench_torch/reference_l2.py's norm), the slice route's counters of
     each call (transform.slice_levels, scan_passes, solve_elems), the
     transform's ms a call each way (CUDA events) and the peak device
     memory.
The second-to-last line is a JSON summary of the kernels: launches from the
path each kernel belongs to (K1-K4 and K14 phase 4, K5-K8 phase 5, K9
phase 8, K10/K11 phase 12, the probe variants phase 13's counted run),
times from phase 3 (probes: phase 13; K9 also per level of one
MDRefactor), and each kernel's bound: the larger of the bytes it
must move over the card's 3.35 TB/s and its operations over 67 TOP/s (the
H100 SXM data sheet's float32 rate; integer lane operations counted at the
same rate). The last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TOL = 1e-3
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Lane operations per element, read off each kernel's code (an estimate;
# every one of these kernels is bound by bytes by a wide margin).
OPS_PER_ELEM = {"hybrid_fwd_v2": 40, "hybrid_inv_v2": 40, "hybrid_fwd": 35,
                "hybrid_inv": 35, "hybrid_pack_v3": 40, "hybrid_unpack_v3": 40}
N_MDR = 384
N_MDR_SMALL = 128
N_MAIN = 512
N_CROSS = 256
REPO_KERNELS = {
    "hybrid_fwd_v2": ("mgard_tpu_torch/csrc/hybrid_v2.cu",
                      "mgard_tpu/ops/hybrid.py:576"),
    "bfp_encode": ("mgard_tpu_torch/csrc/bfp.cu",
                   "mgard_tpu/lossless/bfp.py:278"),
    "bfp_decode": ("mgard_tpu_torch/csrc/bfp.cu",
                   "mgard_tpu/lossless/bfp.py:329"),
    # K12/K13 replace no TPU kernel: the JAX package's NumPy band
    # compaction on the host; their plain versions serve CPU tensors
    "bfp_compact": ("mgard_tpu_torch/csrc/bfp.cu",
                    "mgard_tpu_torch/lossless/bfp.py::compact_wire_plain"),
    "bfp_expand": ("mgard_tpu_torch/csrc/bfp.cu",
                   "mgard_tpu_torch/lossless/bfp.py::expand_wire_plain"),
    "hybrid_inv_v2": ("mgard_tpu_torch/csrc/hybrid_v2.cu",
                      "mgard_tpu/ops/hybrid.py:682"),
    "bfx_encode": ("mgard_tpu_torch/csrc/bfx.cu",
                   "mgard_tpu/lossless/bfx.py:235"),
    "bfx_decode": ("mgard_tpu_torch/csrc/bfx.cu",
                   "mgard_tpu/lossless/bfx.py:264"),
    "hybrid_fwd": ("mgard_tpu_torch/csrc/hybrid.cu",
                   "mgard_tpu/ops/hybrid.py:333"),
    "hybrid_inv": ("mgard_tpu_torch/csrc/hybrid.cu",
                   "mgard_tpu/ops/hybrid.py:377"),
    "bitplane_encode": ("mgard_tpu_torch/csrc/bitplane.cu",
                        "mgard_tpu/mdr/bitplane.py:232"),
    "hybrid_pack_v3": ("mgard_tpu_torch/csrc/hybrid_v3.cu",
                       "mgard_tpu/ops/hybrid.py:939"),
    "hybrid_unpack_v3": ("mgard_tpu_torch/csrc/hybrid_v3.cu",
                         "mgard_tpu/ops/hybrid.py:1072"),
    # K14 replaces no TPU kernel: the dense operators (XLA matmuls in the
    # JAX package, torch.tensordot in the port)
    "multidim_decompose": ("mgard_tpu_torch/csrc/multidim.cu",
                           "mgard_tpu_torch/ops/refactor.py::"
                           "decompose_level_fast (dense operators)"),
    "multidim_recompose": ("mgard_tpu_torch/csrc/multidim.cu",
                           "mgard_tpu_torch/ops/refactor.py::"
                           "recompose_level_fast (dense operators)"),
}
# K10/K11 ms at 512^3 in their three-kernel design (a shared-tile walk, a
# u16 scratch payload, warp-ballot packing), measured just before the
# cluster design replaced it (PERF.md), one H100 80GB HBM3 at 700 W
K10_K11_BEFORE = ((3.2204, 3.2288), (3.5800, 3.6050))
# K7/K8 ms at 512^3, nl = 3, and at 8192^2 in their shared-tile design (a
# 256-thread block over a 4096-element tile, a barrier after every pass),
# measured just before the register-line design replaced it (PERF.md), one
# H100 80GB HBM3 at 700 W
K7_K8_BEFORE = ((2.2413, 2.2438), (2.8794, 2.8891))
K7_K8_BEFORE_8192 = ((1.0034, 1.0112), (1.3290, 1.3391))
# K5/K6 ms on the 512^3 Hybrid+BFX stream in their first design (four and
# three launches: widths, a scan per superblock, a scan of the offsets, a
# warp per block packing by ballots), measured just before the cluster
# design replaced it (PERF.md), one H100 80GB HBM3 at 700 W
K5_K6_BEFORE = ((1.4121, 1.4160), (1.0677, 1.0716))
# the MDR plane of phase 3's K5/K6 check: a row of the 384^3 finest level's
# K9 planes (1,546,240 words, twelve superblocks of 4096 blocks)
MDR_PLANE = 24
# K2/K3 ms at 512^3, cf and remainder stream together, on the same card
# in their warp-ballot design (PERF.md's kernel table)
K2_K3_BEFORE = (1.3725, 1.3140)
MAIN_PATH = ("hybrid_fwd_v2", "bfp_encode", "bfp_compact", "bfp_expand",
             "bfp_decode", "hybrid_inv_v2", "multidim_decompose",
             "multidim_recompose")
BFX_PATH = ("hybrid_fwd", "bfx_encode", "bfx_decode", "hybrid_inv")
SMALL_MAIN_PATH = MAIN_PATH + ("bfx_encode", "bfx_decode")
FUSED_PATH = ("hybrid_pack_v3", "hybrid_unpack_v3")
# phase 12's second tolerance: chunks ~3 bits wider, still inside 16 bits
# (at 1e-5 the 512^3 field's codes leave the u16 budget: flag 0)
TOL_TIGHT = 1e-4
PROBE_SOURCE = "mgard_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"dynwin": "scripts/probe_dynwin.py:61",
                  "relayout": "scripts/probe_strided_dma.py:40",
                  "relayout_rev": "scripts/probe_strided_dma.py:78",
                  "u16": "scripts/probe_u16.py:42"}
# Lane operations per 32-bit word moved (P1, P2) or per 32-symbol block
# (P3), read off the kernels: an estimate, every variant is bound by bytes.
PROBE_OPS = {"or": 6, "owner": 2, "run": 1, "bulk": 1, "direct": 2,
             "cpasync": 3, "row32": 5,
             "row33": 5, "ballot": 32 * 58, "butterfly": 300}
# rounds of 20 launches each in which P2's direct variant and its PyTorch
# call alternate (phase 13)
DIRECT_ROUNDS = 5


def phase(msg):
    print(msg, flush=True)


def ptxas_lines(log, names):
    """ptxas -v lines of the named kernels: per kernel, its registers,
    barriers, shared memory, stack and spills."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in names if k in line), None)
            if name and "ItE" in line:  # the template's row type
                name += "<u16>"
            elif name and "IjE" in line:
                name += "<u32>"
            elif name and "ILb" in line:  # K7/K8: <2D, nl>
                d2, nl = line.split("ILb", 1)[1][:5:4]
                name += f"<{'2D' if d2 == '1' else '3D'} nl={nl}>"
        elif name and ("stack frame" in line or "registers" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def bench_field(n, device, seed=42):
    """The smooth multi-mode field of bench.py (same default_rng(42) draws),
    built with torch on the device."""
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    X, Y, Z = x[:, None, None], x[None, :, None], x[None, None, :]
    rng = np.random.default_rng(seed)
    v = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for _ in range(6):
        kx, ky, kz = (int(k) for k in rng.integers(1, 9, 3))
        amp = float(rng.uniform(0.3, 1.0))
        ph = float(rng.uniform(0, 2 * np.pi))
        v += amp * torch.sin(2 * np.pi * (kx * X + ky * Y + kz * Z) + ph)
    return v


STAGING = ("copy.staged.calls", "copy.staged.bytes", "copy.staged.chunks",
           "copy.direct.calls")


def staging_line(c0, c1, c2, trace):
    """The staged copies of one compress (counters c0 -> c1) and one
    decompress (c1 -> c2), and the ring's pinned bytes; raises unless both
    staged their bulk copies and none found the ring busy."""
    w, r = ([b.get(k, 0) - a.get(k, 0) for k in STAGING]
            for a, b in ((c0, c1), (c1, c2)))
    if not (w[0] and r[0]) or w[3] or r[3]:
        raise AssertionError(f"staged copies {STAGING}: compress {w}, "
                             f"decompress {r}")
    return (f"staged copies (calls, bytes, chunks, direct): compress {w}, "
            f"decompress {r}; pinned ring {trace.pinned_bytes()} B")


def time_ms(fn, reps=5):
    """Mean device time of fn over reps launches (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=20):
    """Device ms per call of fn: reps calls captured in one CUDA graph and
    replayed between CUDA events, so that no host time (a wrapper's checks
    and allocations) falls between the launches of a small kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / reps


def launch_ms(fn, reps=20):
    """Device time of each of reps launches of fn (CUDA events around each,
    one warm-up)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def tensor_bytes(*objs):
    """Bytes of every tensor in objs (nested tuples and lists too)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(moved, ops):
    """Least time (ms) the card could take for the work, and what sets it:
    the bytes moved at HBM_BYTES_PER_S or the operations at OPS_PER_S."""
    tb, to = moved / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs(x, y):
    if x.dtype in (torch.int16, torch.int32):
        x, y = x.to(torch.int64), y.to(torch.int64)
    return float((x - y).abs().max()) if x.numel() else 0.0


def section_head(blob):
    """(front-end flag, backend id, BFX2 (sb, align) or None) of the first
    subdomain's lossless section (the remainder section of a flag-1
    stream)."""
    from mgard_tpu_torch import highlevel as HL
    from mgard_tpu_torch.formats.metadata import Metadata

    pos = Metadata.deserialize(blob)[1] + 8 + len(HL._EMPTY_OUTLIERS)
    flag = blob[pos]
    pos += 1
    if flag in (1, 2):
        pos += 8 + struct.unpack_from("<Q", blob, pos)[0]
    backend = blob[pos]
    head = struct.unpack_from("<4sQQII", blob, pos + 9)
    return flag, backend, head[3:] if head[0] == b"BFX2" else None


def file_minor(blob):
    """Minor file version stamped in a stream's header."""
    from mgard_tpu_torch.formats.metadata import MAGIC

    return blob[len(MAGIC) + 8 + 4]


def mixed_symbols(n, gen, wide=False):
    """int32 symbols of mixed widths (zero, narrow, 20-bit), or spanning the
    whole int32 range."""
    if wide:
        return gen.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return (gen.standard_normal(n) * gen.choice([0, 3, 300, 3e5], n)).astype(
        np.int32)


class Recorder:
    """Swap a module function for a recording wrapper (captures the exact
    inputs the pipeline hands a kernel wrapper)."""

    def __init__(self, mod, name, replacement=None):
        self.mod, self.name = mod, name
        self.real = getattr(mod, name)
        self.replacement = replacement
        self.calls = []

    def __enter__(self):
        target = self.replacement or self.real

        def rec(*args, **kw):
            self.calls.append((args, kw))
            return target(*args, **kw)

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def timed(fn):
    """fn() on the host clock, ending in a device sync: (result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def header(blob):
    from mgard_tpu_torch.formats.metadata import Metadata

    return Metadata.deserialize(blob)[0]


def probe_phase(dev, kernels, rows, path_launches):
    """Phase 13: P1-P3. Every variant's wrapper is called here on the
    probes' inputs (probes.cases), held here against the plain version
    (max_abs_err measured, must be 0) and timed here with CUDA events, as
    is the one PyTorch call that computes the same function where there is
    one; these launches compare and are not counted. Then one counted run
    of the probes' entry point."""
    from mgard_tpu_torch import probes as PR

    for probe, shape, variants, kern, plain, library, moved in PR.cases(dev):
        want = plain()
        plain_ms = time_ms(plain, 2)
        lib_ms = None
        if probe == "dynwin":
            # yardstick, not the same function: a clone of a contiguous
            # buffer of the content rows' bytes, as graph replays
            total = want.shape[0] - shape[1] * shape[2]
            buf = want[:total].clone()
            phase(f"phase 13 dynwin {shape}: clone of the {total} content "
                  f"rows ({buf.numel() * 4} bytes, a yardstick, not the "
                  f"same function) {graph_ms(buf.clone):.4f} ms")
            del buf
        if library is not None:
            if not torch.equal(library(), want):
                raise AssertionError(f"probe {probe} at {shape}: "
                                     f"{PR.LIBRARY_CALL[probe]} differs from "
                                     "the plain version")
            lib_ms = time_ms(library)
        lib = ("" if lib_ms is None
               else f", {PR.LIBRARY_CALL[probe]} {lib_ms:.4f} ms")
        name = probe.split("_")[0]
        for v in variants:
            got = kern(v)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"probe {probe} at {shape}, variant {v}: "
                                     f"{got.dtype} {tuple(got.shape)}, plain "
                                     f"{want.dtype} {tuple(want.shape)}")
            err = max_abs(got, want)
            if err != 0:
                raise AssertionError(f"probe {probe} at {shape}, variant {v}: "
                                     f"differs from the plain version by "
                                     f"{err}")
            del got
            if probe == "dynwin":
                # P1 is one launch a call with no host-to-device copy, so
                # the wrapper is captured and replayed: device time alone
                ms = graph_ms(lambda: kern(v))
            else:
                ms = time_ms(lambda: kern(v))
            v_lib_ms, v_lib = lib_ms, lib
            if v == "direct" and library is not None:
                # the kernel against the PyTorch call, alternating, each
                # launch timed: medians over DIRECT_ROUNDS x 20 launches
                kd, ld = [], []
                for _ in range(DIRECT_ROUNDS):
                    kd += launch_ms(lambda: kern(v), 20)
                    ld += launch_ms(library, 20)
                ms, v_lib_ms = statistics.median(kd), statistics.median(ld)
                v_lib = f", {PR.LIBRARY_CALL[probe]} {v_lib_ms:.4f} ms"
                phase(f"phase 13 {probe} {shape} direct against "
                      f"{PR.LIBRARY_CALL[probe]}, medians of {len(kd)} "
                      f"launches each, alternating: {ms:.4f} / "
                      f"{v_lib_ms:.4f} ms ({ms / v_lib_ms:.3f}x)")
            units = moved // 8  # words moved: half read, half written
            ops = PROBE_OPS[v] * (moved // 128 if probe == "u16" else units)
            bms, by = bound(moved, ops)
            phase(f"phase 13 {probe} {shape} {v}: max_abs_err={err} against "
                  f"plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                  f"{v_lib}, "
                  f"bound {bms:.4f} ms ({by}: {moved} bytes, {ops} "
                  f"operations) = {ms / bms:.2f}x")
            if shape == PR.SHAPES[name][1]:
                # the production shape's numbers go into the kernels line
                rows[f"probe_{probe}_{v}"] = dict(
                    replaces=PROBE_REPLACES[probe], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=v_lib_ms, counter=PR.counter(name, v))
        del want
    kernels.reset_launches()
    PR.run_all(dev, timed=False)
    counts = dict(kernels.LAUNCHES)
    for v in ("run", "bulk"):
        if counts[PR.counter("dynwin", v)] < 1:
            raise AssertionError(f"P1's {v} variant was not launched in the "
                                 "probe run")
    for name, row in rows.items():
        key = row.pop("counter")
        if counts[key] < 1:
            raise AssertionError(f"{key} not launched in the probe run "
                                 f"({counts})")
        path_launches[name] = counts[key]
    phase(f"phase 13 probes: the counted run launched "
          f"{ {k: v for k, v in counts.items() if k.startswith('probe_')} }")


def k14_level_elems(nf, orthogonal):
    """Elements K14's passes move at one level step of fine shape nf, each
    pass's inputs read once and outputs written once (both directions): the
    residual (interpolation) pass reads and writes the level box; the L2
    correction restricts along axes 0, 1, 2 and sweeps the coarse box
    along each axis, the last sweep reading and writing the coarse
    values. This design's traffic, not the level step's floor."""
    nc = [n // 2 + 1 for n in nf]
    box, cbox = math.prod(nf), math.prod(nc)
    elems = 2 * box
    if orthogonal:
        t1, t2 = nc[0] * nf[1] * nf[2], nc[0] * nc[1] * nf[2]
        elems += (box + t1) + (t1 + t2) + (t2 + cbox) + 7 * cbox
    return elems


def k14_floor_elems(nf, orthogonal):
    """Elements one level step of fine shape nf has to move whatever its
    design: the level box read once and written once (residuals to their
    nested-box places, coarse values on to the next level), and in the L2
    basis the coarse box's correction read and written once more."""
    cbox = math.prod(n // 2 + 1 for n in nf)
    return 2 * math.prod(nf) + (2 * cbox if orthogonal else 0)


def k14_phase(dev, kernels, rows, v_main):
    """Phase 3 K14: the MultiDim level kernel of a 3D field against its
    plain version (refactor.decompose_plain / recompose_plain, the dense
    operators) on the card: on small shapes, then on the inputs the cells
    give it (the main path's remainder, taken from one compress and
    decompress of the main field ``v_main``, and MDR's 384^3 float32
    field in MDR's basis), then at 500^3 float64 in the L2 basis, timed
    against the level steps' byte floor."""
    import mgard_tpu_torch as M
    from mgard_tpu_torch import highlevel as HL
    from mgard_tpu_torch.hierarchy import Hierarchy, get_hierarchy
    from mgard_tpu_torch.lossless import bfp as B
    from mgard_tpu_torch.ops import multidim as MD, refactor as R

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    limit = {np.float64: 1e-13, np.float32: 1e-6}
    worst = {np.float64: 0.0, np.float32: 0.0}
    gen = np.random.default_rng(5)
    shapes = ((9, 17, 5), (18, 10, 12), (3, 4, 500), (500, 3, 4),
              (4, 500, 3), (3, 3, 3), (33, 18, 40), (65, 130, 257))
    for shape in shapes:
        for dt in (np.float64, np.float32):
            for uniform in (True, False):
                coords = None if uniform else [
                    np.cumsum(gen.uniform(0.3, 1.7, n)) for n in shape]
                hier = Hierarchy(shape, dt, coords)
                v = torch.from_numpy(gen.standard_normal(shape).astype(dt)
                                     ).to(dev)
                for orth in (True, False):
                    d = R.decompose(v, hier, orth)
                    worst[dt] = max(
                        worst[dt], rel(d, R.decompose_plain(v, hier, orth)),
                        rel(R.recompose(v, hier, orth),
                            R.recompose_plain(v, hier, orth)),
                        rel(R.recompose(d, hier, orth), v))
    if any(worst[dt] > limit[dt] for dt in worst):
        raise AssertionError(f"K14 against the dense operators: worst "
                             f"relative error {worst}, limits {limit}")
    phase(f"phase 3 small K14: {len(shapes)} shapes x float64/float32 x "
          f"uniform/non-uniform x L2/hierarchical basis, decompose, "
          f"recompose and the round trip against the dense operators: "
          f"worst relative error float64 {worst[np.float64]:.3e}, float32 "
          f"{worst[np.float32]:.3e} (limits 1e-13, 1e-6)")

    # the main path's own transform inputs: highlevel's decompose and
    # recompose calls of one Hybrid s=inf round trip, kept as they come
    seen = []

    def keeping(name, fn):
        def call(x, hier, orthogonal=False):
            seen.append((name, x.clone(), hier, orthogonal))
            return fn(x, hier, orthogonal=orthogonal)
        return call

    real = HL.decompose, HL.recompose
    HL.decompose = keeping("decompose", real[0])
    HL.recompose = keeping("recompose", real[1])
    try:
        B._K_CACHE.clear()
        blob, st = M.compress(v_main, TOL, s=math.inf,
                              mode=M.error_bound_type.ABS)
        M.decompress(blob, device=dev)
    finally:
        HL.decompose, HL.recompose = real
    B._K_CACHE.clear()
    if sorted(c[0] for c in seen) != ["decompose", "recompose"] or any(
            c[2].D != 3 or c[3] or c[1].dtype != torch.float32
            or c[1].device != v_main.device for c in seen):
        raise AssertionError(f"main path transform calls: "
                             f"{[(c[0], c[2].shape, c[3]) for c in seen]}")
    cfg = M.Config()
    orth_mdr = bool(cfg.mdr_orthogonal_basis)
    v384 = bench_field(N_MDR, dev)
    h384 = get_hierarchy((N_MDR,) * 3, np.float32, None, cfg)
    seen += [("decompose", v384, h384, orth_mdr),
             ("recompose", R.decompose_plain(v384, h384, orth_mdr), h384,
              orth_mdr)]
    cell_errs = []
    for name, x, hier, orth in seen:
        mine, plain = ((R.decompose, R.decompose_plain)
                       if name == "decompose"
                       else (R.recompose, R.recompose_plain))
        cell_errs.append(rel(mine(x, hier, orth), plain(x, hier, orth)))
    if max(cell_errs) > limit[np.float32]:
        raise AssertionError(f"K14 on the cells' inputs: relative errors "
                             f"{cell_errs} (main path decompose, recompose; "
                             f"MDR decompose, recompose), limit 1e-6")
    phase(f"phase 3 K14 on the cells' float32 inputs against the dense "
          f"operators: the {N_MAIN}^3 main path's remainder "
          f"{tuple(seen[0][2].shape)} ({seen[0][2].l_target} levels, "
          f"hierarchical basis, as one compress and decompress hand it "
          f"over) decompose {cell_errs[0]:.3e}, recompose "
          f"{cell_errs[1]:.3e}; MDR's {N_MDR}^3 field "
          f"({'L2' if orth_mdr else 'hierarchical'} basis, "
          f"{h384.l_target} levels) decompose {cell_errs[2]:.3e}, "
          f"recompose {cell_errs[3]:.3e} (limit 1e-6)")
    del seen, v384, x

    n = 500
    hier = get_hierarchy((n, n, n), np.float64)
    L = hier.l_target
    x = torch.linspace(0, 1, n, dtype=torch.float64, device=dev)
    v = (torch.sin(5 * x)[:, None, None] * torch.cos(3 * x)[None, :, None]
         + x[None, None, :] ** 2 + 1e-3 * torch.sin(97 * x)[None, :, None])
    kernels.reset_launches()
    dec = R.decompose(v, hier, True)
    back = R.recompose(dec, hier, True)
    launches = {k: kernels.LAUNCHES[k] for k in ("multidim_decompose",
                                                 "multidim_recompose")}
    if launches != {"multidim_decompose": L, "multidim_recompose": L}:
        raise AssertionError(f"K14 at {n}^3: launches {launches}, want {L} "
                             f"each way")
    e_dec = rel(dec, R.decompose_plain(v, hier, True))
    e_rec = rel(back, R.recompose_plain(dec, hier, True))
    e_rt = rel(back, v)
    if max(e_dec, e_rec, e_rt) > 1e-13:
        raise AssertionError(f"K14 at {n}^3 float64: relative error "
                             f"decompose {e_dec}, recompose {e_rec}, round "
                             f"trip {e_rt}")
    ms_dec = time_ms(lambda: MD.decompose(v, hier, True), 10)
    ms_rec = time_ms(lambda: MD.recompose(dec, hier, True), 10)
    plain_dec = time_ms(lambda: R.decompose_plain(v, hier, True), 3)
    plain_rec = time_ms(lambda: R.recompose_plain(dec, hier, True), 3)
    clone_ms = time_ms(lambda: v.clone(), 10)
    # the finest level alone, on the level loop's buffers
    nf, nc = hier.level_shape[L], hier.level_shape[L - 1]
    tabs = MD._tables(hier, dev)
    scr = v.new_empty(MD.scratch_elems(hier))
    out, cd = torch.empty_like(v), v.new_empty(math.prod(nc))
    fin_dec = time_ms(lambda: MD.decompose_level(
        v, out, cd, (nc[1] * nc[2], nc[2]), tabs[L - 1], scr, nf, True), 10)
    dst = torch.empty_like(v)
    fin_rec = time_ms(lambda: MD.recompose_level(
        dec, cd, dst, tabs[L - 1], scr, nf, True), 10)
    esz = v.element_size()
    levels = [hier.level_shape[l] for l in range(1, L + 1)]
    whole = sum(k14_floor_elems(s, True) for s in levels) * esz
    finest = k14_floor_elems(nf, True) * esz
    design = sum(k14_level_elems(s, True) for s in levels) * esz
    b_whole, b_fin = bound(whole, 0)[0], bound(finest, 0)[0]
    b_design = bound(design, 0)[0]
    for k, ms, plain_ms in (("multidim_decompose", ms_dec, plain_dec),
                            ("multidim_recompose", ms_rec, plain_rec)):
        rows[k] = dict(max_rel_err=max(e_dec, e_rec), ms=ms,
                       plain_ms=plain_ms, bound_ms=b_whole, bound_by="bytes",
                       library_ms=None,
                       finest_ms=fin_dec if k == "multidim_decompose"
                       else fin_rec, finest_bound_ms=b_fin,
                       design_bytes=design)
    phase(f"phase 3 K14 at {n}^3 float64, L2 basis, {L} levels: relative "
          f"error against the dense operators decompose {e_dec:.3e}, "
          f"recompose {e_rec:.3e}, round trip {e_rt:.3e}; decompose "
          f"{ms_dec:.4f} ms, recompose {ms_rec:.4f} ms (bound {b_whole:.4f} "
          f"ms: {whole} bytes, each level box read and written once and "
          f"its coarse box once more for the correction; this design's "
          f"passes move {design} bytes, {b_design:.4f} ms); finest level "
          f"decompose {fin_dec:.4f} ms, recompose {fin_rec:.4f} ms (bound "
          f"{b_fin:.4f} ms: {finest} bytes); dense operators "
          f"{plain_dec:.4f} / {plain_rec:.4f} ms; a clone of the field "
          f"{clone_ms:.4f} ms")
    for line in ptxas_lines(kernels.BUILD_LOG, (
            "resid_kernel", "interp_kernel", "restrict_kernel",
            "thomas_kernel")):
        phase("phase 3 K14 ptxas " + line)
    del v, dec, back, out, cd, dst, scr
    torch.cuda.empty_cache()


def xgc5d(t=12, planes=8, nodes=96, nvx=33, nvy=33, seed=3):
    """The XGC-like 5D distribution of scripts/bench_5d.py: a Maxwellian
    in (vx, vy) with a slow modulation over time, plane and node, plus
    1e-3 noise."""
    rng = np.random.default_rng(seed)
    vx = np.linspace(-3, 3, nvx)
    vy = np.linspace(-3, 3, nvy)
    VX, VY = np.meshgrid(vx, vy, indexing="ij")
    temp = 1.0 + 0.3 * np.sin(np.linspace(0, 3, nodes))[:, None, None]
    maxw = np.exp(-(VX**2 + VY**2)[None] / (2 * temp))
    f = np.empty((t, planes, nodes, nvx, nvy), np.float32)
    for ti in range(t):
        for p in range(planes):
            turb = 1.0 + 0.05 * np.sin(
                2 * np.pi * (3 * ti / t + 2 * p / planes)
                + np.linspace(0, 6, nodes))[:, None, None]
            f[ti, p] = (maxw * turb).astype(np.float32)
    f += rng.normal(0, 1e-3, f.shape).astype(np.float32)
    return f


def generic_phases(dev, M, kernels):
    """Phases 14-19: the generic compress surface at full size."""
    from mgard_tpu_torch import highlevel as HL
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.lossless import bfp as B
    from mgard_tpu_torch.ops import refactor as R
    from mgard_tpu_torch.ops.roi import detect_roi

    ABS, REL = M.error_bound_type.ABS, M.error_bound_type.REL
    DT = M.decomposition_type
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    def counted(fn, zz):
        """fn() with the launch counters reset just before and read just
        after, and the BFP device cores recorded. A section of the generic
        path is one call of bfp.encode_core (decode: decode_core), the
        pre-sorted mode of K2 (K3): natural-order rows with the sort rank
        computed from their own widths. The prepared-payload cores
        (encode_core_zz, decode_core_zz) belong to the hybrid cf stream and
        run `zz` times. Every launch of K2 or K3 must be one of these
        calls. serialize_device_parts runs encode_core a second time on the
        same symbols when the sticky exception bucket (sized by an earlier
        stream of this size) is too small: such a call is a re-run, not a
        section. Returns (result, ms, launches, sections, re-runs)."""
        kernels.reset_launches()
        with Recorder(B, "encode_core") as enc, \
                Recorder(B, "decode_core") as dec, \
                Recorder(B, "encode_core_zz") as enc_zz, \
                Recorder(B, "decode_core_zz") as dec_zz:
            out, ms = timed(fn)
        ln = {k: n for k, n in kernels.LAUNCHES.items() if n}
        reruns = sum(
            1 for (p, _), (c, _) in zip(enc.calls, enc.calls[1:])
            if c[0] is p[0] and c[1:4] == p[1:4] and c[4] > p[4])
        sections = len(enc.calls) - reruns + len(dec.calls)
        if (len(enc_zz.calls) + len(dec_zz.calls) != zz
                or ln.get("bfp_encode", 0) != len(enc.calls)
                + len(enc_zz.calls)
                or ln.get("bfp_decode", 0) != len(dec.calls)
                + len(dec_zz.calls)):
            raise AssertionError(
                f"K2/K3 launches {ln} against {len(enc.calls)} encode_core "
                f"({reruns} re-runs), {len(enc_zz.calls)} encode_core_zz, "
                f"{len(dec.calls)} decode_core, {len(dec_zz.calls)} "
                f"decode_core_zz calls (prepared-payload calls expected: "
                f"{zz})")
        return out, ms, ln, sections, reruns

    def run(tag, v, tol, want, s=math.inf, mode=ABS, cfg=None, coords=None,
            err_fn=None, limit=None, decomposition=DT.MultiDim,
            demoted=False, reps=2, zz=0):
        """Compress + decompress `v` `reps` times on the card, each call
        under `counted`; check status, header, shape, type, finiteness, the
        bound (err_fn(out), default L-inf, against `limit`, default tol),
        that every kernel in `want` was launched, and the exact K2/K3
        counts: each compress packs one pre-sorted section (one
        bfp.encode_core call) plus `zz` prepared cf streams, each
        decompress unpacks the same; the first compress may re-run its
        section once for a larger exception bucket, the last must not (the
        bucket is cached by then)."""
        tc, td, reruns, launches = [], [], [], {}
        for _ in range(reps):
            (blob, st), ms, lc, sec_c, rr = counted(
                lambda: M.compress(v, tol, s, mode, cfg, coords), zz)
            tc.append(ms)
            reruns.append(rr)
            (out, st2), ms, ld, sec_d, _ = counted(
                lambda: M.decompress(blob, device=dev), zz)
            td.append(ms)
            if (sec_c, sec_d) != (1, 1) or rr > 1 or st or st2:
                raise AssertionError(
                    f"{tag}: {sec_c} pre-sorted sections packed ({rr} "
                    f"re-runs), {sec_d} unpacked, status {st}/{st2}; "
                    f"launches {lc} / {ld}")
            for k, n in {**lc, **ld}.items():
                launches[k] = launches.get(k, 0) + n
        if reruns[-1]:
            raise AssertionError(f"{tag}: the exception bucket was cached, "
                                 f"yet compress {reps} re-ran its section")
        meta = header(blob)
        err = (float((out - v).abs().max()) if err_fn is None
               else err_fn(out))
        limit = tol if limit is None else limit
        missing = [k for k in want if launches.get(k, 0) < 1]
        if (tuple(out.shape) != tuple(v.shape)
                or out.dtype != v.dtype or out.device != v.device
                or not bool(torch.isfinite(out).all()) or not err <= limit
                or meta.decomposition != decomposition
                or bool(meta.demoted) != demoted or missing):
            raise AssertionError(
                f"{tag}: out {tuple(out.shape)} "
                f"{out.dtype}, error {err} (limit {limit}), header "
                f"{meta.decomposition.name} demoted={meta.demoted}, not "
                f"launched {missing} ({launches})")
        nbytes = v.numel() * v.element_size()
        phase(f"{tag}: {meta.decomposition.name}, header "
              f"{M.data_type(meta.dtype).name}"
              f"{' demoted' if meta.demoted else ''}, ratio "
              f"{nbytes / len(blob):.4f}, error {err:.3e} <= {limit:.3e}; "
              f"compress {min(tc):.1f} ms ({nbytes / min(tc) / 1e6:.3f} "
              f"GB/s), decompress {min(td):.1f} ms "
              f"({nbytes / min(td) / 1e6:.3f} GB/s) [best of {reps}; first "
              f"{tc[0]:.1f} / {td[0]:.1f} ms]; each call 1 pre-sorted "
              f"section + {zz} prepared cf streams, exception-bucket "
              f"re-runs per compress {reruns}; launches of {reps} calls "
              f"{launches} [{smi}]")
        return blob, out, launches

    def snorm(v, s, coords=None):
        """Achieved error of `out` against `v` in the s-norm (host,
        float64)."""
        ref = v.double().cpu().numpy()
        return lambda out: M.norm(out.double().cpu().numpy() - ref, s, coords)

    PRESORTED = ("bfp_encode", "bfp_decode")

    # -- 14. 1D 2^20 float64 sinusoid, s=0 --------------------------------
    n1 = 1 << 20
    x = torch.linspace(0.0, 1.0, n1, dtype=torch.float64, device=dev)
    v1 = torch.sin(8 * np.pi * x) + 0.4 * torch.sin(37 * np.pi * x)
    B._K_CACHE.clear()
    if R._use_fast(get_hierarchy((n1,), np.float64)):
        raise AssertionError("a 2^20 axis must take the slice path")
    # the shape is hybrid-worthwhile, so the header keeps the default
    # Hybrid; at finite s that is the MultiDim transform of the whole field
    _, _, ln = run("phase 14 1D 2^20 f64 s=0 tol=1e-3", v1, 1e-3, PRESORTED,
                   s=0.0, err_fn=snorm(v1, 0.0), decomposition=DT.Hybrid)
    del x, v1

    # -- 15. 5D (12,8,96,33,33) float32 -----------------------------------
    v5 = torch.from_numpy(xgc5d()).to(dev)
    run("phase 15 5D (12,8,96,33,33) f32 s=inf tol=1e-3", v5, 1e-3, PRESORTED)
    vnorm = float(torch.sqrt(torch.mean(v5.double() ** 2)))
    run("phase 15 5D (12,8,96,33,33) f32 s=0 REL tol=1e-3", v5, 1e-3,
        PRESORTED, s=0.0, mode=REL, err_fn=snorm(v5, 0.0),
        limit=1e-3 * vnorm)
    del v5

    # -- 16. 257^3 on a stretched grid; SingleDim at 129^3 ----------------
    def stretched(n):
        coords = [np.cumsum(1.0 + 0.8 * np.sin(np.linspace(0, 9 + d, n)))
                  for d in range(3)]
        coords = [c / c[-1] for c in coords]
        X, Y, Z = (torch.from_numpy(c).to(dev) for c in coords)
        v = (torch.sin(6 * X)[:, None, None] * torch.cos(5 * Y)[None, :, None]
             + torch.exp(-3 * Z)[None, None, :]).float()
        return v, coords

    v3, coords = stretched(257)
    mcfg = M.Config()
    mcfg.decomposition = DT.MultiDim
    run("phase 16 257^3 f32 non-uniform MultiDim s=inf tol=1e-3", v3, 1e-3,
        PRESORTED, cfg=mcfg, coords=coords)
    run("phase 16 257^3 f32 non-uniform MultiDim s=0 tol=1e-3", v3, 1e-3,
        PRESORTED, s=0.0, cfg=mcfg, coords=coords,
        err_fn=snorm(v3, 0.0, coords))
    del v3
    scfg = M.Config()
    scfg.decomposition = DT.SingleDim
    run("phase 16 129^3 f32 SingleDim s=inf tol=1e-3", bench_field(129, dev),
        1e-3, PRESORTED, cfg=scfg, decomposition=DT.SingleDim)

    # -- 17. 256^3 float64: demoted, then native --------------------------
    v64 = bench_field(256, dev).double()
    v64 = v64 + 1e-9 * torch.sin(40 * v64)  # digits no float32 holds
    B._K_CACHE.clear()
    blob, _, ln = run("phase 17 256^3 f64 tol=1e-3 (demoted)", v64, 1e-3,
                      MAIN_PATH, decomposition=DT.Hybrid, demoted=True, zz=1)
    if section_head(blob)[0] != 1 or header(blob).dtype != M.data_type.Double:
        raise AssertionError("a demoted stream is a float32 flag-1 stream "
                             "with a float64 header")
    small = v64 * 0.01
    blob, _, ln = run("phase 17 256^3 f64 x0.01 tol=1e-9 (native)", small,
                      1e-9, PRESORTED, decomposition=DT.Hybrid)
    if any(ln.get(k) for k in ("hybrid_fwd_v2", "hybrid_inv_v2", "hybrid_fwd",
                               "hybrid_inv")):
        raise AssertionError(f"native float64 reached a float32 front-end "
                             f"kernel: {ln}")
    del v64, small

    # -- 18. compress_roi at 128^3 ----------------------------------------
    nr = 128
    xr = torch.linspace(0.0, 1.0, nr, device=dev)
    vr = (torch.sin(4 * np.pi * xr)[:, None, None]
          * torch.cos(3 * np.pi * xr)[None, :, None]
          + xr[None, None, :] ** 2)
    box = np.zeros((nr,) * 3, bool)
    box[32:96, 32:96, 32:96] = True
    auto = detect_roi(vr, get_hierarchy((nr,) * 3, np.float32))
    tol, factor = 1e-2, 16.0
    # the transform of a 3D field on the card: K14, one launch a level
    # (without a mask, detect_roi decomposes the field once more)
    nlev = get_hierarchy((nr,) * 3, np.float32).l_target
    for what, arg, mask in (("explicit mask", box, box),
                            ("roi_mask=None", None, auto)):
        (blob, st), tc, lc, sec_c, rr = counted(
            lambda: M.compress_roi(vr, tol, arg, roi_factor=factor), 0)
        (out, st2), td, ld, sec_d, _ = counted(
            lambda: M.decompress(blob, device=dev), 0)
        ln = {**lc, **ld}
        err = (out - vr).abs().cpu().numpy()
        e_in, e_out = float(err[mask].max()), float(err[~mask].max())
        if (st or st2 or not header(blob).roi_enabled
                or not e_in <= tol / factor or not e_out <= tol
                or (sec_c, sec_d) != (1, 1) or rr > 1
                or ln != {"bfp_encode": 1 + rr, "bfp_compact": 1,
                          "bfp_decode": 1, "bfp_expand": 1,
                          "multidim_decompose": nlev * (1 + (arg is None)),
                          "multidim_recompose": nlev}):
            raise AssertionError(f"phase 18 {what}: status {st}/{st2}, in-ROI "
                                 f"{e_in}, outside {e_out}, {sec_c} "
                                 f"pre-sorted sections packed ({rr} re-runs), "
                                 f"{sec_d} unpacked, launches {ln}")
        phase(f"phase 18 compress_roi 128^3 tol={tol} factor={factor:g}, "
              f"{what} ({int(mask.sum())} nodes): in-ROI L-inf {e_in:.3e} <= "
              f"{tol / factor:.3e}, outside {e_out:.3e} <= {tol}; ratio "
              f"{vr.numel() * 4 / len(blob):.4f}; compress {tc:.1f} ms, "
              f"decompress {td:.1f} ms; 1 pre-sorted section each way, {rr} "
              f"exception-bucket re-runs; launches {ln} [{smi}]")
    del vr

    # -- 19. small streams of each new kind across devices ----------------
    gen = np.random.default_rng(19)

    def small_field(shape, dtype):
        g = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
        v = sum(np.sin(3 * (i + 1) * a) for i, a in enumerate(g))
        return (v + 0.01 * gen.standard_normal(shape)).astype(dtype)

    c3 = [np.sort(gen.uniform(0, 1, n)) for n in (17, 18, 19)]
    acfg = M.Config()
    acfg.adjust_shape = True
    kinds = [
        ("1D f64 s=0", (4099,), np.float64, dict(s=0.0)),
        ("2D f32 s=inf", (40, 40), np.float32, {}),
        ("3D f64 native s=1", (17, 18, 19), np.float64, dict(s=1.0)),
        ("3D f32 s=-1", (17, 18, 19), np.float32, dict(s=-1.0)),
        ("3D f32 REL s=0", (17, 18, 19), np.float32, dict(s=0.0, mode=REL)),
        ("3D f32 coords", (17, 18, 19), np.float32, dict(coords=c3)),
        ("3D f32 SingleDim", (20, 21, 22), np.float32, dict(config=scfg)),
        ("3D f32 adjust_shape", (30, 30, 30), np.float32, dict(config=acfg)),
        ("4D f32", (9, 10, 11, 12), np.float32, {}),
        ("5D f32", (5, 6, 7, 8, 9), np.float32, {}),
        ("3D f64 demoted", (64, 64, 64), np.float64, {}),
        ("3D f64 Hybrid native", (64, 64, 64), np.float64, dict(tol=1e-9)),
        ("3D f32 ROI", (33, 34, 35), np.float32, dict(roi=True)),
    ]
    worst = 0.0
    for what, shape, dtype, kw in kinds:
        kw = dict(kw)
        tol = kw.pop("tol", 1e-3)
        roi = kw.pop("roi", False)
        host = small_field(shape, dtype)
        if tol < 1e-6:
            host = host * 0.01
        for writer, src in (("card", torch.from_numpy(host).to(dev)),
                            ("CPU", torch.from_numpy(host))):
            if roi:
                mask = host > np.quantile(host, 0.8)
                blob, st = M.compress_roi(src, tol, mask)
            else:
                blob, st = M.compress(src, tol, **kw)
            og, sg = M.decompress(blob, device=dev)
            oc, sc = M.decompress(blob, device="cpu")
            d = float((og.cpu() - oc).abs().max())
            # one stream, two devices: the symbols are the same, the
            # transforms round in another order (matmuls); a demoted
            # stream decodes in float32
            lim = (1e-5 if dtype == np.float32 or "demoted" in what
                   else 1e-13)
            if st or sg or sc or og.dtype != src.dtype or not d <= lim:
                raise AssertionError(f"phase 19 {what} written on the "
                                     f"{writer}: status {st}/{sg}/{sc}, card "
                                     f"vs CPU decode {d} (limit {lim})")
            if kw.get("s", math.inf) == math.inf and not roi:
                e = float((oc - torch.from_numpy(host)).abs().max())
                if not e <= tol:
                    raise AssertionError(f"phase 19 {what}: L-inf {e}")
            worst = max(worst, d / lim)
    phase(f"phase 19 {len(kinds)} kinds of small streams, each written on "
          f"the card and on the CPU, each decoded on both: statuses 0, card "
          f"vs CPU decode within 1e-5 (float32) / 1e-13 (float64), worst "
          f"{worst:.3f} of its limit")


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden")
# reference-format goldens and how the tests of both packages check each
# decode: (stream, shape, dtype, the reference decoder's own output or
# None, its tolerance, the input the bound is held against or None, the
# bound's norm ("linf", "l2" = RMS, None), the bound's limit)
_IN65 = "ref_input_3d65_f32_lz4_abs.bin"
REF_GOLDENS = [
    ("ref_blob_3d65_f32_lz4_abs", (65,) * 3, "f4", None, 0, _IN65, "linf",
     1e-3),
    ("ref_blob_3d606570_f64_lz4_abs", (60, 65, 70), "f8", None, 0,
     "ref_input_3d606570_f64_lz4_abs.bin", "linf", 1e-4),
    ("ref_blob_3d65_f32_lz4_rel", (65,) * 3, "f4", None, 0,
     "ref_input_3d65_f32_lz4_rel.bin", "rel", 1e-3),
    ("ref_blob_3d65_f32_lz4_s0", (65,) * 3, "f4", None, 0,
     "ref_input_3d65_f32_lz4_s0.bin", "l2", 1e-3),
    ("ref_blob_3d65_f32_sdim", (65,) * 3, "f4", "ref_dec_3d65_f32_sdim",
     2e-6, _IN65, "linf", 1e-3),
    ("ref_blob_3d65_f32_hyb", (65,) * 3, "f4", None, 0, None, None, 0),
    ("ref_blob_3d643333_f32_lz4_abs_dd", (64, 33, 33), "f4",
     "ref_dec_3d643333_f32_lz4_abs_dd", 1e-5, None, None, 0),
    ("ref_blob_3d643333_f32_lz4_s0_dd", (64, 33, 33), "f4",
     "ref_dec_3d643333_f32_lz4_s0_dd", 1e-5, None, None, 0),
    ("ref_blob_3d65_f32_huf_abs", (65,) * 3, "f4", None, 0,
     "ref_input_3d65_f32_huf_abs.bin", "linf", 1e-3),
    ("ref_blob_3d65_f32_huflz4_abs", (65,) * 3, "f4", None, 0,
     "ref_input_3d65_f32_huflz4_abs.bin", "linf", 1e-3),
    ("ref_blob_3d65_f32_hufzstd_s0", (65,) * 3, "f4", None, 0,
     "ref_input_3d65_f32_hufzstd_s0.bin", "l2", 1e-3),
] + [
    (f"ref_blob_3d65_f32_{t}", (65,) * 3, "f4", f"ref_dec_3d65_f32_{t}", 1e-6,
     _IN65, "linf", 1e-3)
    for t in ("bdfixed", "bddelta", "bdoutlier", "symrans", "zrlerans")
] + [
    (f"xwrite_3d65_{t}", (65,) * 3, dt, f"xwrite_dec_3d65_{t}", atol, None,
     None, 0)
    for t, dt, atol in (("f32_abs", "f4", 1e-5), ("f32_s0", "f4", 1e-5),
                        ("f64_abs", "f8", 1e-12))
] + [
    (f"cpuwrite_{t}", shape, dt, f"cpuwrite_dec_{t}",
     2e-6 if dt == "f4" else 1e-12, None, None, 0)
    for t, shape, dt in (("3d151617_f64_sinf", (15, 16, 17), "f8"),
                         ("3d151617_f64_s0", (15, 16, 17), "f8"),
                         ("3d9917_f32_sinf", (9, 9, 17), "f4"),
                         ("2d179_f64_nonuni", (17, 9), "f8"))
]


def cpu_goldens():
    """The reference CPU library's streams (the manifests of
    tests/golden/generate_cpu_stream.sh), and the names of those whose
    payload is a real zstd frame."""
    out, zstd = [], set()
    for variant in ("zstd", "zlib"):
        with open(os.path.join(GOLDEN, f"cpu_manifest_{variant}.json")) as f:
            for e in json.load(f):
                if not e:
                    continue
                dt = "f4" if e["dtype"] == "f32" else "f8"
                tag = e["tag"]
                bound = e["s"] == "inf"
                out.append((f"cpu_stream_{tag}", tuple(e["shape"]), dt,
                            f"cpu_output_{tag}",
                            2e-6 if dt == "f4" else 1e-12,
                            f"cpu_input_{tag}.bin" if bound else None,
                            "linf" if bound else None, e["tol"]))
                if variant == "zstd":
                    zstd.add(f"cpu_stream_{tag}")
    return out, zstd


def reference_phase(dev, M):
    """Phase 20: streams of the reference libraries on the card. Every
    reference-format golden decoded onto the card and held as the tests
    hold it; a 512^3 X_LZ4 stream written and read on the card; an MDR-X
    archive of a 256^3 field written and read back at three
    tolerances."""
    from mgard_tpu_torch import native
    from mgard_tpu_torch.formats import mdrx_stream as MX, ref_stream as RS
    from mgard_tpu_torch.lossless import host

    t0 = time.perf_counter()
    libs = [native.load(n) for n in ("lz4", "huffdec")]
    phase(f"phase 20 native: lz4.cpp and huffdec.cpp built into "
          f"{os.path.relpath(native.BUILD_DIR)} and loaded ({len(libs)}) in "
          f"{time.perf_counter() - t0:.2f} s")

    def load(name, dt, shape):
        return np.fromfile(os.path.join(GOLDEN, name), dt).reshape(shape)

    st = M.compress_status_type
    zstd_refused, decoded, worst = [], 0, 0.0
    cpu, zstd_frames = cpu_goldens()
    goldens = REF_GOLDENS + cpu
    # the streams whose sections are real zstd frames (zstandard reads them)
    zstd_frames.add("ref_blob_3d65_f32_hufzstd_s0")
    for name, shape, dt, dec, atol, inp, norm, lim in goldens:
        with open(os.path.join(GOLDEN, name + ".mgard"), "rb") as f:
            blob = f.read()
        out, status = M.decompress(blob, device=dev)
        if name.endswith("_hyb"):
            # the reference's Hybrid layout is refused, as in the JAX package
            if out is not None or status != st.Failure:
                raise AssertionError(f"phase 20 {name}: {status}, not "
                                     "Failure")
            continue
        if name in zstd_frames and not host.have_zstd():
            if out is not None or status != st.BackendNotAvailableFailure:
                raise AssertionError(f"phase 20 {name}: {status} without "
                                     "zstandard")
            zstd_refused.append(name)
            continue
        if status != st.Success or out.device.type != "cuda" or \
                tuple(out.shape) != shape or \
                out.dtype != (torch.float32 if dt == "f4" else torch.float64):
            raise AssertionError(f"phase 20 {name}: {status}, "
                                 f"{None if out is None else out.device}")
        got = out.cpu().numpy().astype(np.float64)
        if dec is not None:
            d = float(np.abs(got - load(dec + ".bin", dt, shape)).max())
            if not d <= atol:
                raise AssertionError(f"phase 20 {name}: {d} from the "
                                     f"reference decoder's output > {atol}")
            worst = max(worst, d / atol)
        if inp is not None:
            v = load(inp, dt, shape).astype(np.float64)
            diff = got - v
            err = (float(np.sqrt(np.mean(diff ** 2))) if norm == "l2"
                   else float(np.abs(diff).max()))
            bnd = lim * (float(np.abs(v).max()) if norm == "rel" else 1.0)
            if not err <= bnd:
                raise AssertionError(f"phase 20 {name}: error {err} > {bnd}")
        decoded += 1
    phase(f"phase 20 goldens: {decoded} of {len(goldens)} reference-format "
          f"streams decoded onto the card within their checks (worst "
          f"{worst:.3f} of the tolerance against the reference decoder's "
          f"output), the Hybrid one refused (Failure); "
          f"{len(zstd_refused)} with real zstd frames gave "
          f"BackendNotAvailableFailure (zstandard "
          f"{'present' if host.have_zstd() else 'absent'}): "
          f"{', '.join(sorted(zstd_refused))}")

    # 512^3 X_LZ4 stream written and read on the card
    v = bench_field(N_MAIN, dev)
    enc, dec_ms = [], []
    for _ in range(3):
        blob, ms = timed(lambda: RS.compress_reference(
            v, TOL, math.inf, M.error_bound_type.ABS))
        enc.append(ms)
    for _ in range(3):
        (out, status), ms = timed(lambda: M.decompress(blob, device=dev))
        dec_ms.append(ms)
    h = RS.parse_header(blob)
    err = float((out - v).abs().max()) if out is not None else math.inf
    if status != st.Success or out.device.type != "cuda" or \
            h.compressor != RS.ENC_X_LZ4 or not err <= TOL:
        raise AssertionError(f"phase 20 X_LZ4 {N_MAIN}^3: {status}, "
                             f"compressor {h.compressor}, L-inf {err}")
    phase(f"phase 20 X_LZ4 reference stream {N_MAIN}^3 f32 tol={TOL} s=inf "
          f"ABS on the card: {len(blob)} bytes (ratio "
          f"{v.numel() * 4 / len(blob):.4f}), L-inf {err:.6g}; "
          f"compress_reference {statistics.median(enc):.1f} ms, decompress "
          f"{statistics.median(dec_ms):.1f} ms (host clock, medians of 3)")
    del out, v, blob

    # an MDR-X archive of a 256^3 field, read back at three tolerances
    v = bench_field(N_CROSS, dev)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_mdrx")
    _, ms = timed(lambda: MX.write_mdrx(path, v))
    files = os.listdir(path)
    size = sum(os.path.getsize(os.path.join(path, n)) for n in files)
    a = MX.MDRXArchive(path, dev)
    parts = []
    for tol in (1e-2, 1e-3, 1e-4):
        planes = a.request(tol)
        fetched = sum(int(a.md.level_sizes[l][g])
                      for l, k in enumerate(planes)
                      for g in range(0, k, 4))
        out, rms = timed(lambda: a.reconstruct(tol))
        err = float((out - v).abs().max())
        if out.device.type != "cuda" or not err <= tol:
            raise AssertionError(f"phase 20 MDR-X tol {tol:g}: L-inf {err} "
                                 f"on {out.device}")
        parts.append(f"tol {tol:g}: {fetched} bytes fetched, L-inf "
                     f"{err:.3g}, {rms:.1f} ms")
    phase(f"phase 20 MDR-X archive {N_CROSS}^3 f32: write_mdrx {ms:.1f} ms, "
          f"{len(files)} files, {size} bytes; MDRXArchive on the card: "
          + "; ".join(parts))


def xgc_phase(dev, M):
    """Phase 21: XGC's f0 shape at s = 0 through the public API, the slice
    route counted and timed. Runs alone too:
    ``python3 -c "import chip_smoke as C; C.xgc_phase('cuda', None)"``."""
    import mgard_tpu_torch
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.ops import refactor as R
    from mgard_tpu_torch.utils import trace

    M = M or mgard_tpu_torch
    dev = torch.device(dev)
    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_torch")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import field
    import reference_l2
    import registry

    cfg = registry.config([bench], "xgc4d_f64")
    shape = tuple(cfg["shape"])
    tol = float(cfg["error_bound"]["tol"])
    hier = get_hierarchy(shape, np.float64)
    if R._use_fast(hier):
        raise AssertionError(f"{shape} must take the slice route")
    v = field.make_field(cfg, 42, 0, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    keys = ("transform.slice_levels", "transform.scan_passes",
            "transform.solve_elems", "transform.levels", "quantize.symbols",
            "copy.staged.calls")
    c0 = trace.counters()
    (blob, st), tc = timed(lambda: M.compress(
        v, tol, 0.0, M.error_bound_type.REL))
    c1 = trace.counters()
    (out, st2), td = timed(lambda: M.decompress(blob, device=dev))
    c2 = trace.counters()
    peak = torch.cuda.max_memory_allocated(dev)
    dw, dr = ({k: c.get(k, 0) - b.get(k, 0) for k in keys}
              for b, c in ((c0, c1), (c1, c2)))
    bound = tol * reference_l2.rel_norm(v)
    err = reference_l2.l2_norm(out - v)
    if (st or st2 or tuple(out.shape) != shape or out.dtype != v.dtype
            or not err <= bound
            or dw["transform.slice_levels"] != hier.l_target
            or dr["transform.slice_levels"] != hier.l_target
            or dw["transform.scan_passes"] <= 0):
        raise AssertionError(f"XGC {shape}: status {st}/{st2}, L2 error "
                             f"{err} (bound {bound}), counters {dw} / {dr}")
    del out
    t_dec = time_ms(lambda: R.decompose(v, hier, True), 2)
    dec = R.decompose(v, hier, True)
    t_rec = time_ms(lambda: R.recompose(dec, hier, True), 2)
    nbytes = v.numel() * v.element_size()
    phase(f"phase 21 XGC {shape} f64 REL tol={tol:g} s=0: ratio "
          f"{nbytes / len(blob):.4f}, L2 error / bound {err / bound:.5f}; "
          f"compress {tc:.1f} ms ({nbytes / tc / 1e6:.3f} GB/s), decompress "
          f"{td:.1f} ms ({nbytes / td / 1e6:.3f} GB/s) [one call each]; "
          f"the transform alone {t_dec:.1f} / {t_rec:.1f} ms (CUDA events, "
          f"mean of 2); peak device memory {peak / 2**30:.3f} GiB; "
          f"counters of the compress {dw}, of the decompress {dr}")
    del v, dec
    torch.cuda.empty_cache()


def main():
    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0], flush=True)
    phase(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"count {torch.cuda.device_count()}")

    import mgard_tpu_torch as M
    from mgard_tpu_torch import highlevel as HL, kernels
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.lossless import bfp as B, bfx as X
    from mgard_tpu_torch.ops import hybrid as Hy
    from mgard_tpu_torch import mdr as MDR
    from mgard_tpu_torch.mdr import api as MA, bitplane as BP
    from mgard_tpu_torch.mdr import components as MC
    from mgard_tpu_torch.mdr.qoi import MDReconstructQoI, VTotQoI
    from mgard_tpu_torch.ops.refactor import decompose
    from mgard_tpu_torch.utils.bytesink import join

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    phase(f"phase 2 build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line:
            phase("  ptxas " + line.strip())

    # -- 3. kernels against their plain versions -------------------------
    rows = {}

    def report(name, err, ms, plain_ms, moved, ops):
        """Record a kernel's row (its max_abs_err against the plain version
        must be 0) with the bound of this run's inputs."""
        if err != 0.0:
            raise AssertionError(f"{name}: max_abs_err {err} != 0")
        bms, by = bound(moved, ops)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=None)
        phase(f"phase 3 {name}: max_abs_err={err} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
              f"{moved} bytes, {ops} operations)")

    def check_hybrid(v, C, nl, q, timed):
        inv_q = HL._inv_q(q)
        k = Hy.local_transform_fused_v2(v, inv_q, nl, C)
        p = Hy.local_transform_v2(v, inv_q, nl, C)
        err_f = max(max_abs(a, b) for a, b in zip(k, p))
        ok = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and \
            torch.equal(k[2], p[2])
        if not ok:
            raise AssertionError(f"K1 differs from plain: {err_f}")
        oi = Hy.local_inverse_fused_v2(k[0], k[2], HL._f32(q), nl)
        op = Hy.local_inverse_v2(k[0], k[2], HL._f32(q), nl)
        err_i = max_abs(oi, op)
        if not timed:
            if err_i != 0.0:
                raise AssertionError(f"K4 differs from plain: {err_i}")
            phase(f"phase 3 {tuple(v.shape)} C={C} nl={nl}: K1 and K4 equal "
                  "to plain")
            return k
        report("hybrid_fwd_v2", err_f,
               time_ms(lambda: Hy.local_transform_fused_v2(v, inv_q, nl, C)),
               time_ms(lambda: Hy.local_transform_v2(v, inv_q, nl, C), 2),
               tensor_bytes(v, k), OPS_PER_ELEM["hybrid_fwd_v2"] * v.numel())
        report("hybrid_inv_v2", err_i,
               time_ms(lambda: Hy.local_inverse_fused_v2(
                   k[0], k[2], HL._f32(q), nl)),
               time_ms(lambda: Hy.local_inverse_v2(
                   k[0], k[2], HL._f32(q), nl), 2),
               tensor_bytes(k[0], k[2], oi),
               OPS_PER_ELEM["hybrid_inv_v2"] * oi.numel())
        # yardsticks that move the same bytes (not the same function)
        cast_f = time_ms(lambda: v.to(torch.float16))
        cast_i = time_ms(lambda: k[0].view(torch.float16).to(torch.float32))
        phase(f"phase 3 K1/K4 yardsticks: PyTorch's float32 -> float16 cast "
              f"of the field {cast_f:.4f} ms (K1's bytes), float16 -> "
              f"float32 of the payload {cast_i:.4f} ms (K4's)")
        return k

    # K1/K4 at their edges: Z = 1024 (32 chunk rows a row, MAX_H), C in
    # {1, 2, 16}, X and Y that are not powers of two, nl 1-3, and a field
    # with one code whose bit 31 is set (its chunk's width is 32)
    gen = np.random.default_rng(7)
    small = (((16, 16, 128), 4, 3), ((8, 128, 768), 8, 3),
             ((16, 16, 256), 8, 2), ((16, 16, 128), 4, 1),
             ((8, 8, 1024), 1, 3), ((8, 8, 1024), 16, 2),
             ((8, 8, 1024), 2, 1), ((24, 8, 384), 1, 3),
             ((40, 384, 128), 2, 2), ((24, 8, 384), 3, 1))
    for shp, C, nl in small:
        vs = torch.from_numpy(gen.standard_normal(shp).astype(np.float32))
        check_hybrid(vs.to(dev), C, nl, 1e-3, timed=False)
    vs = torch.from_numpy(gen.standard_normal((8, 16, 256)).astype(np.float32))
    vs[3, 5, 77] = 1.6e9
    for nl in (1, 2, 3):
        wide = check_hybrid(vs.to(dev), 2, nl, 1.0, timed=False)[1]
        if int(wide.max()) != 32:
            raise AssertionError("K1: a code with bit 31 set must give its "
                                 f"chunk width 32, got {wide.max()}")
    phase(f"phase 3 small K1/K4: the {len(small)} shapes above and the "
          "width-32 field at nl 1-3 equal to plain")

    v = bench_field(N_MAIN, dev)
    padded = (N_MAIN,) * 3
    cfg = M.Config()
    rem_hier = get_hierarchy(Hy.remainder_shape(padded, 3), np.float32, None,
                             cfg)
    q = HL._hybrid_quantizer(TOL, Hy.hybrid_l_total(padded, 3, rem_hier))
    C = HL._pick_v2_chunk(padded, cfg)
    inv_q = HL._inv_q(q)
    # num_local_refactoring_level is the caller's: at nl 1 a block holds 125
    # corners, at nl 3 eight
    for nl in (1, 2):
        pay, cw, rem = check_hybrid(v, C, nl, q, timed=False)
        fwd = time_ms(lambda: Hy.local_transform_fused_v2(v, inv_q, nl, C))
        inv = time_ms(lambda: Hy.local_inverse_fused_v2(pay, rem, HL._f32(q),
                                                        nl))
        phase(f"phase 3 K1/K4 at 512^3, nl={nl}: K1 {fwd:.4f} ms, K4 "
              f"{inv:.4f} ms")
    pay, cw, rem = check_hybrid(v, C, 3, q, timed=True)

    # K2/K3, cf stream (u16 rows) at the main path's K
    E, sb = B.E_DEFAULT, HL._v2_sb(cfg, N_MAIN ** 3, C)
    hist = np.bincount(np.clip(cw.cpu().numpy(), 0, 32), minlength=33)
    K = B.choose_K(hist, E, C)
    crl = (cw - K).clamp(0, E).to(torch.int32)
    prow = pay.reshape(-1, C * 32)
    with Recorder(B, "encode_bands") as enc:
        out_k = B.encode_core_zz(prow, crl, K, E, sb, C)
    with Recorder(B, "encode_bands", B.encode_bands_plain):
        out_p = B.encode_core_zz(prow, crl, K, E, sb, C)
    n_cf = N_MAIN ** 3
    blob_k = join(B.serialize_prepared_parts(n_cf, K, E, sb, C, crl, *out_k))
    blob_p = join(B.serialize_prepared_parts(n_cf, K, E, sb, C, crl, *out_p))
    if blob_k != blob_p:
        raise AssertionError("K2 (cf stream) bytes differ from plain")
    enc_args, enc_kw = enc.calls[0]
    cf_enc = (time_ms(lambda: B.encode_bands(*enc_args, **enc_kw)),
              time_ms(lambda: B.encode_bands_plain(*enc_args, **enc_kw), 2))
    k2_io = [enc_args, B.encode_bands(*enc_args, **enc_kw)]
    with Recorder(B, "decode_bands") as dec:
        back_k = B.decode_core_zz(out_k[0], crl, out_k[1], K, E, sb,
                                  n_cf // 32, C)
    with Recorder(B, "decode_bands", B.decode_bands_plain):
        back_p = B.decode_core_zz(out_k[0], crl, out_k[1], K, E, sb,
                                  n_cf // 32, C)
    if not (torch.equal(back_k, back_p) and torch.equal(back_k, prow)):
        raise AssertionError("K3 (cf stream) rows differ")
    dec_args, dec_kw = dec.calls[0]
    cf_dec = (time_ms(lambda: B.decode_bands(*dec_args, **dec_kw)),
              time_ms(lambda: B.decode_bands_plain(*dec_args, **dec_kw), 2))
    k3_io = [dec_args, B.decode_bands(*dec_args, **dec_kw)]
    phase(f"phase 3 K2/K3 cf stream: K={K} E={E} sb={sb} C={C}: bytes and "
          f"rows equal; encode {cf_enc[0]:.4f} ms (plain {cf_enc[1]:.4f}), "
          f"decode {cf_dec[0]:.4f} ms (plain {cf_dec[1]:.4f})")

    # K12/K13, the cf stream's wire compaction: the card writes the blob of
    # the same tensors on the CPU (the plain versions) and reads it back to
    # K2's band rows, as the CPU does; each kernel equal to its plain
    # version, timed beside a copy of the wire words
    blob_h = join(B.serialize_prepared_parts(n_cf, K, E, sb, C, crl.cpu(),
                                             *(t.cpu() for t in out_k)))
    if blob_h != blob_k:
        raise AssertionError("K12 (cf stream) bytes differ from the CPU's")
    base_h, _, rbuf_h, _, _ = B.deserialize_prepared(blob_k, 0, "cpu")
    base_d, _, rbuf_d, _, _ = B.deserialize_prepared(blob_k, 0, dev)
    nrow = rbuf_d.shape[0]
    if not (torch.equal(base_d.cpu(), base_h)
            and torch.equal(rbuf_d.cpu(), rbuf_h)
            and torch.equal(rbuf_d, out_k[1][:nrow])):
        raise AssertionError("K13 (cf stream) differs from the CPU's "
                             "expansion")
    geo = B._band_geometry(crl.cpu().numpy(), E, C, sb)
    wtab = B._wire_table(*geo[:3], C)
    wtab_d = torch.from_numpy(wtab).to(dev)
    wire = B.compact_wire(out_k[1], wtab, C)
    if not (torch.equal(wire, B.compact_wire_plain(out_k[1], wtab_d, C))
            and torch.equal(B.expand_wire(wire, wtab, C, nrow),
                            B.expand_wire_plain(wire, wtab_d, C, nrow))):
        raise AssertionError("K12/K13 (cf stream) differ from plain")
    wbuf, xbuf = torch.empty_like(wire), torch.empty_like(rbuf_d)
    k12_ms = time_ms(lambda: kernels.launch(
        "bfp_compact", out_k[1].data_ptr(), wtab_d.data_ptr(),
        wbuf.data_ptr(), wtab.shape[0], C, kernels.stream(dev)), 20)
    k13_ms = time_ms(lambda: kernels.launch(
        "bfp_expand", wire.data_ptr(), wtab_d.data_ptr(), xbuf.data_ptr(),
        wtab.shape[0], C, kernels.stream(dev)), 20)
    if not (torch.equal(wbuf, wire) and torch.equal(xbuf, rbuf_d)):
        raise AssertionError("K12/K13 timed launches differ")
    k12_plain = time_ms(lambda: B.compact_wire_plain(out_k[1], wtab_d, C), 2)
    k13_plain = time_ms(lambda: B.expand_wire_plain(wire, wtab_d, C, nrow), 2)
    wire_copy = time_ms(lambda: wire.clone(), 20)
    # bytes: the valid words read and written (K13: the whole band rows
    # written), and the table
    k12_bytes = 2 * tensor_bytes(wire) + tensor_bytes(wtab_d)
    k13_bytes = tensor_bytes(wire, rbuf_d, wtab_d)
    phase(f"phase 3 K12/K13 cf stream: {wire.numel()} wire words, {nrow} "
          f"band rows, {wtab.shape[0]} bands: blob and band rows equal to "
          f"the CPU's; K12 {k12_ms:.4f} ms (bound "
          f"{bound(k12_bytes, 0)[0]:.4f}), K13 {k13_ms:.4f} ms (bound "
          f"{bound(k13_bytes, 0)[0]:.4f}); a copy of the wire words "
          f"{wire_copy:.4f} ms")
    for line in ptxas_lines(kernels.BUILD_LOG, ("bfp_compact_kernel",
                                                "bfp_expand_kernel")):
        phase("phase 3 K12/K13 ptxas " + line)
    report("bfp_compact", 0.0, k12_ms, k12_plain, k12_bytes, 0)
    report("bfp_expand", 0.0, k13_ms, k13_plain, k13_bytes, 0)
    del blob_h, base_h, rbuf_h, base_d, rbuf_d, wire, wbuf, xbuf, wtab_d

    # u32 rows at the same size: the cf payload as the int32 rows of a
    # stream with K+E > 16 (the flag-0 fallback's row type), K=9 E=8
    w_rows = prow.to(torch.int32) & 0xFFFF
    w_plan = B._zz_plan((cw - 9).clamp(0, E).to(torch.int32), E, sb, C,
                        False)
    w_args = (w_rows, w_plan[0], w_plan[3], w_plan[2], w_plan[4], 9, E, sb,
              C, w_plan[6])
    w_out = B.encode_bands(*w_args)
    if not all(torch.equal(a, b)
               for a, b in zip(w_out, B.encode_bands_plain(*w_args))):
        raise AssertionError("K2 (u32 rows at 512^3) differs from plain")
    w_dargs = (*w_out, *w_args[1:5], w_plan[1], 9, E, sb, C, True)
    if not torch.equal(B.decode_bands(*w_dargs), w_rows):
        raise AssertionError("K3 (u32 rows at 512^3) differs from the rows")
    w_ms = (time_ms(lambda: B.encode_bands(*w_args)),
            time_ms(lambda: B.decode_bands(*w_dargs)))
    w_bytes = (tensor_bytes(w_args, w_out),
               tensor_bytes(w_out[0], *w_args[1:5], w_plan[1], w_rows)
               + 4 * C * int(w_plan[1].sum()))
    w_ops = w_rows.numel() // 32 * 500
    phase(f"phase 3 K2/K3 u32 rows at {N_MAIN}^3 (K=9, E=8): equal to plain; "
          f"encode {w_ms[0]:.4f} ms (bound {bound(w_bytes[0], w_ops)[0]:.4f}),"
          f" decode {w_ms[1]:.4f} ms (bound "
          f"{bound(w_bytes[1], w_ops)[0]:.4f}); the copy of the rows "
          f"{time_ms(lambda: w_rows.clone()):.4f} ms")
    del w_rows, w_plan, w_args, w_out, w_dargs

    # K2/K3, remainder stream (generic encode_core: natural rows + rank)
    rem_sym = Hy.quantize(decompose(rem, rem_hier), HL._inv_q(q)).reshape(-1)
    B._K_CACHE.clear()
    with Recorder(B, "encode_bands") as enc:
        st_k = B.encode_device(rem_sym, cfg)
    with Recorder(B, "encode_bands", B.encode_bands_plain):
        st_p = B.encode_device(rem_sym, cfg)
    rblob_k = join(B.serialize_device_parts(st_k))
    if rblob_k != join(B.serialize_device_parts(st_p)):
        raise AssertionError("K2 (remainder stream) bytes differ from plain")
    enc_args, enc_kw = enc.calls[0]
    rem_enc = (time_ms(lambda: B.encode_bands(*enc_args, **enc_kw)),
               time_ms(lambda: B.encode_bands_plain(*enc_args, **enc_kw), 2))
    k2_io += [enc_args, B.encode_bands(*enc_args, **enc_kw)]
    with Recorder(B, "decode_bands") as dec:
        sym_k, _ = B.decode(rblob_k, 0, dev)
    with Recorder(B, "decode_bands", B.decode_bands_plain):
        sym_p, _ = B.decode(rblob_k, 0, dev)
    if not (torch.equal(sym_k, sym_p) and torch.equal(sym_k, rem_sym)):
        raise AssertionError("K3 (remainder stream) symbols differ")
    dec_args, dec_kw = dec.calls[0]
    rem_dec = (time_ms(lambda: B.decode_bands(*dec_args, **dec_kw)),
               time_ms(lambda: B.decode_bands_plain(*dec_args, **dec_kw), 2))
    k3_io += [dec_args, B.decode_bands(*dec_args, **dec_kw)]
    _s = st_k
    phase(f"phase 3 K2/K3 remainder stream: n={rem_sym.numel()} K={_s[2]} "
          f"E={_s[3]} sb={_s[4]} C={_s[8]}: bytes and symbols equal; "
          f"encode {rem_enc[0]:.4f} ms (plain {rem_enc[1]:.4f}), decode "
          f"{rem_dec[0]:.4f} ms (plain {rem_dec[1]:.4f})")

    # the rows each stream hands K2 are whole allocations: 16-byte aligned
    # for the vector loads; a view one element off is refused, not run
    for what, args in (("cf", k2_io[0]), ("remainder", k2_io[2])):
        rows_in = args[0]
        if rows_in.data_ptr() % 16:
            raise AssertionError(f"K2 {what} rows are not 16-byte aligned")
        buf = torch.empty(rows_in.numel() + 8, dtype=rows_in.dtype,
                          device=dev)
        off = buf[1:1 + rows_in.numel()].view(rows_in.shape)
        off.copy_(rows_in)
        try:
            B.encode_bands(off, *args[1:])
        except RuntimeError as e:
            if "misaligned" not in str(e):
                raise
        else:
            raise AssertionError(f"K2 ran on misaligned {what} rows")
        del buf, off
    phase("phase 3 K2 alignment: the cf and remainder rows are 16-byte "
          "aligned; a copy one element off raises (misaligned address)")

    # every edge case of bfp.BAND_CASES (the CPU schedule test's): base,
    # resid and the rows back bit-equal to the plain versions
    for spec in B.BAND_CASES:
        args, cnt_e, _ = B.band_case(spec, dev)
        got = B.encode_bands(*args)
        want = B.encode_bands_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K2 differs from plain on {spec[0]}")
        dargs = (*got, *args[1:5], cnt_e, *args[5:9],
                 args[0].dtype == torch.int32)
        back = B.decode_bands(*dargs)
        if not (torch.equal(back, B.decode_bands_plain(*dargs))
                and torch.equal(back, args[0])):
            raise AssertionError(f"K3 differs from plain on {spec[0]}")
    phase(f"phase 3 small K2/K3: the {len(B.BAND_CASES)} edge cases of "
          "bfp.BAND_CASES (u16 and u32 rows, K=0, K+E=16/18/32, rband 0, "
          "rank the identity, sb=16384 C=8, static cap) equal to plain")

    # wide rows (K+E > 16) and the small superblock (sb=256, C=2)
    wide = torch.from_numpy(
        (gen.standard_normal(256 * 32 * 4) * 5e4).astype(np.int32)).to(dev)
    wcfg = M.Config()
    wcfg.bfp_base_planes, wcfg.bfp_sb_blocks = 12, 256
    with Recorder(B, "encode_bands", B.encode_bands_plain):
        wb_p = join(B.serialize_device_parts(B.encode_device(wide, wcfg)))
    wb_k = join(B.serialize_device_parts(B.encode_device(wide, wcfg)))
    if wb_k != wb_p or not torch.equal(B.decode(wb_k, 0, dev)[0], wide):
        raise AssertionError("K2/K3 wide rows at sb=256 differ")
    phase("phase 3 small K2/K3 wide rows (K=12, E=8) at sb=256, C=2: bytes "
          "and symbols equal")
    # yardsticks that move the rows' bytes (not the same function): a copy
    # of the rows K2 reads and of the rows K3 writes
    yard = [(time_ms(lambda a=a: a[0].clone()),
             time_ms(lambda o=o: o.clone()))
            for a, o in ((k2_io[0], k3_io[1]), (k2_io[2], k3_io[3]))]
    phase(f"phase 3 K2/K3 per stream, ms (ballot design, both streams: K2 "
          f"{K2_K3_BEFORE[0]}, K3 {K2_K3_BEFORE[1]}): cf encode "
          f"{cf_enc[0]:.4f} / decode {cf_dec[0]:.4f}, remainder encode "
          f"{rem_enc[0]:.4f} / decode {rem_dec[0]:.4f}; yardsticks (a copy "
          f"of the rows, not the same function): cf {yard[0][0]:.4f} / "
          f"{yard[0][1]:.4f}, remainder {yard[1][0]:.4f} / {yard[1][1]:.4f}")
    for line in ptxas_lines(kernels.BUILD_LOG, (
            "bfp_encode_kernel", "bfp_decode_kernel", "invert_rank_kernel")):
        phase("phase 3 K2/K3 ptxas " + line)
    # K2/K3 rows: the cf and the remainder stream of the main path together.
    # Operations: ~250 lane operations per 32-symbol block for u16 rows
    # (pairing, the 16x16 butterfly, one store a plane), ~500 for u32.
    # Bytes: each input once and each output once; K3 reads only the
    # residual words the data holds (cnt per plane and slot), not the
    # whole band buffer.
    ops2 = sum(a[0].numel() // 32 * (250 if a[0].dtype == torch.int16
                                     else 500) for a in k2_io[0::2])
    k3_bytes = sum(
        tensor_bytes(a[0], *a[2:7], out) + 4 * a[10] * int(a[6].sum())
        for a, out in zip(k3_io[0::2], k3_io[1::2]))
    report("bfp_encode", 0.0, cf_enc[0] + rem_enc[0], cf_enc[1] + rem_enc[1],
           tensor_bytes(k2_io), ops2)
    report("bfp_decode", 0.0, cf_dec[0] + rem_dec[0], cf_dec[1] + rem_dec[1],
           k3_bytes, ops2)
    del k2_io, k3_io
    del pay, cw, rem, out_k, out_p, back_k, back_p, prow
    torch.cuda.empty_cache()

    # K10/K11, the fused transform+pack pair: base, resid, cw, rem and the
    # field back bit-equal to the plain versions
    def check_v3(v, nl, K, E, q):
        inv_q, qf = HL._inv_q(q), HL._f32(q)
        k = Hy.local_transform_pack_v3(v, inv_q, nl, K, E)
        p = Hy.transform_pack_v3(v, inv_q, nl, K, E)
        bad = [n for n, a, b in zip(("base", "resid", "cw", "rem"), k, p)
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"K10 differs from plain in {bad} at "
                                 f"{tuple(v.shape)} nl={nl} K={K} E={E}")
        del p
        crl = (k[2] - K).clamp(0, E).to(torch.int32)
        oi = Hy.unpack_inverse_v3(k[0], crl, k[1], k[3], qf, nl, K, E,
                                  tuple(v.shape))
        op = Hy.unpack_inverse_v3_plain(k[0], crl, k[1], k[3], qf, nl, K, E,
                                        tuple(v.shape))
        if not torch.equal(oi, op):
            raise AssertionError(f"K11 differs from plain at {tuple(v.shape)}"
                                 f" nl={nl} K={K} E={E}: {max_abs(oi, op)}")
        return k, crl, oi

    for shp in ((8, 128, 128), (16, 256, 256), (8, 128, 768), (8, 128, 1024)):
        vs = torch.from_numpy(
            (gen.standard_normal(shp) * 0.02).astype(np.float32)).to(dev)
        for K3, E3, nl in ((1, 15, 3), (8, 8, 3), (8, 8, 2), (3, 8, 1)):
            k, _, oi = check_v3(vs, nl, K3, E3, 1e-3)
            if int(k[2].max()) > K3 + E3 or \
                    float((oi - vs).abs().max()) > 1e-3 * (nl + 2):
                raise AssertionError(f"K10/K11 round trip at {shp} K={K3} "
                                     f"E={E3}: cw max {int(k[2].max())}")
    vs = torch.from_numpy(
        (gen.standard_normal((16, 256, 256)) * 0.02).astype(np.float32))
    clean = check_v3(vs.to(dev), 3, 8, 8, 1e-3)[0][2]
    vs[9, 130, 77] = 40.0  # tile (gx, gy) = (1, 1): superblock 3 of 4
    cw_over = check_v3(vs.to(dev), 3, 8, 8, 1e-3)[0][2]
    if not (bool((cw_over[3] == 32).all())
            and torch.equal(cw_over[:3], clean[:3])):
        raise AssertionError("K10: a code over 16 bits must set its tile's "
                             "1024 widths to 32 and leave the others")
    # K11's crl guard: random words wherever a sorted column's chunk has
    # crl <= the residual plane (a deserialized resid need not hold zeros
    # there) leave the field unchanged
    vs = torch.from_numpy(
        (gen.standard_normal((16, 256, 256)) * 0.02).astype(np.float32))
    (kb, kr, _, krem), crl, oi = check_v3(vs.to(dev), 1, 3, 8, 1e-3)
    scrl = crl.sort(dim=1, descending=True, stable=True).values
    dead = (scrl[:, None, None, :] <= torch.arange(8, device=dev)[
        None, :, None, None]).expand(crl.shape[0], 8, kb.shape[2], 1024)
    junk = torch.from_numpy(gen.integers(
        -2**31, 2**31, dead.shape, dtype=np.int64).astype(np.int32)).to(dev)
    rg = torch.where(dead, junk, kr.view(dead.shape)).view(kr.shape)
    args = (kb, crl, rg, krem, HL._f32(1e-3), 1, 3, 8, (16, 256, 256))
    og = Hy.unpack_inverse_v3(*args)
    if not (0 < int(dead.sum()) < dead.numel() and torch.equal(og, oi)
            and torch.equal(og, Hy.unpack_inverse_v3_plain(*args))):
        raise AssertionError("K11: words above a chunk's width changed the "
                             f"field ({int(dead.sum())} of {dead.numel()} "
                             "residual words random)")
    phase("phase 3 small K10/K11 at (8,128,128), (16,256,256), (8,128,768), "
          "(8,128,1024) with (K, E, nl) = (1,15,3), (8,8,3), (8,8,2), "
          "(3,8,1): equal to plain; one value over the u16 budget sets its "
          "tile's widths to 32 only; K11 with random residual words above "
          f"every chunk's width ({int(dead.sum())} of {dead.numel()}) equal "
          "to plain and to the field of the clean words")
    del kb, kr, krem, crl, oi, rg, og, junk, dead, scrl
    for line in ptxas_lines(kernels.BUILD_LOG, ("v3_pack_kernel",
                                                "v3_unpack_kernel")):
        phase("phase 3 K10/K11 ptxas " + line)
    phase("phase 3 K10/K11 clusters of 16 blocks the card holds at once "
          "(cudaOccupancyMaxActiveClusters, K10 / K11): " + ", ".join(
              "Z={} {} / {}".format(z, *Hy.v3_max_active_clusters(z))
              for z in (128, 256, 512, 768, 1024)))
    k, crl3, oi = check_v3(v, 3, K, E, q)
    if float((oi - v).abs().max()) > TOL:
        raise AssertionError("K10/K11 round trip at 512^3 breaks the bound")
    inv_q, qf = HL._inv_q(q), HL._f32(q)
    # operations: the front end's, plus the packer's as counted for K2/K3
    ops3 = (OPS_PER_ELEM["hybrid_pack_v3"] + 8) * v.numel() + \
        96 * tensor_bytes(k[0], k[1]) // 4
    report("hybrid_pack_v3", 0.0,
           time_ms(lambda: Hy.local_transform_pack_v3(v, inv_q, 3, K, E)),
           time_ms(lambda: Hy.transform_pack_v3(v, inv_q, 3, K, E), 2),
           tensor_bytes(v, k), ops3)
    # K11 reads a residual word only where the chunk's crl is over its
    # plane: C words for each of its crl planes, not the whole buffer
    report("hybrid_unpack_v3", 0.0,
           time_ms(lambda: Hy.unpack_inverse_v3(k[0], crl3, k[1], k[3], qf, 3,
                                                K, E, padded)),
           time_ms(lambda: Hy.unpack_inverse_v3_plain(
               k[0], crl3, k[1], k[3], qf, 3, K, E, padded), 2),
           tensor_bytes(k[0], crl3, k[3], oi)
           + 4 * k[0].shape[2] * int(crl3.sum()), ops3)
    # yardsticks that move about the same bytes (not the same function)
    half = v.to(torch.float16)
    cast_f = time_ms(lambda: v.to(torch.float16))
    cast_i = time_ms(lambda: half.to(torch.float32))
    del half
    (b10, t10), (b11, t11) = K10_K11_BEFORE
    ms10, ms11 = rows["hybrid_pack_v3"]["ms"], rows["hybrid_unpack_v3"]["ms"]
    phase(f"phase 3 K10/K11 at 512^3, K={K} E={E}: equal to plain; K10 "
          f"{ms10:.4f} ms against K1 + K2 (cf) "
          f"{rows['hybrid_fwd_v2']['ms'] + cf_enc[0]:.4f} ms, K11 "
          f"{ms11:.4f} ms against K3 (cf) + K4 "
          f"{cf_dec[0] + rows['hybrid_inv_v2']['ms']:.4f} ms; yardsticks: "
          f"PyTorch's float32 -> float16 cast of the field {cast_f:.4f} ms, "
          f"float16 -> float32 {cast_i:.4f} ms; the three-kernel design "
          f"{b10}-{t10} / {b11}-{t11} ms (PERF.md): "
          f"{b10 / ms10:.4f}-{t10 / ms10:.4f}x / "
          f"{b11 / ms11:.4f}-{t11 / ms11:.4f}x faster")
    del k, crl3, oi, clean, cw_over
    torch.cuda.empty_cache()

    # K7/K8, the flag-0 front end: bit-equal to the plain versions
    def check_flag0(v, nl, q, timed):
        inv_q, qf = HL._inv_q(q), HL._f32(q)
        sk, rk = Hy.local_transform_fused(v, inv_q, nl)
        sp, rp = Hy.local_transform(v, inv_q, nl)
        if not (torch.equal(sk, sp) and torch.equal(rk, rp)):
            raise AssertionError(
                f"K7 differs from plain at {tuple(v.shape)} nl={nl}: "
                f"{max(max_abs(sk, sp), max_abs(rk, rp))}")
        ok = Hy.local_inverse_fused(sk, rk, qf, nl)
        op = Hy.local_inverse(sk, rk, qf, nl)
        if not torch.equal(ok, op):
            raise AssertionError(f"K8 differs from plain at {tuple(v.shape)}"
                                 f" nl={nl}: {max_abs(ok, op)}")
        if not timed:
            return None
        return (time_ms(lambda: Hy.local_transform_fused(v, inv_q, nl)),
                time_ms(lambda: Hy.local_transform(v, inv_q, nl), 2),
                time_ms(lambda: Hy.local_inverse_fused(sk, rk, qf, nl)),
                time_ms(lambda: Hy.local_inverse(sk, rk, qf, nl), 2),
                tensor_bytes(v, sk, rk), tensor_bytes(sk, rk, ok))

    # 2D groups of eight y-blocks (Y/8 = 9: a partial group), a ragged
    # last tile of 8 z-blocks (Z/8 = 25, 17), and z walks split into
    # segments ((8, 1024), (8, 8, 65536): one group, one column)
    small0 = ((64, 256), (16, 16, 128), (64, 200), (24, 40, 56), (8, 1024),
              (40, 16, 136), (8, 8, 65536), (72, 8192))
    for shp in small0:
        vs = torch.from_numpy(gen.standard_normal(shp).astype(np.float32))
        for nl in (1, 2, 3):
            check_flag0(vs.to(dev), nl, 1e-3, timed=False)
    phase("phase 3 small K7/K8 at " + ", ".join(
        "(" + ",".join(map(str, s)) + ")" for s in small0)
        + ", nl 1-3: equal to plain")
    # the kernels load and store 16-byte vectors: a view one element off is
    # refused (not run, no fallback), and the API hands K7 an aligned copy
    vs = torch.from_numpy(gen.standard_normal((64, 64, 128)).astype(
        np.float32)).to(dev)
    buf = torch.empty(vs.numel() + 4, device=dev)
    off = buf[1:1 + vs.numel()].view(vs.shape)
    off.copy_(vs)
    sym_off = buf.view(torch.int32)[1:1 + vs.numel()].view(vs.shape)
    for name, fn in (
            ("K7", lambda: Hy.local_transform_fused(off, 1e3, 3)),
            ("K8", lambda: Hy.local_inverse_fused(
                sym_off, torch.zeros(Hy.remainder_shape(vs.shape, 3),
                                     device=dev), 1e-3, 3))):
        try:
            fn()
        except RuntimeError as e:
            if "misaligned" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on a misaligned view")
    bcfg0 = M.Config()
    bcfg0.lossless = M.lossless_type.BFX
    blob0, st0 = M.compress(off, 1e-3, s=math.inf,
                            mode=M.error_bound_type.ABS, config=bcfg0)
    back0 = M.decompress(blob0, device=dev)[0]
    if st0 != M.compress_status_type.Success or \
            float((back0 - vs).abs().max()) > 1e-3:
        raise AssertionError("Hybrid+BFX of a misaligned view failed")
    phase("phase 3 K7/K8 alignment: views one element off raise "
          "(misaligned address); compress of such a view (Hybrid+BFX) "
          "holds its bound")
    del buf, off, sym_off, back0
    for line in ptxas_lines(kernels.BUILD_LOG, ("flag0_fwd_kernel",
                                                "flag0_inv_kernel")):
        phase("phase 3 K7/K8 ptxas " + line)
    t3 = check_flag0(v, 3, q, timed=True)
    report("hybrid_fwd", 0.0, t3[0], t3[1], t3[4],
           OPS_PER_ELEM["hybrid_fwd"] * v.numel())
    report("hybrid_inv", 0.0, t3[2], t3[3], t3[5],
           OPS_PER_ELEM["hybrid_inv"] * v.numel())
    # num_local_refactoring_level is the caller's: at nl 1 a block holds 125
    # corners, at nl 3 eight
    for nl in (1, 2):
        sk, rk = Hy.local_transform_fused(v, inv_q, nl)
        check_flag0(v, nl, q, timed=False)
        fwd = time_ms(lambda: Hy.local_transform_fused(v, inv_q, nl))
        inv = time_ms(lambda: Hy.local_inverse_fused(sk, rk, HL._f32(q), nl))
        phase(f"phase 3 K7/K8 at 512^3, nl={nl}: equal to plain; K7 "
              f"{fwd:.4f} ms, K8 {inv:.4f} ms (bound "
              f"{bound(tensor_bytes(v, sk, rk), 0)[0]:.4f})")
    # yardsticks that move the same bytes (not the same function), and the
    # copies around K7 on the Hybrid+BFX compress (highlevel's z-class
    # grouping and the concatenation with the remainder's symbols)
    sk, rk = Hy.local_transform_fused(v, inv_q, 3)
    rsym = Hy.quantize(decompose(rk, rem_hier), inv_q)
    cast_f = time_ms(lambda: v.to(torch.int32))
    cast_i = time_ms(lambda: sk.to(torch.float32))
    grp = Hy.zclass_group(sk)
    t_grp = time_ms(lambda: Hy.zclass_group(sk))
    t_cat = time_ms(lambda: torch.cat([grp.reshape(-1), rsym.reshape(-1)]))
    b7, b8 = K7_K8_BEFORE
    ms7, ms8 = rows["hybrid_fwd"]["ms"], rows["hybrid_inv"]["ms"]
    phase(f"phase 3 K7/K8 at 512^3, nl=3: K7 {ms7:.4f} ms, K8 {ms8:.4f} ms "
          f"(bound {rows['hybrid_fwd']['bound_ms']:.4f}); yardsticks: "
          f"PyTorch's float32 -> int32 cast of the field {cast_f:.4f} ms, "
          f"int32 -> float32 of the symbols {cast_i:.4f} ms; around K7 on "
          f"the Hybrid+BFX compress: zclass_group {t_grp:.4f} ms, torch.cat "
          f"{t_cat:.4f} ms; the shared-tile design {b7[0]}-{b7[1]} / "
          f"{b8[0]}-{b8[1]} ms (PERF.md): {b7[0] / ms7:.4f}-"
          f"{b7[1] / ms7:.4f}x / {b8[0] / ms8:.4f}-{b8[1] / ms8:.4f}x faster")
    del sk, rk, rsym, grp
    x2 = torch.linspace(0.0, 1.0, 8192, device=dev)
    v2d = torch.sin(6 * np.pi * x2[:, None]) * torch.cos(5 * np.pi * x2[None])
    t2 = check_flag0(v2d, 3, q, timed=True)
    phase(f"phase 3 K7/K8 at 8192^2: equal to plain; K7 {t2[0]:.4f} ms "
          f"(plain {t2[1]:.4f}, bound "
          f"{bound(t2[4], OPS_PER_ELEM['hybrid_fwd'] * v2d.numel())[0]:.4f}"
          f"), K8 {t2[2]:.4f} ms (plain {t2[3]:.4f}, bound "
          f"{bound(t2[5], OPS_PER_ELEM['hybrid_inv'] * v2d.numel())[0]:.4f}"
          "); the shared-tile design {}-{} / {}-{} ms (PERF.md)".format(
              *K7_K8_BEFORE_8192[0], *K7_K8_BEFORE_8192[1]))
    del v2d
    torch.cuda.empty_cache()

    # K5/K6, the BFX codec: words, widths and total equal to the plain merge
    # tree's; symbols back equal to the split tree's and to the input
    def check_bfx(sym, sb, align, timed, reps=5):
        ko = X.encode_core(sym, sb, align)
        po = X.encode_core_plain(sym, sb, align)
        T = int(ko[2])
        if T != int(po[2]) or not torch.equal(ko[1], po[1]) or \
                not torch.equal(ko[0][:T], po[0][:T]):
            raise AssertionError(f"K5 differs from plain: n={sym.numel()} "
                                 f"sb={sb} align={align}")
        words, widths = ko[0][:T], ko[1]
        del po
        dk = X.decode_core(words, widths, sb, align)
        dp = X.decode_core_plain(words, widths, sb, align)
        if not (torch.equal(dk, dp) and torch.equal(dk, sym)):
            raise AssertionError(f"K6 differs: n={sym.numel()} sb={sb}")
        del dp
        if not timed:
            return T, None
        return T, (time_ms(lambda: X.encode_core(sym, sb, align), reps),
                   time_ms(lambda: X.encode_core_plain(sym, sb, align), 1),
                   time_ms(lambda: X.decode_core(words, widths, sb, align),
                           reps),
                   time_ms(lambda: X.decode_core_plain(words, widths, sb,
                                                        align), 1))

    for n, sb, align, wide in ((256 * 32 * 4, 256, 1, False),
                               (256 * 32 * 2, 256, 1, True),
                               (4096 * 32 * 2, 4096, 1024, True)):
        sm = torch.from_numpy(mixed_symbols(n, gen, wide)).to(dev)
        check_bfx(sm, sb, align, timed=False)
        if sb == X.SB_BLOCKS_SMALL:  # the bytes API picks this geometry
            blob_d = X.encode(sm)
            if blob_d != X.encode(sm.cpu()) or \
                    not torch.equal(X.decode(blob_d, 0, dev)[0], sm):
                raise AssertionError("BFX blob written on the card differs "
                                     "from the CPU's")
    # 32-bit superblocks after one of a single word (align=1): each slot of
    # a round stages 32 words at quad phase 1
    odd = mixed_symbols(4096 * 32 * 3, gen, wide=True)
    odd[::32] = -2**31
    odd[:4096 * 32] = 0
    odd[0] = -1
    check_bfx(torch.from_numpy(odd).to(dev), 4096, 1, timed=False)
    phase("phase 3 small K5/K6: mixed widths at sb=256/align=1, 32-bit-wide "
          "blocks at sb=256/align=1 and sb=4096/align=1024, 32-bit "
          "superblocks at odd offsets (sb=4096/align=1): words and "
          "symbols equal to plain; card and CPU blobs equal at sb=256")
    sym = HL._compress_core_hybrid(v, q, padded, 3, rem_hier, True)
    sb = X._choose_sb(sym.numel(), dev)
    if sb != X.SB_BLOCKS or sym.numel() % (sb * 32):
        raise AssertionError(f"512^3 BFX stream: sb={sb}, n={sym.numel()}")
    T, t5 = check_bfx(sym, sb, X.ALIGN, timed=True)
    # bytes: the symbols, the T stream words and one width byte per block;
    # operations ~8 per symbol plus ~3 lane operations per bit written
    bfx_moved = sym.numel() * 4 + 4 * T + sym.numel() // 32
    bfx_ops = 8 * sym.numel() + 96 * T
    report("bfx_encode", 0.0, t5[0], t5[1], bfx_moved, bfx_ops)
    report("bfx_decode", 0.0, t5[2], t5[3], bfx_moved, bfx_ops)
    phase(f"phase 3 K5/K6 on the 512^3 Hybrid+BFX stream: "
          f"{sym.numel()} symbols, sb={sb}, align={X.ALIGN}, {T} words")
    # yardsticks that move about the same bytes (not the same function):
    # 4 bytes read and 1 written a symbol, and back
    cast_5 = time_ms(lambda: sym.to(torch.uint8))
    u8 = sym.to(torch.uint8)
    cast_6 = time_ms(lambda: u8.to(torch.int32))
    del u8
    for line in ptxas_lines(kernels.BUILD_LOG, ("bfx_encode_kernel",
                                                "bfx_decode_kernel")):
        phase("phase 3 K5/K6 ptxas " + line)
    ms5, ms6 = rows["bfx_encode"]["ms"], rows["bfx_decode"]["ms"]
    b5, b6 = K5_K6_BEFORE
    phase(f"phase 3 K5/K6 at 512^3: K5 {ms5:.4f} ms, K6 {ms6:.4f} ms (bound "
          f"{rows['bfx_encode']['bound_ms']:.4f}); yardsticks: PyTorch's "
          f"int32 -> uint8 cast of the symbols {cast_5:.4f} ms, uint8 -> "
          f"int32 {cast_6:.4f} ms; the first design {b5[0]}-{b5[1]} / "
          f"{b6[0]}-{b6[1]} ms (PERF.md): {b5[0] / ms5:.4f}-"
          f"{b5[1] / ms5:.4f}x / {b6[0] / ms6:.4f}-{b6[1] / ms6:.4f}x faster")
    del sym
    torch.cuda.empty_cache()

    # small streams, ruled by launches: a remainder of 8192 symbols at
    # sb=256/align=1; and a stream of 32-bit blocks at sb=4096 (every block
    # stages as many words as it read)
    s256 = torch.from_numpy(mixed_symbols(8192, gen)).to(dev)
    T256, t256 = check_bfx(s256, 256, 1, timed=True, reps=50)
    wide = mixed_symbols(4096 * 32 * 12, gen, wide=True)
    wide[::32] = -2**31
    wide = torch.from_numpy(wide).to(dev)
    Tw, tw = check_bfx(wide, 4096, X.ALIGN, timed=True, reps=50)
    if Tw != wide.numel():
        raise AssertionError(f"32-bit blocks: {Tw} words, not {wide.numel()}")
    bw = bound(tensor_bytes(wide) * 2 + wide.numel() // 32, 0)[0]
    phase(f"phase 3 K5/K6 small: 8192 symbols at sb=256/align=1 ({T256} "
          f"words): K5 {t256[0]:.4f} ms, K6 {t256[2]:.4f} ms (CUDA-event "
          f"means of 50 wrapper calls); 32-bit blocks, "
          f"{wide.numel()} symbols at sb=4096/align={X.ALIGN}: K5 "
          f"{tw[0]:.4f} ms, K6 {tw[2]:.4f} ms (bound {bw:.4f})")
    # the kernels load and store 16-byte vectors: a view one element off is
    # refused (not run, no fallback); the bytes API copies such a view
    bufx = torch.zeros(8192 + 4, dtype=torch.int32, device=dev)
    offx = bufx[1:1 + 8192]
    offx.copy_(s256)
    w256 = X.encode_core(s256, 256, 1)[1]
    for name, fn in (("K5", lambda: X.encode_core(offx, 256, 1)),
                     ("K6", lambda: X.decode_core(bufx[1:1 + T256], w256,
                                                  256, 1))):
        try:
            fn()
        except RuntimeError as e:
            if "misaligned" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on a misaligned view")
    if X.encode(offx) != X.encode(s256):
        raise AssertionError("BFX blob of a misaligned view differs")
    phase("phase 3 K5/K6 alignment: views one element off raise "
          "(misaligned address); the bytes API encodes such a view as the "
          "aligned one")
    del s256, wide, bufx, offx

    # K9, the MDR bitplane encoder: planes, the level exponent and the max
    # partials equal to the plain version's; the finished err_sq table
    # within relative 1e-6 (float32 square sums in another order)
    def check_k9(v2d, bits, what):
        exp = BP._level_exp(v2d.abs().max().double())
        exp_cpu = BP._level_exp(v2d.abs().max().double().cpu())
        kp, ke, ks = BP.encode_core(v2d, exp, bits)
        pp, pe, ps = BP.encode_core_plain(v2d, exp, bits)
        kq = BP._finish_tables(ke, ks)[1]
        pq = BP._finish_tables(pe, ps)[1]
        rel = float(((kq - pq).abs() / pq.clamp_min(1e-300)).max())
        if not (int(exp) == int(exp_cpu) and torch.equal(kp, pp)
                and torch.equal(ke, pe) and rel <= 1e-6):
            raise AssertionError(
                f"K9 differs from plain on {what} B={bits}: planes "
                f"{torch.equal(kp, pp)}, emax {torch.equal(ke, pe)}, err_sq "
                f"rel {rel}, exp {int(exp)}/{int(exp_cpu)}")
        return exp, rel

    worst = 0.0
    for m, bits in ((2048, 8), (2048, 16), (2048, 32), (4096, 8), (4096, 16),
                 (4096, 32)):
        lv = torch.from_numpy((gen.standard_normal(32 * m) * 10.0 ** gen
                               .integers(-4, 3, 32 * m)).astype(np.float32))
        worst = max(worst, check_k9(lv.to(dev).reshape(32, m), bits, m)[1])
    special = np.zeros(32 * 4096, np.float32)
    special[:12] = [0.0, -0.0, 1e-38, -1e-38, 1e30, -1e30, 1e-45, -1e-45,
                    3e-41, -7e-40, 1.0, -2.0]
    special[12:] = gen.standard_normal(special.size - 12) * 1e-3
    for bits in (16, 32):
        worst = max(worst, check_k9(torch.from_numpy(special).to(dev)
                                    .reshape(32, 4096), bits, "specials")[1])
        check_k9(torch.zeros((32, 2048), device=dev), bits, "zeros")
    phase(f"phase 3 small K9: one and two tiles at B 8/16/32, an all-zero "
          f"level, +-0/1e-38/1e30/subnormals: planes, exp and err_max equal "
          f"to plain, err_sq rel <= {worst:.3e}")
    v384 = bench_field(N_MDR, dev)
    h384 = get_hierarchy((N_MDR,) * 3, np.float32, None, cfg)
    lvl = BP.pad_stream(MC.interleave_level(decompose(v384, h384), h384,
                                            h384.l_target)).contiguous()
    if lvl.numel() != 49_479_680:
        raise AssertionError(f"384^3 finest level pads to {lvl.numel()}")
    v2d = lvl.reshape(32, -1)
    exp9, rel9 = check_k9(v2d, 32, "384^3 finest level")
    k9_out = BP.encode_core(v2d, exp9, 32)
    report("bitplane_encode", 0.0,
           time_ms(lambda: BP.encode_core(v2d, exp9, 32)),
           time_ms(lambda: BP.encode_core_plain(v2d, exp9, 32), 1),
           tensor_bytes(v2d, k9_out),
           # per element: ~35 lane operations to quantize and transpose,
           # then 11 per table entry (mask, subtract, compare, select,
           # subtract, convert, add, abs, max, multiply, add): the count of
           # K9's first design, kept as the yardstick so that every design
           # is held to one bound (the present kernel issues fewer:
           # scripts/h100_bitplane_variants.py counts them)
           v2d.numel() * (35 + 11 * 33))
    phase(f"phase 3 K9 on the 384^3 field's finest level: "
          f"{v2d.numel()} elements, B=32, exp {int(exp9)}: planes and "
          f"err_max equal to plain, err_sq rel {rel9:.3e}")
    # K5/K6 on one of its planes as MDR's bfx level compressor packs it
    # (encode_device's padding to whole superblocks of 4096 blocks)
    plane = k9_out[0][MDR_PLANE]
    psb = X._choose_sb(plane.numel(), dev)
    psym = torch.cat([plane, plane.new_zeros(X._pad_to(plane.numel(), psb)
                                             - plane.numel())])
    Tp, tp = check_bfx(psym, psb, X.ALIGN, timed=True, reps=50)
    bp = bound(tensor_bytes(psym) + 4 * Tp + psym.numel() // 32, 0)[0]
    phase(f"phase 3 K5/K6 on MDR plane {MDR_PLANE} of the 384^3 finest "
          f"level: {plane.numel()} words padded to {psym.numel()} symbols, "
          f"sb={psb} ({psym.numel() // (psb * 32)} superblocks), "
          f"align={X.ALIGN}, {Tp} stream words: equal to plain; K5 "
          f"{tp[0]:.4f} ms, K6 {tp[2]:.4f} ms (bound {bp:.4f})")
    del plane, psym
    # K9's launches on one MDRefactor: every level the kernel takes, each
    # timed with its own bound (the row above is the finest level's)
    dec384 = decompose(v384, h384)
    k9_levels, k9_planes = [], []
    for lv_i in range(h384.l_target, -1, -1):
        lv = BP.pad_stream(MC.interleave_level(dec384, h384, lv_i))
        if not BP._use_kernel(lv.numel(), lv.dtype, 32):
            continue
        lv2 = lv.contiguous().reshape(32, -1)
        e9 = BP._level_exp(lv2.abs().max().double())
        k9_planes.append(BP.encode_core(lv2, e9, 32)[0])
        b9 = bound(tensor_bytes(lv2, k9_planes[-1]),
                   lv2.numel() * (35 + 11 * 33))
        k9_levels.append((lv_i, lv2.numel(),
                          graph_ms(lambda: BP.encode_core(lv2, e9, 32)), *b9))
    # K5 on every plane that MDR's bfx level compressor packs on the card
    # (planes of at least PLANE_BFX_MIN_WORDS words), dispatched back to
    # back as MDRefactor dispatches them
    bfx_rows = [pl[p] for pl in k9_planes for p in range(pl.shape[0])
                if pl.shape[1] >= MA.PLANE_BFX_MIN_WORDS]
    n5 = kernels.LAUNCHES["bfx_encode"]
    t5_mdr = time_ms(lambda: [X.encode_device(r) for r in bfx_rows], 3)
    n5 = (kernels.LAUNCHES["bfx_encode"] - n5) // 4
    phase(f"phase 3 K9 per MDRefactor at {N_MDR}^3: {len(k9_levels)} "
          f"launches, {sum(r[2] for r in k9_levels):.4f} ms (device time, "
          f"20 calls a level in a CUDA graph) against a bound "
          f"of {sum(r[3] for r in k9_levels):.4f} ms; per level (level, "
          f"elements, ms, bound ms, by): " + "; ".join(
              f"{r[0]}, {r[1]}, {r[2]:.4f}, {r[3]:.4f}, {r[4]}"
              for r in k9_levels))
    rows["bitplane_encode"]["levels"] = [
        dict(level=r[0], elements=r[1], ms=r[2], bound_ms=r[3])
        for r in k9_levels]
    b5_mdr = bound(sum(tensor_bytes(r) * 2 + r.numel() // 32
                       for r in bfx_rows), 0)[0]
    phase(f"phase 3 K5 per MDRefactor at {N_MDR}^3 with bfx planes: {n5} "
          f"launches on {len(bfx_rows)} planes, {t5_mdr:.4f} ms (CUDA events "
          f"around the dispatch of every plane, as encode_device runs it; "
          f"mean of 3), against a bound of at most {b5_mdr:.4f} ms")
    if n5 != len(bfx_rows):
        raise AssertionError(f"K5 launched {n5} times on {len(bfx_rows)} "
                             f"planes")
    del v384, lvl, v2d, k9_out, dec384, lv, lv2, k9_planes, bfx_rows
    torch.cuda.empty_cache()
    k14_phase(dev, kernels, rows, v)

    # -- 4. the main path ------------------------------------------------
    nbytes = v.numel() * 4
    B._K_CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    from mgard_tpu_torch.utils import trace

    wire0 = trace.counters()
    t0 = time.perf_counter()
    blob, st = M.compress(v, TOL, s=math.inf, mode=M.error_bound_type.ABS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wire_mid = trace.counters()
    out, st2 = M.decompress(blob, device=dev)
    torch.cuda.synchronize()
    tc, td = t1 - t0, time.perf_counter() - t1
    launches_main = dict(kernels.LAUNCHES)
    wire1 = trace.counters()
    staged_main = staging_line(wire0, wire_mid, wire1, trace)
    wire = [wire1.get(k, 0) - wire0.get(k, 0)
            for k in ("bfp.wire.device", "bfp.wire.host")]
    # every BFP blob of the main path (the cf stream and the remainder) is
    # compacted and expanded on the card, none on the host
    if wire != [launches_main["bfp_compact"] + launches_main["bfp_expand"],
                0] or launches_main["bfp_compact"] != 2:
        raise AssertionError(f"main path: BFP blobs on the card / host "
                             f"{wire}, launches {launches_main}")
    peak = torch.cuda.max_memory_allocated(dev)
    if st != M.compress_status_type.Success or \
            st2 != M.compress_status_type.Success:
        raise AssertionError(f"status {st} / {st2}")
    from mgard_tpu_torch.formats.metadata import Metadata

    flag = blob[Metadata.deserialize(blob)[1] + 8 + len(HL._EMPTY_OUTLIERS)]
    if flag != 1:
        raise AssertionError(f"main path wrote flag {flag}, expected 1")
    missing = [k for k in MAIN_PATH if launches_main[k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing} ({launches_main})")
    # the remainder's transform: K14, one launch a level each way
    rem_levels = get_hierarchy(Hy.remainder_shape(
        Hy.pad_to8(v.shape), cfg.num_local_refactoring_level), np.float32,
        None, cfg).l_target
    if (launches_main["multidim_decompose"], launches_main[
            "multidim_recompose"]) != (rem_levels, rem_levels):
        raise AssertionError(f"main path: K14 launches {launches_main}, "
                             f"want {rem_levels} each way")
    err = float((out - v).abs().max())
    if not (torch.isfinite(out).all() and tuple(out.shape) == tuple(v.shape)
            and err <= TOL):
        raise AssertionError(f"main path: L-inf {err} > {TOL} or bad output")
    main_ms = (tc * 1e3, td * 1e3)
    phase(f"phase 4 main path {N_MAIN}^3 f32 tol={TOL}: flag 1, ratio "
          f"{nbytes / len(blob):.4f}, L-inf {err:.3e}; compress "
          f"{tc * 1e3:.1f} ms ({nbytes / tc / 1e9:.3f} GB/s), decompress "
          f"{td * 1e3:.1f} ms ({nbytes / td / 1e9:.3f} GB/s) [one call]; "
          f"peak device memory {peak / 2**30:.3f} GiB; BFP blobs with "
          f"the wire on the card / host {wire}; launches {launches_main}; "
          f"{staged_main}")
    del out

    # -- 5. Hybrid+BFX ---------------------------------------------------
    bcfg = M.Config()
    bcfg.lossless = M.lossless_type.BFX
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    times = []
    for _rep in range(3):
        c0 = trace.counters()
        t0 = time.perf_counter()
        blob, st = M.compress(v, TOL, s=math.inf, mode=M.error_bound_type.ABS,
                              config=bcfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c1 = trace.counters()
        out, st2 = M.decompress(blob, device=dev)
        torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
    staged_bfx = staging_line(c0, c1, trace.counters(), trace)
    launches_bfx = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if st != M.compress_status_type.Success or \
            st2 != M.compress_status_type.Success:
        raise AssertionError(f"Hybrid+BFX status {st} / {st2}")
    head = section_head(blob)
    if head != (0, int(M.lossless_type.BFX), (X.SB_BLOCKS, X.ALIGN)):
        raise AssertionError(f"Hybrid+BFX stream: (flag, backend, geometry) "
                             f"{head}")
    missing = [k for k in BFX_PATH if launches_bfx[k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on Hybrid+BFX: {missing} "
                             f"({launches_bfx})")
    err = float((out - v).abs().max())
    if not (torch.isfinite(out).all() and tuple(out.shape) == tuple(v.shape)
            and err <= TOL):
        raise AssertionError(f"Hybrid+BFX: L-inf {err} > {TOL} or bad output")
    tc = min(t[0] for t in times)
    td = min(t[1] for t in times)
    phase(f"phase 5 Hybrid+BFX {N_MAIN}^3 f32 tol={TOL}: flag 0, one BFX "
          f"section (sb={X.SB_BLOCKS}, align={X.ALIGN}), ratio "
          f"{nbytes / len(blob):.4f}, L-inf {err:.3e}; compress "
          f"{tc * 1e3:.1f} ms ({nbytes / tc / 1e9:.3f} GB/s), decompress "
          f"{td * 1e3:.1f} ms ({nbytes / td / 1e9:.3f} GB/s) [one call]; "
          f"peak device memory {peak / 2**30:.3f} GiB; launches "
          f"{launches_bfx}; {staged_bfx} (the last call)")
    del out, v, blob
    torch.cuda.empty_cache()

    # -- 6. the main path at 128^3: its remainder rides BFX --------------
    v128 = bench_field(128, dev)
    kernels.reset_launches()
    blob, st = M.compress(v128, TOL)
    out, st2 = M.decompress(blob, device=dev)
    torch.cuda.synchronize()
    launches_small = dict(kernels.LAUNCHES)
    head = section_head(blob)
    err = float((out - v128).abs().max())
    missing = [k for k in SMALL_MAIN_PATH if launches_small[k] < 1]
    if st or st2 or head[:2] != (1, int(M.lossless_type.BFX)) or \
            not err <= TOL or missing:
        raise AssertionError(f"128^3 main path: status {st}/{st2}, (flag, "
                             f"backend, geometry) {head}, L-inf {err}, not "
                             f"launched {missing}")
    phase(f"phase 6 main path 128^3: flag 1, remainder section BFX "
          f"{head[2]}, ratio {v128.numel() * 4 / len(blob):.4f}, L-inf "
          f"{err:.3e}; launches {launches_small}")
    del v128, out

    # -- 7. streams across devices ---------------------------------------
    v2 = bench_field(N_CROSS, dev)
    blob2, st = M.compress(v2, TOL)
    out_gpu, st_g = M.decompress(blob2, device=dev)
    out_cpu, st_c = M.decompress(blob2, device="cpu")
    if st or st_g or st_c:
        raise AssertionError(f"cross-device status {st}/{st_g}/{st_c}")
    ref = v2.cpu()
    e_cpu = float((out_cpu - ref).abs().max())
    e_gpu = float((out_gpu.cpu() - ref).abs().max())
    d = float((out_cpu - out_gpu.cpu()).abs().max())
    # the two decodes differ only by the remainder transform's matmul
    # summation order on each device
    if not (e_cpu <= TOL and e_gpu <= TOL and d <= 1e-5):
        raise AssertionError(f"cross-device: cpu {e_cpu}, gpu {e_gpu}, "
                             f"diff {d}")
    phase(f"phase 7 {N_CROSS}^3 card-written stream: CPU decode L-inf "
          f"{e_cpu:.3e}, card decode {e_gpu:.3e}, CPU vs card {d:.3e} "
          f"(bound 1e-5)")
    # the flag-0 fallback on the card: a pinned K with K+E > 16 leaves the
    # u16 budget, so the stream is one generic BFP section of u32 rows
    cfg0 = M.Config()
    cfg0.bfp_base_planes = 9
    blob0, st = M.compress(v2, TOL, config=cfg0)
    if st or blob0[Metadata.deserialize(blob0)[1] + 8
                   + len(HL._EMPTY_OUTLIERS)] != 0:
        raise AssertionError("flag-0 fallback not taken")
    out0 = M.decompress(blob0, device=dev)[0]
    out0c = M.decompress(blob0, device="cpu")[0]
    e0 = float((out0.cpu() - ref).abs().max())
    d0 = float((out0c - out0.cpu()).abs().max())
    if not (e0 <= TOL and d0 <= 1e-5):
        raise AssertionError(f"flag-0 on the card: L-inf {e0}, CPU vs card "
                             f"{d0}")
    phase(f"phase 7 {N_CROSS}^3 flag-0 fallback (K=9, E=8): card decode "
          f"L-inf {e0:.3e}, CPU vs card {d0:.3e}")
    # Hybrid+BFX both ways: the card writes sb=4096/align=1024, the CPU
    # sb=256/align=1; each decodes on both devices
    for writer, src in (("card", v2), ("CPU", ref)):
        blob_b, st = M.compress(src, TOL, config=bcfg)
        geom = (X.SB_BLOCKS, X.ALIGN) if writer == "card" else \
            (X.SB_BLOCKS_SMALL, 1)
        head = section_head(blob_b)
        if st or head != (0, int(M.lossless_type.BFX), geom):
            raise AssertionError(f"{writer}-written Hybrid+BFX: status {st},"
                                 f" (flag, backend, geometry) {head}")
        ob_g, sg = M.decompress(blob_b, device=dev)
        ob_c, sc = M.decompress(blob_b, device="cpu")
        eb_g = float((ob_g.cpu() - ref).abs().max())
        eb_c = float((ob_c - ref).abs().max())
        db = float((ob_c - ob_g.cpu()).abs().max())
        if sg or sc or not (eb_g <= TOL and eb_c <= TOL and db <= 1e-5):
            raise AssertionError(f"{writer}-written Hybrid+BFX: card L-inf "
                                 f"{eb_g}, CPU {eb_c}, diff {db}")
        phase(f"phase 7 {N_CROSS}^3 Hybrid+BFX written on the {writer} "
              f"(sb, align)={geom}: card decode L-inf {eb_g:.3e}, CPU decode "
              f"{eb_c:.3e}, CPU vs card {db:.3e}")

    # the fused flag-2 path both ways: the first stream of the shape primes
    # the sticky K (flag 1), so each writer's second stream is checked
    fcfg = M.Config()
    fcfg.hybrid_fused_pack = True
    B._K_CACHE.clear()
    for writer, src in (("card", v2), ("CPU", ref)):
        M.compress(src, TOL, config=fcfg)
        blob_f, st = M.compress(src, TOL, config=fcfg)
        if st or section_head(blob_f)[0] != 2 or file_minor(blob_f) != 1:
            raise AssertionError(f"{writer}-written fused stream: status {st},"
                                 f" flag {section_head(blob_f)[0]}, minor "
                                 f"{file_minor(blob_f)}")
        of_g, sg = M.decompress(blob_f, device=dev)
        of_c, sc = M.decompress(blob_f, device="cpu")
        ef_g = float((of_g.cpu() - ref).abs().max())
        ef_c = float((of_c - ref).abs().max())
        df = float((of_c - of_g.cpu()).abs().max())
        if sg or sc or not (ef_g <= TOL and ef_c <= TOL and df <= 1e-5):
            raise AssertionError(f"{writer}-written flag-2 stream: card L-inf "
                                 f"{ef_g}, CPU {ef_c}, diff {df}")
        phase(f"phase 7 {N_CROSS}^3 flag-2 stream written on the {writer}: "
              f"card decode L-inf {ef_g:.3e}, CPU decode {ef_c:.3e}, CPU vs "
              f"card {df:.3e} (bound 1e-5)")

    del v2, ref, out_gpu, out_cpu
    torch.cuda.empty_cache()

    # -- 8. MDR on the 384^3 field ----------------------------------------
    v384 = bench_field(N_MDR, dev)
    mcfg = M.Config()
    raw = v384.numel() * 4
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    meta, data = MDR.MDRefactor(v384, mcfg)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    stored = len(meta.serialize()) + sum(sum(lm.plane_sizes)
                                         for lm in meta.levels)
    recon, prev = [], 0
    for tol in (1e-2, 1e-3, 1e-4):
        counts = MDR.MDRequest(meta, tol)
        meta.prev_used = []
        nbytes = MDR.retrieve_size(meta, counts)
        t0 = time.perf_counter()
        rec = MDR.MDReconstruct(meta, data, counts)
        torch.cuda.synchronize()
        tr = time.perf_counter() - t0
        meta.prev_used = []
        err = float((rec.data - v384).abs().max())
        if not (rec.data.device == v384.device and rec.data.dtype
                == torch.float32 and bool(torch.isfinite(rec.data).all())
                and err <= tol and nbytes > prev):
            # the planner must fetch strictly more for a tighter tolerance
            raise AssertionError(f"MDR 384^3 tol {tol}: L-inf {err}, "
                                 f"retrieve {nbytes} bytes (before {prev})")
        recon.append((tol, nbytes, err, tr, counts))
        prev = nbytes
    launches_mdr = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches_mdr["bitplane_encode"] < 4:
        raise AssertionError(f"K9 launched {launches_mdr['bitplane_encode']}"
                             f" times in one refactor ({launches_mdr})")
    phase(f"phase 8 MDR {N_MDR}^3 f32 B=32 zlib: MDRefactor "
          f"{t_ref * 1e3:.1f} ms ({raw / t_ref / 1e9:.3f} GB/s; one call), "
          f"stored {stored} bytes (ratio {raw / stored:.4f}); peak device "
          f"memory {peak / 2**30:.3f} GiB; K9 launches "
          f"{launches_mdr['bitplane_encode']} in one refactor")
    for tol, nbytes, err, tr, counts in recon:
        phase(f"phase 8 MDReconstruct tol {tol:g}: retrieve {nbytes} of "
              f"{stored} stored bytes (planes per level {counts}), L-inf "
              f"{err:.3e}, "
              f"{tr * 1e3:.1f} ms")
    meta.prev_used = []
    del rec, data

    # -- 9. the bfx level compressor --------------------------------------
    bmcfg = M.Config()
    bmcfg.mdr_level_compressor = "bfx"
    kernels.reset_launches()
    t0 = time.perf_counter()
    meta_b, data_b = MDR.MDRefactor(v384, bmcfg)
    torch.cuda.synchronize()
    tb = time.perf_counter() - t0
    k5 = kernels.LAUNCHES["bfx_encode"]
    counts = MDR.MDRequest(meta_b, 1e-3)
    t0 = time.perf_counter()
    rec = MDR.MDReconstruct(meta_b, data_b, counts)
    torch.cuda.synchronize()
    tbr = time.perf_counter() - t0
    k6 = kernels.LAUNCHES["bfx_decode"]
    err = float((rec.data - v384).abs().max())
    n_bfx = sum(c == MA.PLANE_BFX for lm in meta_b.levels
                for c in lm.plane_raw)
    stored_b = len(meta_b.serialize()) + sum(sum(lm.plane_sizes)
                                             for lm in meta_b.levels)
    if not (k5 >= 1 and k6 >= 1 and n_bfx >= 1 and err <= 1e-3):
        raise AssertionError(f"MDR bfx: K5 {k5}, K6 {k6}, BFX planes "
                             f"{n_bfx}, L-inf {err}")
    fetched = []
    for tol in (1e-2, 1e-3, 1e-4):
        meta_b.prev_used = []
        fetched.append(MDR.retrieve_size(meta_b, MDR.MDRequest(meta_b, tol)))
    meta_b.prev_used = []
    phase(f"phase 9 MDR {N_MDR}^3 bfx planes: MDRefactor {tb * 1e3:.1f} ms, "
          f"{n_bfx} BFX planes, stored {stored_b} bytes (ratio "
          f"{raw / stored_b:.4f}); plane bytes retrieved at tol 1e-2 / 1e-3 "
          f"/ 1e-4: {fetched[0]} / {fetched[1]} / {fetched[2]}; "
          f"MDReconstruct tol 1e-3 {tbr * 1e3:.1f} "
          f"ms, L-inf {err:.3e}; launches K9 "
          f"{kernels.LAUNCHES['bitplane_encode']}, K5 {k5}, K6 {k6}")
    del rec, data_b, meta_b, v384
    torch.cuda.empty_cache()

    # -- 10. MDR across devices at 128^3 ----------------------------------
    v128 = bench_field(N_MDR_SMALL, dev)
    ref = v128.cpu()
    tol = 1e-3
    for writer, src in (("card", v128), ("CPU", ref)):
        meta_x, data_x = MDR.MDRefactor(src, mcfg)
        counts = MDR.MDRequest(meta_x, tol)
        outs = {}
        for where in (dev, torch.device("cpu")):
            rec = MDR.MDReconstruct(meta_x, data_x, counts, device=where)
            outs[where.type] = rec.data.cpu()
        e_c = float((outs["cpu"] - ref).abs().max())
        e_g = float((outs["cuda"] - ref).abs().max())
        d = float((outs["cpu"] - outs["cuda"]).abs().max())
        # one stream, two devices: the decoded levels are bit-equal, the
        # recompose matmuls round in another order
        if not (e_c <= tol and e_g <= tol and d <= 1e-5):
            raise AssertionError(f"MDR {writer}-written stream: CPU L-inf "
                                 f"{e_c}, card {e_g}, diff {d}")
        phase(f"phase 10 MDR {N_MDR_SMALL}^3 stream written on the {writer}: "
              f"CPU reconstruct L-inf {e_c:.3e}, card {e_g:.3e}, CPU vs "
              f"card {d:.3e} (bound 1e-5)")

    # -- 11. QoI (V_TOT) over three 128^3 variables -----------------------
    qcfg = M.Config()
    qcfg.total_num_bitplanes = 24
    variables = [bench_field(N_MDR_SMALL, dev, seed=s) + 1.5
                 for s in (1, 2, 3)]
    pairs = [MDR.MDRefactor(x, qcfg) for x in variables]
    qoi_tol = 1e-2
    t0 = time.perf_counter()
    vrec, vtot, cert, qcounts = MDReconstructQoI(
        [p[0] for p in pairs], [p[1] for p in pairs], qoi_tol)
    torch.cuda.synchronize()
    tq = time.perf_counter() - t0
    actual = float((VTotQoI().eval(variables) - vtot).abs().max())
    if not (cert <= qoi_tol and actual <= cert + 1e-12
            and vtot.device == v128.device):
        raise AssertionError(f"QoI: certified {cert}, actual {actual}, "
                             f"tol {qoi_tol}")
    phase(f"phase 11 MDReconstructQoI V_TOT over 3 x {N_MDR_SMALL}^3: "
          f"certified bound {cert:.3e} <= {qoi_tol}, actual {actual:.3e}, "
          f"{tq * 1e3:.1f} ms, planes per variable "
          f"{[sum(c) for c in qcounts]}")

    del variables, pairs, vrec, vtot, v128
    torch.cuda.empty_cache()

    # -- 12. the fused transform+pack path (flag 2) -----------------------
    v = bench_field(N_MAIN, dev)
    nbytes = v.numel() * 4
    key = ("v2", N_MAIN ** 3, B.E_DEFAULT, C, 0)
    B._K_CACHE.clear()
    blob, st = M.compress(v, TOL, config=fcfg)
    if st or section_head(blob)[0] != 1 or key not in B._K_CACHE:
        raise AssertionError(f"fused path, first stream: status {st}, flag "
                             f"{section_head(blob)[0]}, cache {B._K_CACHE}")
    K_primed = B._K_CACHE[key][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for rep in range(3):
        if rep == 0:
            kernels.reset_launches()
        t0 = time.perf_counter()
        blob, st = M.compress(v, TOL, config=fcfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, st2 = M.decompress(blob, device=dev)
        torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
        if rep == 0:
            launches_fused = dict(kernels.LAUNCHES)
        if st or st2 or section_head(blob)[0] != 2 or file_minor(blob) != 1:
            raise AssertionError(f"fused path: status {st}/{st2}, flag "
                                 f"{section_head(blob)[0]}, minor "
                                 f"{file_minor(blob)}")
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"hybrid_pack_v3": 1, "hybrid_unpack_v3": 1, "hybrid_fwd_v2": 0,
            "hybrid_inv_v2": 0, "bfp_encode": 1, "bfp_decode": 1}
    if any(launches_fused[k] != n for k, n in want.items()):
        # K2/K3 serve the remainder section only; the cf stream must not
        # reach K1 or K2
        raise AssertionError(f"fused path launches {launches_fused}, "
                             f"expected {want}")
    err = float((out - v).abs().max())
    if not (torch.isfinite(out).all() and tuple(out.shape) == tuple(v.shape)
            and err <= TOL):
        raise AssertionError(f"fused path: L-inf {err} > {TOL} or bad output")
    tc = min(t[0] for t in times)
    td = min(t[1] for t in times)
    phase(f"phase 12 fused path {N_MAIN}^3 f32 tol={TOL}: first stream flag 1 "
          f"(primes K={K_primed}), then flag 2, file minor 1, ratio "
          f"{nbytes / len(blob):.4f}, L-inf {err:.3e}; compress "
          f"{tc * 1e3:.1f} ms ({nbytes / tc / 1e9:.3f} GB/s), decompress "
          f"{td * 1e3:.1f} ms ({nbytes / td / 1e9:.3f} GB/s) [best of 3; "
          f"first {times[0][0] * 1e3:.1f} / {times[0][1] * 1e3:.1f} ms]; the "
          f"main path in this run (phase 4): {main_ms[0]:.1f} / "
          f"{main_ms[1]:.1f} ms; peak device memory {peak / 2**30:.3f} GiB; "
          f"launches of one compress + decompress {launches_fused}")
    # a tighter tolerance on the primed shape: the stale K undersizes the
    # chunks, the stream falls back to flag 1 with a fresh K, the next fuses
    flags = []
    for _rep in range(2):
        blob, st = M.compress(v, TOL_TIGHT, config=fcfg)
        out, st2 = M.decompress(blob, device=dev)
        err = float((out - v).abs().max())
        if st or st2 or not err <= TOL_TIGHT:
            raise AssertionError(f"fused path at tol {TOL_TIGHT}: status "
                                 f"{st}/{st2}, L-inf {err}")
        flags.append((section_head(blob)[0], B._K_CACHE[key][0]))
    if [f for f, _ in flags] != [1, 2] or not flags[0][1] > K_primed:
        raise AssertionError(f"stale-K fallback: (flag, K) {flags} after "
                             f"K={K_primed}")
    phase(f"phase 12 tol {TOL_TIGHT:g} on the primed shape: stale K="
          f"{K_primed} -> flag 1 with K={flags[0][1]}, next stream flag 2; "
          f"L-inf {err:.3e}")
    del out, v
    torch.cuda.empty_cache()

    path_launches = {**{k: launches_main[k] for k in MAIN_PATH},
                     **{k: launches_bfx[k] for k in BFX_PATH},
                     "bitplane_encode": launches_mdr["bitplane_encode"],
                     **{k: launches_fused[k] for k in FUSED_PATH}}

    # -- 13. the layout probes; 14-19. the generic compress surface -------
    probe_rows = {}
    probe_phase(dev, kernels, probe_rows, path_launches)
    torch.cuda.empty_cache()
    generic_phases(dev, M, kernels)

    # -- 20. streams of the reference libraries -------------------------
    torch.cuda.empty_cache()
    reference_phase(dev, M)

    # -- 21. XGC's f0 shape on the slice route ---------------------------
    torch.cuda.empty_cache()
    xgc_phase(dev, M)

    print(smi[0], flush=True)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=path_launches[k], **rows[k])
        for k, (src, rep) in REPO_KERNELS.items()] + [
        dict(name=k, route="cuda", source=PROBE_SOURCE,
             launches=path_launches[k], **row)
        for k, row in probe_rows.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
