"""K5/K6 (mgard_tpu_torch/csrc/bfx.cu) against variants of their own design
on an NVIDIA GPU (H100): the cluster size, when the stage is filled, the
CTAs an SM, K6's offsets by a pre-kernel in place of its look-back, and
(with --parent) another tree's bfx.cu, whose launches are also timed apart.

    python3 scripts/h100_bfx_variants.py [--rounds 4] [--reps 20]
        [--only NAME ...] [--parent path/to/bfx.cu]

A variant is a copy of mgard_tpu_torch/csrc whose bfx.cu is patched by the
text replacements in VARIANTS (each must match exactly once), built into
build/bfx_variants/<name>/ with the package's own nvcc flags
(scripts/h100_v3_variants.py's build_variant). The cases are
chip_smoke.py phase 3's: the 512^3 Hybrid+BFX stream (sb=4096,
align=1024), 8192 symbols at sb=256/align=1, MDR plane MDR_PLANE of the
384^3 finest level, and twelve superblocks of 32-bit blocks. Each variant's
words, widths, total and decoded symbols must equal the shipped kernels'
bit for bit at every case. The rounds alternate the variants, the order
rotating each round, and time K5 and K6 through their C entry points
(CUDA-event means of --reps calls, outputs allocated once; the shipped
entry points zero their scratch inside the timed call). With --parent,
the parent's launches (K5: widths, a scan per superblock, the offsets,
the pack; K6: the two scans, the unpack) are timed apart under
torch.profiler at the 512^3 case. Prints the card's name
and power limit, each variant's ptxas lines, its readings per round, their
median and range. Exits nonzero without a CUDA device or when a variant
differs.
"""

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_spec = importlib.util.spec_from_file_location(
    "h100_v3_variants", ROOT / "scripts" / "h100_v3_variants.py")
V3 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(V3)
CS = V3.CS

_BOUNDS = [("__global__ void __launch_bounds__(NT, 2)\nbfx_encode_kernel(",
            "__global__ void __launch_bounds__(NT, 3)\nbfx_encode_kernel("),
           ("__global__ void __launch_bounds__(NT, 2)\nbfx_decode_kernel(",
            "__global__ void __launch_bounds__(NT, 3)\nbfx_decode_kernel(")]

# K6's superblock offsets from a pre-kernel (a CTA a superblock: its width
# sum, then the same look-back) in place of each CTA's own look-back; the
# main kernel then takes its superblock from blockIdx and reads the
# inclusive offset
_PREKERNEL = [
    ("  if (threadIdx.x == 0)\n"
     "    cl[0] = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);\n"
     "  if (threadIdx.x < MAX_C) sums[threadIdx.x] = 0;\n",
     "  if (threadIdx.x == 0) cl[0] = (int)blockIdx.x;\n"
     "  if (threadIdx.x < MAX_C) sums[threadIdx.x] = 0;\n"),
    ("  if (r == 0 && threadIdx.x == 0)\n"
     "    st_release(status + s, (s ? AGG : INCL) | (unsigned)A);\n"
     "  if (threadIdx.x < 32) {\n"
     "    const int E = s ? lookback(status, s) : 0;\n"
     "    if (threadIdx.x == 0) {\n"
     "      if (r == 0 && s) st_release(status + s, INCL | "
     "(unsigned)(E + A));\n"
     "      cl[1] = E;\n"
     "    }\n"
     "  }\n",
     "  if (threadIdx.x == 0) cl[1] = "
     "(int)(unsigned)ld_acquire(status + s) - A;\n"),
    ("inline int log2_exact(int sb) {\n",
     "__global__ void __launch_bounds__(NT)\n"
     "bfx_sb_offsets_kernel(const uint8_t* __restrict__ widths,\n"
     "                      unsigned long long* __restrict__ scratch, "
     "int sb,\n"
     "                      int align) {\n"
     "  __shared__ int cl[1 + NT / 32];\n"
     "  unsigned long long* status = scratch + 1;\n"
     "  if (threadIdx.x == 0)\n"
     "    cl[0] = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);\n"
     "  __syncthreads();\n"
     "  const int s = cl[0];\n"
     "  unsigned L = 0u;\n"
     "  for (int i = threadIdx.x; i < sb; i += NT)\n"
     "    L += widths[(long long)s * sb + i];\n"
     "  L = __reduce_add_sync(FULL, L);\n"
     "  if ((threadIdx.x & 31) == 0) cl[1 + (threadIdx.x >> 5)] = (int)L;\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x < 32) {\n"
     "    L = threadIdx.x < NT / 32 ? (unsigned)cl[1 + threadIdx.x] : 0u;\n"
     "    const int A = aligned((int)__reduce_add_sync(FULL, L), align);\n"
     "    if (threadIdx.x == 0)\n"
     "      st_release(status + s, (s ? AGG : INCL) | (unsigned)A);\n"
     "    const int E = s ? lookback(status, s) : 0;\n"
     "    if (threadIdx.x == 0 && s)\n"
     "      st_release(status + s, INCL | (unsigned)(E + A));\n"
     "  }\n"
     "}\n\n"
     "inline int log2_exact(int sb) {\n"),
    ("    bfx_decode_kernel<<<(unsigned)(NB / G.P), NT, smem_bytes(G.P),\n",
     "    bfx_sb_offsets_kernel<<<(unsigned)(NB / sb), NT, 0,\n"
     "                            (cudaStream_t)stream>>>(\n"
     "        (const uint8_t*)widths, (unsigned long long*)scratch, sb, "
     "align);\n"
     "    bfx_decode_kernel<<<(unsigned)(NB / G.P), NT, smem_bytes(G.P),\n"),
]

VARIANTS = {
    "shipped": [],
    # CTAs of 1024 blocks (128 KB of symbols, one an SM): clusters of 4
    "c4": [("constexpr int LOG_PB = 9,", "constexpr int LOG_PB = 10,")],
    # CTAs of 256 blocks: clusters of 16 (non-portable)
    "c16": [("constexpr int LOG_PB = 9,", "constexpr int LOG_PB = 8,")],
    # K5 stages its plane words only after the look-back, at every align
    "late": [("const bool early = (G.align & 3) == 0;",
              "const bool early = false;")],
    # registers for three CTAs an SM
    "bounds3": _BOUNDS,
    "k6_prekernel": _PREKERNEL,
}
ENTRIES = ("bfx_encode_kernel", "bfx_decode_kernel", "bfx_sb_offsets_kernel",
           "bfx_widths_kernel", "bfx_sb_scan_kernel", "bfx_offsets_kernel",
           "bfx_pack_kernel", "bfx_unpack_kernel")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Codec:
    """K5/K6 of one library on one case, through the C entry points, with
    the outputs and scratch allocated once (the parent's ABI: boff, slen,
    offs scratch; the shipped one: a scratch of NSB + 1 words that the
    entry point zeroes)."""

    def __init__(self, lib, parent, sym, sb, align):
        from mgard_tpu_torch import kernels
        from mgard_tpu_torch.lossless import bfx as X

        dev = sym.device
        self.lib, self.parent, self.sb, self.align = lib, parent, sb, align
        self.sym = sym
        self.NB = sym.numel() // 32
        NSB = self.NB // sb
        self.st = kernels.stream(dev)
        new = lambda n, dt=torch.int32: torch.empty(n, dtype=dt, device=dev)
        self.widths = new(self.NB, torch.uint8)
        self.offs = new(NSB + 1)
        self.out = new(X._out_words(NSB, sb, align))
        self.back = new(self.NB * 32)
        self.scratch = new(NSB + 1, torch.int64)
        self.boff, self.slen = new(self.NB), new(NSB)
        if parent:
            lib.bfx_encode.argtypes = [_P] * 6 + [_L, _I, _I, _P]
            lib.bfx_decode.argtypes = [_P] * 6 + [_L, _I, _I, _P]

    def _rc(self, name, rc):
        if rc:
            raise SystemExit(f"{name}: CUDA error {rc}")

    def encode(self):
        p = lambda t: t.data_ptr()
        if self.parent:
            rc = self.lib.bfx_encode(
                p(self.sym), p(self.widths), p(self.boff), p(self.slen),
                p(self.offs), p(self.out), self.NB, self.sb, self.align,
                self.st)
        else:
            rc = self.lib.bfx_encode(
                p(self.sym), p(self.widths), p(self.scratch), p(self.offs),
                p(self.out), self.NB, self.sb, self.align, self.st)
        self._rc("bfx_encode", rc)

    def decode(self, words):
        p = lambda t: t.data_ptr()
        if self.parent:
            rc = self.lib.bfx_decode(
                p(words), p(self.widths), p(self.boff), p(self.slen),
                p(self.offs), p(self.back), self.NB, self.sb, self.align,
                self.st)
        else:
            rc = self.lib.bfx_decode(
                p(words), p(self.widths), p(self.scratch), p(self.back),
                self.NB, self.sb, self.align, self.st)
        self._rc("bfx_decode", rc)


def cases(dev):
    """chip_smoke.py phase 3's K5/K6 cases: name -> (symbols, sb, align)."""
    import mgard_tpu_torch as M
    from mgard_tpu_torch import highlevel as HL
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.lossless import bfx as X
    from mgard_tpu_torch.mdr import bitplane as BP, components as MC
    from mgard_tpu_torch.ops import hybrid as Hy
    from mgard_tpu_torch.ops.refactor import decompose

    n = CS.N_MAIN
    shape, cfg = (n,) * 3, M.Config()
    rem_hier = get_hierarchy(Hy.remainder_shape(shape, 3), np.float32, None,
                             cfg)
    q = HL._hybrid_quantizer(CS.TOL, Hy.hybrid_l_total(shape, 3, rem_hier))
    v = CS.bench_field(n, dev)
    out = {"512^3": (HL._compress_core_hybrid(v, q, shape, 3, rem_hier, True),
                     X.SB_BLOCKS, X.ALIGN)}
    del v
    gen = np.random.default_rng(7)
    out["8192 sb=256"] = (torch.from_numpy(CS.mixed_symbols(8192, gen)).to(
        dev), X.SB_BLOCKS_SMALL, 1)
    v384 = CS.bench_field(CS.N_MDR, dev)
    h384 = get_hierarchy((CS.N_MDR,) * 3, np.float32, None, cfg)
    lvl = BP.pad_stream(MC.interleave_level(decompose(v384, h384), h384,
                                            h384.l_target)).contiguous()
    v2d = lvl.reshape(32, -1)
    exp = BP._level_exp(v2d.abs().max().double())
    plane = BP.encode_core(v2d, exp, 32)[0][CS.MDR_PLANE]
    pad = X._pad_to(plane.numel(), X.SB_BLOCKS) - plane.numel()
    out["MDR plane"] = (torch.cat([plane, plane.new_zeros(pad)]),
                        X.SB_BLOCKS, X.ALIGN)
    del v384, lvl, v2d
    wide = CS.mixed_symbols(X.SB_BLOCKS * 32 * 12, gen, wide=True)
    wide[::32] = -2**31
    out["32-bit blocks"] = (torch.from_numpy(wide).to(dev), X.SB_BLOCKS,
                            X.ALIGN)
    return out


def parent_breakdown(codec, words, reps=5):
    """The parent's launches timed apart under torch.profiler: (name, device
    ms per call) for K5's and K6's kernels."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for what, fn in (("K5", codec.encode),
                     ("K6", lambda: codec.decode(words))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            if t and "bfx_" in ev.key:
                rows.append((ev.key, t / 1e3 / reps, ev.count // reps))
        res[what] = rows
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to run (default: all; shipped always)")
    ap.add_argument("--parent", default=None,
                    help="another bfx.cu (e.g. a parent tree's), timed as "
                    "the variant 'parent'")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_bfx_variants: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    from mgard_tpu_torch import kernels

    names = ["shipped"] + [n for n in VARIANTS if n != "shipped"
                           and (a.only is None or n in a.only)]
    if a.parent:
        shipped = (ROOT / "mgard_tpu_torch" / "csrc" / "bfx.cu").read_text()
        VARIANTS["parent"] = [(shipped, Path(a.parent).read_text())]
        names.append("parent")
    csrc0, build0 = kernels._CSRC, kernels.BUILD_DIR
    libs = {}
    for name in names:
        libs[name], ptx = V3.build_variant(
            kernels, name, VARIANTS[name], "bfx.cu", ENTRIES, "bfx_variants")
        for line in ptx:
            print(f"{name} ptxas {line}", flush=True)
    kernels._CSRC, kernels.BUILD_DIR = csrc0, build0
    kernels._lib = libs["shipped"]

    dev = torch.device("cuda:0")
    cs = cases(dev)
    codecs = {(nm, c): Codec(libs[nm], nm == "parent", *cs[c])
              for nm in names for c in cs}
    want, words = {}, {}
    for c in cs:
        k = codecs["shipped", c]
        k.encode()
        total = int(k.offs[-1])
        words[c] = k.out[:total].clone()
        k.decode(words[c])
        if not torch.equal(k.back, k.sym):
            raise SystemExit(f"shipped: K6 does not invert K5 at {c}")
        want[c] = (total, k.widths.clone())
        print(f"case {c}: {k.sym.numel()} symbols, sb={k.sb}, "
              f"align={k.align}, {total} words", flush=True)
    for (nm, c), k in codecs.items():
        k.encode()
        total = int(k.offs[-1])
        k.decode(words[c])
        if not (total == want[c][0] and torch.equal(k.widths, want[c][1])
                and torch.equal(k.out[:total], words[c])
                and torch.equal(k.back, k.sym)):
            raise SystemExit(f"{nm}: K5/K6 outputs differ from shipped at "
                             f"{c}")
    print(f"every variant equal to shipped at {', '.join(cs)}", flush=True)

    if a.parent:
        for what, rows in parent_breakdown(codecs["parent", "512^3"],
                                           words["512^3"]).items():
            print(f"parent {what} at 512^3 under torch.profiler, device ms "
                  f"per call: " + ("; ".join(
                      f"{k} {t:.4f} (x{n})" for k, t, n in rows)
                      or "no device time"), flush=True)
        for what, rows in parent_breakdown(codecs["shipped", "512^3"],
                                           words["512^3"]).items():
            print(f"shipped {what} at 512^3 under torch.profiler: " + (
                "; ".join(f"{k} {t:.4f} (x{n})" for k, t, n in rows)
                or "no device time"), flush=True)

    ms = {(nm, c, k): [] for nm in names for c in cs for k in "56"}
    for r in range(a.rounds):
        for nm in names[r % len(names):] + names[:r % len(names)]:
            for c in cs:
                k = codecs[nm, c]
                ms[nm, c, "5"].append(CS.time_ms(k.encode, a.reps))
                ms[nm, c, "6"].append(CS.time_ms(
                    lambda: k.decode(words[c]), a.reps))
    for (nm, c, k), xs in ms.items():
        print(f"{nm} K{k} {c} ms per round {[round(x, 4) for x in xs]}: "
              f"median {statistics.median(xs):.4f}, range "
              f"{min(xs):.4f}-{max(xs):.4f}", flush=True)


if __name__ == "__main__":
    main()
