"""K7/K8 (mgard_tpu_torch/csrc/hybrid.cu) against variants of their own
design on an NVIDIA GPU (H100): the register budget, and stores straight
from registers in place of staged rows.

    python3 scripts/h100_flag0_variants.py [--rounds 4] [--reps 20]
        [--only NAME ...] [--parent path/to/hybrid.cu]

A variant is a copy of mgard_tpu_torch/csrc whose hybrid.cu is patched by
the text replacements in VARIANTS (each must match exactly once), built
into build/flag0_variants/<name>/ with the package's own nvcc flags
(scripts/h100_v3_variants.py's build_variant). The rounds alternate the
variants, the order rotating each round, and time K7 and K8 (CUDA-event
means of --reps launches) on the bench.py field at 512^3 (nl = 3 and 1)
and on chip_smoke.py's 8192^2 field (nl = 3). Every variant's outputs must
equal the shipped kernels' bit for bit at each of these. Prints the card's
name and power limit, each variant's ptxas lines, its readings per round,
their median and range. Exits nonzero without a CUDA device or when a
variant differs.
"""

import argparse
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


def _consts(fwd_nb, fwd_bps, inv_nb, inv_bps):
    return [("constexpr int FWD_NB = 8, FWD_BPS = 2;",
             f"constexpr int FWD_NB = {fwd_nb}, FWD_BPS = {fwd_bps};"),
            ("constexpr int INV_NB = 8, INV_BPS = 2;",
             f"constexpr int INV_NB = {inv_nb}, INV_BPS = {inv_bps};")]


_STORE_LINES = (
    "      __stcs(reinterpret_cast<{T}4*>(p), make_{T}4({a}[0], {a}[1], "
    "{a}[2], {a}[3]));\n"
    "      __stcs(reinterpret_cast<{T}4*>(p) + 1, make_{T}4({a}[4], {a}[5], "
    "{a}[6], {a}[7]));\n"
    "      p += G.Z;\n"
    "      __stcs(reinterpret_cast<{T}4*>(p), make_{T}4({b}[0], {b}[1], "
    "{b}[2], {b}[3]));\n"
    "      __stcs(reinterpret_cast<{T}4*>(p) + 1, make_{T}4({b}[4], {b}[5], "
    "{b}[6], {b}[7]));\n")

# K8's two lines leave as two 16-byte stores each, straight from registers
# (no stage, no barrier)
_K8_DIRECT = [(
    "    stage_tile<NB>(ob[t & 1], l, w.warp, threadIdx.x & 31);\n"
    "    __syncthreads();  // as K7's: one a tile, the stage double-buffered\n"
    "    store_rows<NB>(ob[t & 1], out + w.col + 8 * (size_t)t * NB, G.Yl, "
    "G.Z,\n"
    "                   w.nlines, 2 * min(NB, w.g - t * NB));\n",
    "    if (w.has(t)) {\n"
    "      float* p = out + w.row + 8 * (size_t)(t * NB + w.warp);\n"
    + _STORE_LINES.format(T="float", a="l.a", b="l.b") + "    }\n")]
# K7's symbols likewise (its corner values still go through the stage)
_K7_DIRECT = [(
    "    stage_tile<NB>(ob[t & 1], s, w.warp, threadIdx.x & 31);\n",
    "    if (on) {\n"
    "      int* p = sym + w.row + 8 * (size_t)(t * NB + w.warp);\n"
    + _STORE_LINES.format(T="int", a="sa", b="sb") + "    }\n"), (
    "    store_rows<NB>(ob[t & 1],\n"
    "                   reinterpret_cast<float*>(sym) + w.col + 8 * "
    "(size_t)t * NB,\n"
    "                   G.Yl, G.Z, w.nlines, 2 * nz);\n", "")]
# K7's corner values go straight from registers to rem, k scalar stores a
# corner line (as K1's), in place of the staged remainder rows
_K7_REM_DIRECT = [
    ("line_syms(l.a, on && w.ca, cmask, inv_q, rt + w.ra * RW, sa);",
     "line_syms(l.a, on && w.ca, cmask, inv_q, rem + w.rem_row(G, w.ra) * "
     "((size_t)w.g * K) + (size_t)(t * NB + w.warp) * K, sa);"),
    ("line_syms(l.b, on && w.cb, cmask, inv_q, rt + w.rb * RW, sb);",
     "line_syms(l.b, on && w.cb, cmask, inv_q, rem + w.rem_row(G, w.rb) * "
     "((size_t)w.g * K) + (size_t)(t * NB + w.warp) * K, sb);"),
    ("      if (c < nz * K && (!D2 || w.x0 + r / K < G.Xl))",
     "      if (c < 0)")]

VARIANTS = {
    "shipped": [],
    # 4 blocks of 8 warps an SM: 64 registers a thread
    "bps4": _consts(8, 4, 8, 4),
    "direct": _K8_DIRECT + _K7_DIRECT,
    "k7_rem_direct": _K7_REM_DIRECT,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to run (default: all; shipped always)")
    ap.add_argument("--parent", default=None,
                    help="another hybrid.cu (e.g. a parent tree's), timed "
                    "as the variant 'parent'")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_flag0_variants: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    from mgard_tpu_torch import highlevel as HL, kernels
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.ops import hybrid as Hy
    import mgard_tpu_torch as M

    names = ["shipped"] + [n for n in VARIANTS if n != "shipped"
                           and (a.only is None or n in a.only)]
    if a.parent:
        shipped = (ROOT / "mgard_tpu_torch" / "csrc" / "hybrid.cu").read_text()
        VARIANTS["parent"] = [(shipped, Path(a.parent).read_text())]
        names.append("parent")
    csrc0, build0 = kernels._CSRC, kernels.BUILD_DIR
    libs = {}
    for name in names:
        libs[name], ptx = V3.build_variant(
            kernels, name, VARIANTS[name], "hybrid.cu",
            ("flag0_fwd_kernel", "flag0_inv_kernel"), "flag0_variants")
        for line in ptx:
            print(f"{name} ptxas {line}", flush=True)
    kernels._CSRC, kernels.BUILD_DIR = csrc0, build0

    # chip_smoke.py phase 3's fields and quantizer
    dev = torch.device("cuda:0")
    n = CS.N_MAIN
    shape = (n,) * 3
    rem_hier = get_hierarchy(Hy.remainder_shape(shape, 3), np.float32, None,
                             M.Config())
    q = HL._hybrid_quantizer(CS.TOL, Hy.hybrid_l_total(shape, 3, rem_hier))
    inv_q, qf = HL._inv_q(q), HL._f32(q)
    v3d = CS.bench_field(n, dev)
    x2 = torch.linspace(0.0, 1.0, 8192, device=dev)
    v2d = torch.sin(6 * np.pi * x2[:, None]) * torch.cos(5 * np.pi * x2[None])
    cases = {"512^3 nl=3": (v3d, 3), "512^3 nl=1": (v3d, 1),
             "8192^2 nl=3": (v2d, 3)}

    def run(name, v, nl):
        kernels._lib = libs[name]
        sym, rem = Hy.local_transform_fused(v, inv_q, nl)
        return sym, rem, Hy.local_inverse_fused(sym, rem, qf, nl)

    want = {c: run("shipped", v, nl) for c, (v, nl) in cases.items()}
    for name in names:
        for c, (v, nl) in cases.items():
            got = run(name, v, nl)
            if not all(torch.equal(x, y) for x, y in zip(got, want[c])):
                raise SystemExit(f"{name}: K7/K8 outputs differ from shipped "
                                 f"at {c}")
            del got
    print(f"every variant equal to shipped at {', '.join(cases)}",
          flush=True)

    ms = {(nm, c, k): [] for nm in names for c in cases for k in "78"}
    for r in range(a.rounds):
        for nm in names[r % len(names):] + names[:r % len(names)]:
            kernels._lib = libs[nm]
            for c, (v, nl) in cases.items():
                sym, rem, _ = want[c]
                ms[nm, c, "7"].append(CS.time_ms(
                    lambda: Hy.local_transform_fused(v, inv_q, nl), a.reps))
                ms[nm, c, "8"].append(CS.time_ms(
                    lambda: Hy.local_inverse_fused(sym, rem, qf, nl), a.reps))
    for (nm, c, k), xs in ms.items():
        print(f"{nm} K{k} {c} ms per round {[round(x, 4) for x in xs]}: "
              f"median {statistics.median(xs):.4f}, range "
              f"{min(xs):.4f}-{max(xs):.4f}", flush=True)


if __name__ == "__main__":
    main()
