"""K9 (mgard_tpu_torch/csrc/bitplane.cu) against variants of its own design
on an NVIDIA GPU (H100): the offset difference in place of the
int-to-float conversion, the fused square, the fold through shared memory
in place of warp shuffles, the unroll of the slot walk, the register
cap, warp 0's smaller entry chunk, and (with --parent) another tree's
bitplane.cu.

    python3 scripts/h100_bitplane_variants.py [--rounds 5] [--reps 20]
        [--only NAME ...] [--parent path/to/bitplane.cu] [--sass-dir DIR]

A variant is a copy of mgard_tpu_torch/csrc whose bitplane.cu is patched by
the text replacements in VARIANTS (each must match exactly once), built
into build/bitplane_variants/<name>/ with the package's own nvcc flags
(scripts/h100_v3_variants.py's build_variant). The cases are the levels K9
encodes in one MDRefactor of chip_smoke.py's 384^3 field (B = 32: levels
9, 8, 7 and 6). Every variant's planes and max partials must equal
encode_core_plain's bit for bit on the card at every level, and its
finished err_sq table must lie within relative 1e-6. The rounds alternate
the variants, the order rotating each round, and time K9 through its C
entry point (outputs allocated once; chip_smoke.py's graph_ms: --reps
calls captured in a CUDA graph and replayed between CUDA events, so that
no host time falls between the launches of a small level).
Prints the card's name and power limit, each variant's ptxas line, the
instructions its compiled kernel issues per element at B = 32 by class
(read off `cuobjdump -sass`: the loops and the straight code as the
design runs them), its readings per round, their median and range, and
the sum over the four levels. Exits nonzero without a CUDA device or when
a variant differs.
"""

import argparse
import collections
import importlib.util
import re
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

_SHFL_FOLD = [(
    "  float(*rows)[PITCH] = fold[warp];\n"
    "#pragma unroll\n"
    "  for (int i = 0; i < MAX_CHUNK; ++i) {\n"
    "    if (i < n) {\n"
    "      rows[2 * i][lane] = mx[i];\n"
    "      rows[2 * i + 1][lane] = sq[i];\n"
    "    }\n"
    "  }\n"
    "  __syncwarp();\n"
    "  if (lane < 2 * n) {\n"
    "    float acc = 0.f;\n"
    "    if (lane & 1) {\n"
    "      for (int c = 0; c < 32; ++c) acc = __fadd_rn(acc, rows[lane][c]);\n"
    "      esq[blk * (B + 1) + b0 + (lane >> 1)] = acc;\n"
    "    } else {\n"
    "      for (int c = 0; c < 32; ++c) acc = fmaxf(acc, rows[lane][c]);\n"
    "      emax[blk * (B + 1) + b0 + (lane >> 1)] = acc;\n"
    "    }\n"
    "  }\n",
    "#pragma unroll\n"
    "  for (int i = 0; i < MAX_CHUNK; ++i) {\n"
    "    if (i < n) {\n"
    "      float a = mx[i], q = sq[i];\n"
    "#pragma unroll\n"
    "      for (int o = 16; o; o >>= 1) {\n"
    "        a = fmaxf(a, __shfl_xor_sync(FULL, a, o));\n"
    "        q = __fadd_rn(q, __shfl_xor_sync(FULL, q, o));\n"
    "      }\n"
    "      if (lane == 0) {\n"
    "        emax[blk * (B + 1) + b0 + i] = a;\n"
    "        esq[blk * (B + 1) + b0 + i] = q;\n"
    "      }\n"
    "    }\n"
    "  }\n")]

VARIANTS = {
    "shipped": [],
    # every entry converts with __int2float_rn (no offset difference)
    "convert": [(
        "        const float lo = __uint_as_float((e.x & mask[i]) | MAGIC);\n"
        "        const float hb = __uint_as_float((e.y & half[i]) | MAGIC);\n"
        "        d = __fadd_rn(__fsub_rn(lo, hb), r);\n",
        "        const int x = (int)((e.x & mask[i]) - (e.y & half[i]));\n"
        "        d = __fadd_rn(__int2float_rn(x), r);\n")],
    # the square as a multiply and an add, as the plain version
    "mul_add": [("      sq[i] = __fmaf_rn(d, d, sq[i]);\n",
                 "      sq[i] = __fadd_rn(sq[i], __fmul_rn(d, d));\n")],
    # the column partials reduced by warp shuffles, as the first design
    "shfl_fold": _SHFL_FOLD,
    # the slot walk unrolled by 1 and by 4
    "unroll1": [("#pragma unroll 2\n", "#pragma unroll 1\n")],
    "unroll4": [("#pragma unroll 2\n", "#pragma unroll 4\n")],
    # no register cap (the shipped one is for seven blocks an SM)
    "bounds1": [("constexpr int MIN_BLOCKS = 7;",
                 "constexpr int MIN_BLOCKS = 1;")],
    # above B = 23 warp 0 (which also stores the planes) takes 6 of the
    # 24 offset-difference entries and warps 1 and 2 take 9 each, in place
    # of 8 each
    "uneven": [("    b0 = G + (c - 1) * ((MAGIC_MAX_S + 1) / 3);\n"
                "    n = (MAGIC_MAX_S + 1) / 3;\n",
                "    b0 = c == 1 ? G : G + 6 + (c - 2) * 9;\n"
                "    n = c == 1 ? 6 : 9;\n")],
}
ENTRIES = ("bitplane_encode_kernel",)
SRC = (ROOT / "mgard_tpu_torch" / "csrc" / "bitplane.cu").read_text()


def levels(dev):
    """The levels K9 encodes in one MDRefactor of the 384^3 bench field:
    [(level, v2d (32, m), exp)], finest first (chip_smoke.py phase 3)."""
    import mgard_tpu_torch as M
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.mdr import bitplane as BP, components as MC
    from mgard_tpu_torch.ops.refactor import decompose

    v = CS.bench_field(CS.N_MDR, dev)
    h = get_hierarchy((CS.N_MDR,) * 3, np.float32, None, M.Config())
    dec = decompose(v, h)
    out = []
    for li in range(h.l_target, -1, -1):
        lv = BP.pad_stream(MC.interleave_level(dec, h, li))
        if BP._use_kernel(lv.numel(), lv.dtype, 32):
            v2d = lv.contiguous().reshape(32, -1)
            out.append((li, v2d, BP._level_exp(v2d.abs().max().double())))
    return out


class Encoder:
    """K9 of one library on one level through the C entry point, outputs
    allocated once."""

    def __init__(self, lib, v2d, exp, B=32):
        from mgard_tpu_torch import kernels

        self.lib, self.v2d, self.exp, self.B = lib, v2d, exp, B
        self.m = v2d.shape[1]
        dev = v2d.device
        self.planes = torch.empty((B + 1, self.m), dtype=torch.int32,
                                  device=dev)
        self.emax = torch.empty((self.m // 32, B + 1), dtype=torch.float32,
                                device=dev)
        self.esq = torch.empty_like(self.emax)

    def __call__(self):
        from mgard_tpu_torch import kernels

        p = lambda t: t.data_ptr()
        rc = self.lib.bitplane_encode(p(self.v2d), p(self.exp), p(self.planes),
                                      p(self.emax), p(self.esq), self.m,
                                      self.B, kernels.stream(self.v2d.device))
        if rc:
            raise SystemExit(f"bitplane_encode: CUDA error {rc}")


def _sass(text):
    """{function name: [(address, opcode, branch target or None)]} of every
    kernel in cuobjdump -sass output."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name], labels, pending = [], {}, []
            continue
        if name is None:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not ins:
            continue
        addr = int(ins.group(1), 16)
        for p in pending:
            labels[p] = addr
        pending = []
        body = re.sub(r"^@!?U?P\w+\s+", "", ins.group(2).strip())
        op = body.split()[0] if body else ""
        tgt = None
        if op.split(".")[0] == "BRA":
            m_hex = re.search(r"0x([0-9a-f]+)", body)
            m_lab = re.search(r"(\.L_x_\d+)", body)
            tgt = (int(m_hex.group(1), 16) if m_hex else m_lab.group(1)
                   if m_lab else None)
        funcs[name].append([addr, op.split(".")[0], tgt])
        funcs[name][-1].append(labels)  # resolved below
    out = {}
    for fname, inss in funcs.items():
        rows = []
        for addr, op, tgt, labs in inss:
            if isinstance(tgt, str):
                tgt = labs.get(tgt)
            rows.append((addr, op, tgt))
        out[fname] = rows
    return out


def _loops(rows):
    """Backward branches: [(start index, end index)] of each loop body."""
    at = {a: i for i, (a, _, _) in enumerate(rows)}
    return [(at[t], i) for i, (a, op, t) in enumerate(rows)
            if op == "BRA" and t is not None and t < a and t in at]


def instruction_counts(rows, design, unroll):
    """Lane instructions per element at B = 32, by class, as the compiled
    kernel runs them (its loops found by their backward branches; I2FP
    counted as I2F). The shipped design: the straight code up to the
    barrier (every warp) over its 8 elements a lane, warp 0's transpose
    and plane stores after it over 32, plus each chunk loop's body over the
    `unroll` slots it walks a trip, for the converting chunk of 9 entries and
    three chunks of 8 (told apart by their FFMA and I2F counts); the
    chunk dispatch and the fold are left out. The parent
    design: the straight code before its entry loop over 32 elements a
    lane, plus 33 trips of that loop's body over its 32 elements."""
    ops = [op for _, op, _ in rows]
    ops = ["I2F" if op.startswith("I2F") else op for op in ops]
    per = collections.Counter()
    if design == "parent":
        s, e = _loops(rows)[0]
        for op in ops[:s]:
            per[op] += 1 / 32
        for op in ops[s:e + 1]:
            per[op] += 33 / 32
        return per
    bar = next(i for i, op in enumerate(ops) if op == "BAR")
    first = min(s for s, _ in _loops(rows))
    last_stg = max(i for i in range(bar, first) if ops[i] == "STG")
    for op in ops[:bar]:  # every warp, 8 elements a lane
        per[op] += 1 / 8
    for op in ops[bar:last_stg + 1]:  # warp 0: transpose and store
        per[op] += 1 / 32
    body = {}
    for s, e in _loops(rows):
        c = collections.Counter(ops[s:e + 1])
        body[(c["FFMA"], c["I2F"] > 0)] = c
    for key, trips in (((9 * unroll, True), 1), ((8 * unroll, False), 3)):
        if key not in body:
            raise SystemExit(f"no chunk loop with {key[0]} FFMA (I2F "
                             f"{key[1]}) in the SASS")
        for op, n in body[key].items():
            per[op] += trips * n / unroll
    return per


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to run (default: all; shipped always)")
    ap.add_argument("--parent", default=None,
                    help="another bitplane.cu (e.g. a parent tree's), timed "
                    "as the variant 'parent'")
    ap.add_argument("--sass-dir", default=None,
                    help="write the shipped and parent libraries' "
                    "cuobjdump -sass there")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_bitplane_variants: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    from mgard_tpu_torch import kernels
    from mgard_tpu_torch.mdr import bitplane as BP

    names = ["shipped"] + [n for n in VARIANTS if n != "shipped"
                           and (a.only is None or n in a.only)]
    if a.parent:
        shipped = (ROOT / "mgard_tpu_torch" / "csrc" / "bitplane.cu"
                   ).read_text()
        VARIANTS["parent"] = [(shipped, Path(a.parent).read_text())]
        names.append("parent")
    csrc0, build0 = kernels._CSRC, kernels.BUILD_DIR
    libs = {}
    for name in names:
        libs[name], ptx = V3.build_variant(
            kernels, name, VARIANTS[name], "bitplane.cu", ENTRIES,
            "bitplane_variants")
        for line in ptx:
            print(f"{name} ptxas {line}", flush=True)
        if name in ("shipped", "parent"):
            cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
            text = subprocess.run(
                [str(cuobjdump), "-sass", str(kernels.library_path())],
                capture_output=True, text=True, check=True).stdout
            if a.sass_dir:
                out = Path(a.sass_dir) / f"bitplane_sass_{name}.txt"
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(text)
            rows = next(r for f, r in _sass(text).items() if ENTRIES[0] in f)
            unroll = int(re.search(r"#pragma unroll (\d+)\n  for \(int k",
                                   SRC).group(1))
            per = instruction_counts(rows, name, unroll)
            print(f"{name} SASS: {len(rows)} instructions in the kernel, "
                  f"{len(_loops(rows))} loops; per element at B = 32 "
                  f"{sum(per.values()):.1f} lane instructions: " + ", ".join(
                      f"{op} {n:.1f}" for op, n in per.most_common()),
                  flush=True)
    kernels._CSRC, kernels.BUILD_DIR = csrc0, build0
    kernels._lib = libs["shipped"]

    dev = torch.device("cuda:0")
    lv = levels(dev)
    enc = {(nm, li): Encoder(libs[nm], v2d, exp)
           for nm in names for li, v2d, exp in lv}
    for li, v2d, exp in lv:
        pp, pe, ps = BP.encode_core_plain(v2d, exp, 32)
        pq = BP._finish_tables(pe, ps)[1]
        print(f"level {li}: {v2d.numel()} elements, m = {v2d.shape[1]}, "
              f"{v2d.shape[1] // 32} blocks of 32 columns", flush=True)
        for nm in names:
            k = enc[nm, li]
            k()
            kq = BP._finish_tables(k.emax, k.esq)[1]
            rel = float(((kq - pq).abs() / pq.clamp_min(1e-300)).max())
            if not (torch.equal(k.planes, pp) and torch.equal(k.emax, pe)
                    and rel <= 1e-6):
                raise SystemExit(f"{nm} differs from plain at level {li}: "
                                 f"planes {torch.equal(k.planes, pp)}, emax "
                                 f"{torch.equal(k.emax, pe)}, err_sq rel "
                                 f"{rel}")
        del pp, pe, ps
    print("every variant equal to plain at every level (planes, emax; "
          "err_sq rel <= 1e-6)", flush=True)

    ms = {(nm, li): [] for nm in names for li, _, _ in lv}
    for r in range(a.rounds):
        for nm in names[r % len(names):] + names[:r % len(names)]:
            for li, _, _ in lv:
                ms[nm, li].append(CS.graph_ms(enc[nm, li], a.reps))
    for nm in names:
        meds = []
        for li, _, _ in lv:
            xs = ms[nm, li]
            meds.append(statistics.median(xs))
            print(f"{nm} level {li} ms per round {[round(x, 4) for x in xs]}"
                  f": median {meds[-1]:.4f}, range {min(xs):.4f}-"
                  f"{max(xs):.4f}", flush=True)
        print(f"{nm} four levels: {sum(meds):.4f} ms (sum of medians)",
              flush=True)


if __name__ == "__main__":
    main()
