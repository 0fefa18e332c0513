"""K10/K11 (mgard_tpu_torch/csrc/hybrid_v3.cu) against variants of their own
design on an NVIDIA GPU (H100): what each of the kernels' mechanisms buys.

    python3 scripts/h100_v3_variants.py [--rounds 6] [--reps 20]

A variant is a copy of mgard_tpu_torch/csrc whose hybrid_v3.cu is patched by
the text replacements in VARIANTS (each must match exactly once), built into
build/v3_variants/<name>/ with the package's own nvcc flags. The rounds
alternate the variants, the order rotating each round, and time K10 and K11
(CUDA-event means of --reps launches) at 512^3 on the bench.py field with
the main path's K, E and nl = 3. Every variant's outputs must equal the
shipped kernels' bit for bit. Prints the card's name and power limit, each
variant's ptxas lines, its readings per round, their median and range.
Exits nonzero without a CUDA device or when a variant differs.
"""

import argparse
import importlib.util
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

# K10's split cluster barriers (arrive after the walk, wait after the
# transposes, arrive, wait after the rank) become one cluster.sync() after
# the transposes; K11's relaxed arrival on entry and its wait before the
# first remote store become one cluster.sync() there.
_SYNC = [
    ("  cluster_arrive();  // the block's row ORs are in place\n", ""),
    ("  cluster_wait();    // every block's row ORs are in place\n"
     "  cluster_arrive();  // the block's planes are in place\n",
     "  cluster.sync();\n"),
    ("  cluster_wait();  // every block's planes are in place\n", ""),
    ("  cluster_arrive_relaxed();\n", ""),
    ("  cluster_wait();  // every block of the cluster has started\n",
     "  cluster.sync();\n"),
]
# K10's warps keep one pack task's remote loads in flight, not two
_BATCH1 = [("constexpr int BATCH = 2;", "constexpr int BATCH = 1;")]

VARIANTS = {
    "shipped": [],
    "batch1": _BATCH1,
    "cluster_sync": _SYNC,
    "cluster_sync_batch1": _SYNC + _BATCH1,
}


def build_variant(kernels, name, patches, source="hybrid_v3.cu",
                  entries=("v3_pack_kernel", "v3_unpack_kernel"),
                  folder="v3_variants"):
    """Build the variant's library (csrc with `source` patched) under
    build/<folder>/<name>/ and return (the loaded library, the ptxas lines
    of the kernels named in `entries`)."""
    out = ROOT / "build" / folder / name
    shutil.rmtree(out, ignore_errors=True)
    src = out / "csrc"
    shutil.copytree(ROOT / "mgard_tpu_torch" / "csrc", src)
    cu = src / source
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: patch {old!r} matches "
                             f"{text.count(old)} times")
        text = text.replace(old, new)
    cu.write_text(text)
    kernels._CSRC, kernels.BUILD_DIR, kernels._lib = src, out / "lib", None
    lib = kernels.lib()
    return lib, CS.ptxas_lines(kernels.BUILD_LOG, entries)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_v3_variants: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    import mgard_tpu_torch as M
    from mgard_tpu_torch import highlevel as HL, kernels
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.lossless import bfp as B
    from mgard_tpu_torch.ops import hybrid as Hy

    csrc0, build0 = kernels._CSRC, kernels.BUILD_DIR
    libs = {}
    for name, patches in VARIANTS.items():
        libs[name], ptx = build_variant(kernels, name, patches)
        for line in ptx:
            print(f"{name} ptxas {line}", flush=True)
    kernels._CSRC, kernels.BUILD_DIR = csrc0, build0

    # the main path's geometry, q and K (as chip_smoke.py phase 3 sets them)
    dev = torch.device("cuda:0")
    n = CS.N_MAIN
    v = CS.bench_field(n, dev)
    shape, cfg = (n,) * 3, M.Config()
    rem_hier = get_hierarchy(Hy.remainder_shape(shape, 3), np.float32, None,
                             cfg)
    q = HL._hybrid_quantizer(CS.TOL, Hy.hybrid_l_total(shape, 3, rem_hier))
    C = HL._pick_v2_chunk(shape, cfg)
    inv_q, qf, E = HL._inv_q(q), HL._f32(q), B.E_DEFAULT
    kernels._lib = libs["shipped"]
    cw = Hy.local_transform_fused_v2(v, inv_q, 3, C)[1]
    hist = np.bincount(np.clip(cw.cpu().numpy(), 0, 32), minlength=33)
    K = B.choose_K(hist, E, C)
    del cw

    def run(name):
        kernels._lib = libs[name]
        k = Hy.local_transform_pack_v3(v, inv_q, 3, K, E)
        crl = (k[2] - K).clamp(0, E).to(torch.int32)
        return k, crl, Hy.unpack_inverse_v3(k[0], crl, k[1], k[3], qf, 3, K,
                                            E, shape)

    want, crl, out = run("shipped")
    for name in VARIANTS:
        got = run(name)
        if not (all(torch.equal(x, y) for x, y in zip(got[0], want))
                and torch.equal(got[2], out)):
            raise SystemExit(f"{name}: K10/K11 outputs differ from shipped")
        del got
    print(f"every variant equal to shipped at {n}^3, K={K} E={E} nl=3",
          flush=True)

    names = list(VARIANTS)
    ms = {nm: ([], []) for nm in names}
    for r in range(a.rounds):
        for nm in names[r % len(names):] + names[:r % len(names)]:
            kernels._lib = libs[nm]
            ms[nm][0].append(CS.time_ms(
                lambda: Hy.local_transform_pack_v3(v, inv_q, 3, K, E),
                a.reps))
            ms[nm][1].append(CS.time_ms(
                lambda: Hy.unpack_inverse_v3(want[0], crl, want[1], want[3],
                                             qf, 3, K, E, shape), a.reps))
    for nm in names:
        for kn, xs in zip(("K10", "K11"), ms[nm]):
            print(f"{nm} {kn} ms per round {[round(x, 4) for x in xs]}: "
                  f"median {statistics.median(xs):.4f}, range "
                  f"{min(xs):.4f}-{max(xs):.4f}", flush=True)


if __name__ == "__main__":
    main()
