"""P2's direct variant (mgard_tpu_torch/csrc/probes.cu, probe_relayout
variant 0) against the PyTorch calls that compute the same function, on an
NVIDIA GPU (H100), against variants of its own design (one wave of
blocks striding over the rows in place of a full grid, streaming hints on
the loads and stores, two or eight int4 a thread), and (with --parent)
another tree's probes.cu.

    python3 scripts/h100_relayout_direct.py [--rounds 5] [--reps 20]
        [--parent path/to/probes.cu]

At the probe's production shape (probes.SHAPES: 2^18 rows of 128 int32
words, 128 MB each way) the forward relayout (rows doubled) runs beside
`x.reshape(-1, 32) * 2` and the reverse (copied) beside
`t.reshape(-1, 128).clone()`; at the tail shape (probes.RELAYOUT_TAIL rows,
whose int4 count is no multiple of a block's 1024) both directions are
held against the plain version only. A variant is a copy of
mgard_tpu_torch/csrc whose probes.cu is patched by the text replacements
in VARIANTS, built by scripts/h100_v3_variants.py's build_variant (the
package's nvcc flags, build/relayout_variants/<name>/). Every kernel's
output must equal relayout_plain's. The rounds alternate the contenders,
the order rotating each round, and time every launch on its own
(chip_smoke.py's launch_ms: CUDA events around each of --reps launches);
the medians are over all launches. Prints the card's name and power
limit, the bytes' bound at 3.35 TB/s, and each contender's median and
range. Exits nonzero without a CUDA device or when a kernel differs.
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


# one wave of blocks (the 132 SMs of an H100 SXM, 8 blocks of 256 threads
# each at 32 registers) striding over the rows
_WAVES = [
    ("  const long long t0 = (long long)blockIdx.x * NT * U + threadIdx.x;\n",
     "  for (long long t0 = (long long)blockIdx.x * NT * U + threadIdx.x;\n"
     "       t0 < n4; t0 += (long long)gridDim.x * NT * U) {\n"),
    ("      out[t0 + u * NT] = v[u];\n    }\n  }\n}\n",
     "      out[t0 + u * NT] = v[u];\n    }\n  }\n  }\n}\n"),
    ("relayout_direct_kernel<<<(unsigned)((n4 + NT * U - 1) / (NT * U)),",
     "relayout_direct_kernel<<<(unsigned)(n4 > 1056LL * NT * U ? 1056LL :"
     " (n4 + NT * U - 1) / (NT * U)),")]
_HINTS = [("v[u] = x[t0 + u * NT];", "v[u] = __ldcs(x + t0 + u * NT);"),
          ("out[t0 + u * NT] = v[u];", "__stcs(out + t0 + u * NT, v[u]);")]
VARIANTS = {
    "shipped": [],
    # one wave of blocks and a grid-stride loop in place of a full grid
    "waves": _WAVES,
    # streaming loads and stores (__ldcs/__stcs, evict first)
    "hints": _HINTS,
    # two and eight int4 in flight a thread
    "u2": [("constexpr int U = 4;", "constexpr int U = 2;")],
    "u8": [("constexpr int U = 4;", "constexpr int U = 8;")],
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="another probes.cu (e.g. a parent tree's), timed "
                    "as 'parent'")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_relayout_direct: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    from mgard_tpu_torch import kernels, probes as PR

    variants = dict(VARIANTS)
    if a.parent:
        shipped = (ROOT / "mgard_tpu_torch" / "csrc" / "probes.cu"
                   ).read_text()
        variants["parent"] = [(shipped, Path(a.parent).read_text())]
    csrc0, build0 = kernels._CSRC, kernels.BUILD_DIR
    libs = {}
    for name, patches in variants.items():
        libs[name], ptx = V3.build_variant(
            kernels, name, patches, "probes.cu", ("relayout_direct_kernel",),
            "relayout_variants")
        for line in ptx:
            print(f"{name} ptxas {line}", flush=True)
    kernels._CSRC, kernels.BUILD_DIR = csrc0, build0

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    shapes = {}
    for sbc in (PR.SHAPES["relayout"][1], PR.RELAYOUT_TAIL):
        x = torch.from_numpy(rng.integers(0, 1 << 30, (sbc, PR.LANES),
                                          dtype=np.int64).astype(np.int32))
        x = x.to(dev)
        shapes[sbc] = (x, PR.relayout_plain(x) // 2)

    def kernel(lib, inp, rev):
        def run():
            kernels._lib = libs[lib]
            return PR.relayout(inp, rev, variant="direct")
        return run

    for sbc, (x, t) in shapes.items():
        for rev, inp in ((False, x), (True, t)):
            want = PR.relayout_plain(inp, rev)
            for lib in libs:
                if not torch.equal(kernel(lib, inp, rev)(), want):
                    raise SystemExit(f"{lib}: direct differs from plain at "
                                     f"{sbc} rows (reverse {rev})")
    print(f"direct equal to plain at {list(shapes)} rows of 128 words, both "
          f"directions, in {list(libs)}", flush=True)

    x, t = shapes[PR.SHAPES["relayout"][1]]
    moved = 2 * x.numel() * 4
    print(f"{x.numel() * 4} bytes each way: bound "
          f"{moved / PR.HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s",
          flush=True)
    fns = {"reshape*2": lambda: x.reshape(-1, 32) * 2,
           "reshape.clone": lambda: t.reshape(-1, PR.LANES).clone()}
    for lib in libs:
        fns[f"{lib} direct"] = kernel(lib, x, False)
        fns[f"{lib} direct reverse"] = kernel(lib, t, True)
    names = list(fns)
    ms = {nm: [] for nm in names}
    for r in range(a.rounds):
        for nm in names[r % len(names):] + names[:r % len(names)]:
            ms[nm] += V3.CS.launch_ms(fns[nm], a.reps)
    kernels._lib = None
    for nm in names:
        xs = ms[nm]
        print(f"{nm}: median {statistics.median(xs):.4f} ms over {len(xs)} "
              f"launches, range {min(xs):.4f}-{max(xs):.4f}", flush=True)


if __name__ == "__main__":
    main()
