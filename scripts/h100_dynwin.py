"""P1 (mgard_tpu_torch/csrc/probes.cu, probe_dynwin) on an NVIDIA GPU
(H100): every variant of this tree, and (with --parent) another tree's
probes.cu, at the probe's production shape.

    python3 scripts/h100_dynwin.py [--rounds 5] [--reps 20]
        [--parent path/to/probes.cu] [--variants]

Every variant is first held against dynwin_place_plain at the probe's own
shape (8, 4, 4) and at the production shape (probes.SHAPES: 256
superblocks, E = 8 planes of W = 128 rows, seed 0). Then, in --rounds
rounds whose order rotates, each contender is timed as device time: --reps
calls captured in one CUDA graph and replayed between CUDA events
(chip_smoke.graph_ms), medians over the rounds:

- this tree's wrapper, probes.dynwin_place, per variant (one launch a
  call, nothing copied from the host), and its kernel alone (the C entry
  point into one fixed output buffer);
- the parent's kernels alone through its own C entry point (the signature
  before total_rows: a device tensor `tot` of row counts, computed once
  here, and the tail zeroed once), per variant;
- a clone of a contiguous buffer of the content rows' bytes: a yardstick
  that moves about the same bytes, not the same function;
- with --variants, the run and bulk variants of patched copies of this
  tree's probes.cu (VARIANTS: eight int4 a thread in flight in place of
  four; bulk pieces of 16 KB, so 32 KB of shared memory a block), built
  by scripts/h100_v3_variants.py's build_variant under
  build/dynwin_variants/<name>/.

The parent's wrapper as it was timed before (CUDA events around calls
that each build tot from a host value, run torch.diff, zero the tail and
launch: chip_smoke.time_ms) is timed in the same rounds, and so is this
tree's default wrapper that way. Prints the card's name and power limit,
each P1 kernel's ptxas line, the bytes' bound at 3.35 TB/s, and each
contender's median and range. Exits nonzero without a CUDA device or when
a kernel differs from the plain version.
"""

import argparse
import ctypes
import importlib.util
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

_V3 = importlib.util.spec_from_file_location(
    "h100_v3_variants", ROOT / "scripts" / "h100_v3_variants.py")
V3 = importlib.util.module_from_spec(_V3)
_V3.loader.exec_module(V3)

VARIANTS = {
    "u8": [("constexpr int U = 4;", "constexpr int U = 8;")],
    "piece16k": [("constexpr int PIECE = 32 * 1024;",
                  "constexpr int PIECE = 16 * 1024;")],
}

P1_KERNELS = ("dynwin_or_kernel", "dynwin_owner_kernel", "dynwin_run_kernel",
              "dynwin_bulk_kernel")


def build_parent(kernels, probes_cu: Path):
    """The other tree's probes.cu (with this tree's common.cuh) built alone
    into build/dynwin_parent/ with the package's nvcc flags; its
    probe_dynwin bound with the signature before total_rows."""
    out = ROOT / "build" / "dynwin_parent"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(kernels._CSRC / "common.cuh", out / "common.cuh")
    shutil.copy(probes_cu, out / "probes.cu")
    lib = out / "libparent_probes.so"
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          "-I", str(out), "-o", str(lib), str(out / "probes.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"parent build failed:\n{res.stdout}{res.stderr}")
    L = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    L.probe_dynwin.argtypes = [P, P, P, P, P, I, I, I, I, P]
    L.probe_dynwin.restype = I
    return L, CS.ptxas_lines(res.stdout + res.stderr, P1_KERNELS[:2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="another tree's probes.cu, its or/owner timed as "
                    "'parent'")
    ap.add_argument("--variants", action="store_true",
                    help="also time the patched copies of VARIANTS")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_dynwin: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    from mgard_tpu_torch import kernels, probes as PR

    libs = {"shipped": kernels.lib()}
    for line in CS.ptxas_lines(kernels.BUILD_LOG, P1_KERNELS):
        print(f"ptxas {line}", flush=True)
    if a.variants:
        csrc0, build0 = kernels._CSRC, kernels.BUILD_DIR
        for name, patches in VARIANTS.items():
            libs[name], ptx = V3.build_variant(
                kernels, name, patches, "probes.cu", P1_KERNELS[2:],
                "dynwin_variants")
            for line in ptx:
                print(f"{name} ptxas {line}", flush=True)
        kernels._CSRC, kernels.BUILD_DIR = csrc0, build0
    parent = None
    if a.parent:
        parent, ptx = build_parent(kernels, Path(a.parent))
        for line in ptx:
            print(f"parent ptxas {line}", flush=True)

    dev = torch.device("cuda:0")
    variants = PR.VARIANTS["dynwin"]

    def parent_call(args, tot, out, v):
        planes, woff, sb_off, _ = args
        NSB, E, W, _ = planes.shape
        rc = parent.probe_dynwin(planes.data_ptr(), woff.data_ptr(),
                                 sb_off.data_ptr(), tot.data_ptr(),
                                 out.data_ptr(), NSB, E, W,
                                 ("or", "owner").index(v),
                                 kernels.stream(dev))
        if rc:
            raise SystemExit(f"parent probe_dynwin: CUDA error {rc}")
        return out

    def tot_of(sb_off, total):
        return torch.cat([sb_off[1:], sb_off.new_full((1,), total)]) - sb_off

    def wrapper(lib, args, v):
        def call():
            kernels._lib = libs[lib]
            if v is None:
                return PR.dynwin_place(*args)
            return PR.dynwin_place(*args, variant=v)
        return call

    contenders = [("shipped", v) for v in variants] + [
        (lib, v) for lib in libs if lib != "shipped" for v in ("run", "bulk")]
    for geom in PR.SHAPES["dynwin"]:
        args = PR.dynwin_inputs(*geom, seed=0, device=dev)
        want = PR.dynwin_place_plain(*args)
        for lib, v in contenders:
            if not torch.equal(wrapper(lib, args, v)(), want):
                raise SystemExit(f"{lib} {v} differs from plain at {geom}")
        if parent is not None:
            for v in ("or", "owner"):
                out = torch.zeros_like(want)
                parent_call(args, tot_of(args[2], args[3]), out, v)
                if not torch.equal(out, want):
                    raise SystemExit(f"parent {v} differs from plain at "
                                     f"{geom}")
        torch.cuda.synchronize()
    print(f"every variant equal to plain at {PR.SHAPES['dynwin']}"
          + (", the parent's or/owner too" if parent else ""), flush=True)

    geom = PR.SHAPES["dynwin"][1]
    args = PR.dynwin_inputs(*geom, seed=0, device=dev)
    planes, woff, sb_off, total = args
    NSB, E, W, _ = planes.shape
    moved = (2 * total + E * W) * PR.LANES * 4
    print(f"{geom}: {total} content rows; bound "
          f"{moved / PR.HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s "
          f"({moved} bytes: the content rows read and written, the "
          f"{E * W} tail rows written; the content alone "
          f"{2 * total * 512 / PR.HBM_BYTES_PER_S * 1e3:.4f} ms)",
          flush=True)
    buf = torch.zeros(total * PR.LANES, dtype=torch.int32, device=dev)
    graphed = {(f"{v} (wrapper)" if lib == "shipped"
                else f"{lib} {v} (wrapper)"): wrapper(lib, args, v)
               for lib, v in contenders}
    graphed["clone of the content bytes"] = buf.clone
    out_c = torch.empty((total + E * W, PR.LANES), dtype=torch.int32,
                        device=dev)
    for v in variants:
        # this tree's kernel alone: its C entry point into one fixed buffer
        graphed[f"{v} (kernel alone)"] = (
            lambda v=v: kernels.launch(
                "probe_dynwin", planes.data_ptr(), woff.data_ptr(),
                sb_off.data_ptr(), out_c.data_ptr(), NSB, E, W, total,
                variants.index(v), kernels.stream(dev),
                count_as=PR.counter("dynwin", v)))
    evented = {"default wrapper, events": wrapper("shipped", args, None)}
    if parent is not None:
        tot = tot_of(sb_off, total)
        out_p = torch.zeros((total + E * W, PR.LANES), dtype=torch.int32,
                            device=dev)
        for v in ("or", "owner"):
            graphed[f"parent {v} (kernel alone)"] = (
                lambda v=v: parent_call(args, tot, out_p, v))

            def parent_wrapper(v=v):
                end = torch.tensor([total], dtype=torch.int32, device=dev)
                t = torch.diff(sb_off, append=end).contiguous()
                out = torch.empty((total + E * W, PR.LANES),
                                  dtype=torch.int32, device=dev)
                out[total:].zero_()
                return parent_call(args, t, out, v)

            evented[f"parent {v} wrapper, events"] = parent_wrapper
    names = list(graphed) + list(evented)
    ms = {nm: [] for nm in names}
    for r in range(a.rounds):
        for nm in names[r % len(names):] + names[:r % len(names)]:
            if nm in graphed:
                ms[nm].append(CS.graph_ms(graphed[nm], a.reps))
            else:
                ms[nm].append(CS.time_ms(evented[nm], 5))
    kernels._lib = libs["shipped"]
    for nm in names:
        xs = ms[nm]
        how = "graph replays" if nm in graphed else "CUDA events, 5 calls"
        print(f"{nm}: median {statistics.median(xs):.4f} ms over {len(xs)} "
              f"rounds ({how}), range {min(xs):.4f}-{max(xs):.4f}",
              flush=True)


if __name__ == "__main__":
    main()
