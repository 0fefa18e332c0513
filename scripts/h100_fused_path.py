"""Wall time of the fused flag-2 path (Config.hybrid_fused_pack) and of the
main path, compress and decompress, on an NVIDIA GPU (H100).

    python3 scripts/h100_fused_path.py [--root DIR] [--reps 10]

Times the package of the checkout at --root (default: this one), so that
one script compares two trees: run it once per tree, alternating. The field
is chip_smoke.py's 512^3 float32 bench.py field on the device, tol 1e-3
(s=inf, ABS). A first fused stream primes the sticky K (flag 1); then each
repetition times, on the host clock with a device sync at each end, a
compress and a decompress of the default Config (flag 1) and of the fused
Config (flag 2), and checks the flag and the error bound. Prints the card's
name and power limit, every reading, and the medians.
"""

import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _HERE / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(_HERE))
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h100_fused_path: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    sys.path.insert(0, str(Path(a.root).resolve()))
    import mgard_tpu_torch as M

    print(f"package {Path(M.__file__).resolve().parent}", flush=True)
    dev = torch.device("cuda:0")
    v = CS.bench_field(CS.N_MAIN, dev)
    fused = M.Config()
    fused.hybrid_fused_pack = True
    configs = {"main": (M.Config(), 1), "fused": (fused, 2)}
    for cfg, _ in configs.values():  # build, warm up, prime the sticky K
        M.decompress(M.compress(v, CS.TOL, config=cfg)[0], device=dev)
    ms = {name: ([], []) for name in configs}
    for _ in range(a.reps):
        for name, (cfg, flag) in configs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob, st = M.compress(v, CS.TOL, config=cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, st2 = M.decompress(blob, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            err = float((out - v).abs().max())
            if st or st2 or CS.section_head(blob)[0] != flag or \
                    not err <= CS.TOL:
                raise SystemExit(f"{name}: status {st}/{st2}, flag "
                                 f"{CS.section_head(blob)[0]}, L-inf {err}")
            ms[name][0].append((t1 - t0) * 1e3)
            ms[name][1].append((t2 - t1) * 1e3)
            del blob, out
    for name, (c, d) in ms.items():
        print(f"{name} compress ms {[round(x, 1) for x in c]}, median "
              f"{statistics.median(c):.1f}; decompress ms "
              f"{[round(x, 1) for x in d]}, median "
              f"{statistics.median(d):.1f}", flush=True)


if __name__ == "__main__":
    main()
