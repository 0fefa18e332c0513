"""Readings that set a cell's limits: the program on a dozen seeds or more,
then the control on three or more, in one process, each a short window at
the cell's own size and load with the same comparison as a run.

    python3 bench_torch/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s>

The control is the program with its float32 matrix products in TF32, the
precision below the float32 the configurations state (the program turns
TF32 off for itself). One JSON line per seed: the seed, whether it ran the
control, and every number compared, the worst over the kept requests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: no readings", file=sys.stderr)
        return 3
    with open(os.path.join(run.REPO_ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    # TF32 stays on once set, so the program's seeds run first
    for tf32, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            r, numbers = run.run_cell(spec, args.workload, seed, args.seconds, False,
                             "cuda", t_start=time.perf_counter(), tf32=tf32)
            print(json.dumps({"seed": seed, "control": tf32,
                              "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"],
                              "numbers": numbers}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
