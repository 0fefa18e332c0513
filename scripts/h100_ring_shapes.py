"""Round trips of one benchmark cell in one process, with the shape of the
pinned ring (``utils/trace.py``'s ``PinnedRing``) switched between
requests: the write and read latencies each shape gives on the card's host,
beside the direct (pageable) copies.

    python3 scripts/h100_ring_shapes.py --cell nyx512.bfx.roundtrip \
        [--reps 25] [--seed 12345]

Each repetition runs one request of every shape, in alternating order, on
the cell's fields (``bench_torch``'s registry, traffic and field maker).
Prints one JSON line: ms quartiles (Q1, median, Q3) of the writes and of
the reads by shape. The shapes: no ring (every copy direct), and slots x
chunk with the staging threshold in brackets (the last one the shape
``trace`` ships).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "bench_torch"))
sys.path.insert(0, ROOT)

import clock  # noqa: E402
import field  # noqa: E402
import registry  # noqa: E402

import mgard_tpu_torch as M  # noqa: E402
from mgard_tpu_torch.utils import trace  # noqa: E402

MiB = 1 << 20
SHAPES = {"direct": None, "2 x 16 MiB (8 MiB)": (2, 16 * MiB, 8 * MiB),
          "2 x 16 MiB (16 MiB)": (2, 16 * MiB, 16 * MiB),
          "2 x 32 MiB (8 MiB)": (2, 32 * MiB, 8 * MiB),
          "4 x 32 MiB (8 MiB)": (4, 32 * MiB, 8 * MiB),
          "2 x 64 MiB (8 MiB)": (2, 64 * MiB, 8 * MiB),
          "2 x 64 MB (8 MiB)": (2, 64 * 10**6, 8 * MiB)}


def quartiles(v):
    return [round(x, 2) for x in statistics.quantiles(v, n=4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=12345)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the shapes are measured on the card's host",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    roots = [os.path.join(ROOT, "bench_torch")]
    cell = registry.cell(roots, args.cell)
    cfg = registry.config(roots, cell["config"])
    traffic = registry.traffic(roots, cell["traffic"]).Traffic(
        M, cell["params"], cfg, dev)
    pool = field.make_pool(cfg, args.seed, dev)
    rings = {name: s and (trace.PinnedRing(dev, s[1], s[0]), s[2])
             for name, s in SHAPES.items()}
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    for i in range(3):  # warm every shape of the cell
        traffic.request(pool[i % len(pool)], clock.Recorder(sync))
    ms = {"write": collections.defaultdict(list),
          "read": collections.defaultdict(list)}
    names = list(SHAPES)
    stage_min = trace.STAGE_MIN
    try:
        for rep in range(args.reps):
            for name in names if rep % 2 == 0 else names[::-1]:
                if rings[name] is None:
                    trace.STAGE_MIN = 1 << 62
                else:
                    trace._RINGS[dev], trace.STAGE_MIN = rings[name]
                rec = clock.Recorder(sync)
                traffic.request(pool[rep % len(pool)], rec)
                for c in rec.calls:
                    ms[c["kind"]][name].append(c["seconds"] * 1e3)
    finally:
        trace.STAGE_MIN = stage_min
    print(json.dumps({
        "cell": args.cell, "reps": args.reps,
        "card": torch.cuda.get_device_name(dev),
        "write_ms_q": {k: quartiles(v) for k, v in ms["write"].items()},
        "read_ms_q": {k: quartiles(v) for k, v in ms["read"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
