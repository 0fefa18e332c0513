"""The XGC cell's coarse symbols: the port's unrounded level coefficients
against the plain L2 reference's, in units of each level's quantization
step, and what they give the cell's ``gap_mean_over_tol`` check.

    python3 scripts/h100_xgc_levels.py [--seeds 1290077606,7,...]
        [--timesteps 4] [--shape 8,39,16395,39] [--device cuda]
        [--limit 1e-6] [--fields-per-check 36] [--out FILE]

For every seed and timestep of the ``xgc4d_f64`` configuration's field
(``bench_torch/field.py``, made on the device), ``ops/refactor.decompose``
(the slice route at this shape) runs beside ``reference_l2.decompose``,
both in float64, under the configuration's REL tolerance at s = 0. The
reference's level-l residual, moved to the nested-box layout (on each axis
its ``coarse_positions`` first, then the other nodes in order), is compared
with the port's level-l coefficients, and level 0 with the port's leading
box. Per level, in units of the level's step (``reference_l2.steps``):

- ``max``: the largest |dt| between the two unrounded coefficients;
- ``sum``: the sum of |dt|, the expected number of symbols that round to
  the other side of an edge (a fraction spread evenly over a step lies
  within |dt| of an edge with probability |dt|);
- ``flips``: the symbols that do round apart.

Then one flip's size: one step at one node of each level, every other
coefficient 0, through ``reference_l2.recompose`` (the map is linear), as
the mean |output| over the absolute tolerance; the node is odd on every
axis and, apart, odd on the longest axis alone, and the larger reading is
kept (level 0: the middle node). With the levels' mean ``sum`` as Poisson
rates, the chance that one field's flips alone take ``gap_mean_over_tol``
past ``--limit`` follows, and for ``--fields-per-check`` fields. One JSON
line; ``--out`` keeps it. Runs on the card; ``--device cpu --shape
4,5,4200,5`` rehearses it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import field  # noqa: E402
import reference_l2 as RL  # noqa: E402
import registry  # noqa: E402
from reference import coarse_positions  # noqa: E402

from mgard_tpu_torch.hierarchy import get_hierarchy  # noqa: E402
from mgard_tpu_torch.ops import refactor  # noqa: E402

SEEDS = (1290077606, 7, 2147483659, 3141592653)


def _nested(r):
    """The level array ``r`` in the nested-box order: on each axis the
    coarse positions first, then the rest in order."""
    for d, n in enumerate(r.shape):
        keep = coarse_positions(n)
        rest = sorted(set(range(n)) - set(keep))
        r = r.index_select(d, torch.tensor(keep + rest, device=r.device))
    return r


def _coeff_mask(shape, coarse_shape, device):
    """True at the level box's coefficients: outside the leading coarse
    box."""
    inside = torch.ones(shape, dtype=torch.bool, device=device)
    for d, (n, nc) in enumerate(zip(shape, coarse_shape)):
        ax = torch.arange(n, device=device) < nc
        inside = inside & ax.reshape([-1 if e == d else 1
                                      for e in range(len(shape))])
    return ~inside


def level_gaps(x, tol: float, mode: str) -> list:
    """Per level, coarsest first: {max, sum, flips, n} of the port's
    unrounded coefficients against the reference's, in steps."""
    shape = tuple(x.shape)
    hier = get_hierarchy(shape, np.float64)
    abs_tol = tol * RL.rel_norm(x) if mode == "REL" else tol
    steps = RL.steps(shape, abs_tol)
    port = refactor.decompose(x, hier, True)
    parts = RL.decompose(x)
    shapes = RL.level_shapes(shape)
    if [tuple(s) for s in hier.level_shape] != shapes:
        raise AssertionError(f"hierarchies differ: {hier.level_shape} "
                             f"against {shapes}")
    out = []
    for l, (ref, q) in enumerate(zip(parts, steps)):
        box = port[tuple(slice(0, n) for n in shapes[l])]
        if l == 0:
            mine, theirs = box, ref
        else:
            mask = _coeff_mask(shapes[l], shapes[l - 1], x.device)
            mine, theirs = box[mask], _nested(ref)[mask]
        dt = ((mine - theirs) / q).abs()
        flips = int((RL.quantize(mine, q) != RL.quantize(theirs, q)).sum())
        out.append({"max": float(dt.max()), "sum": float(dt.sum()),
                    "flips": flips, "n": int(dt.numel())})
    return out


def _odd_mid(n: int) -> int:
    """The odd position nearest the middle of an axis of n > 2 nodes (a
    coefficient position at that level)."""
    i = n // 2
    return i if i % 2 == 1 else i - 1


def flip_sizes(shape, device) -> list:
    """Per level, the largest ``gap_mean_over_tol`` one flipped symbol
    gives: one step at one node, every other coefficient 0, recomposed."""
    shapes = RL.level_shapes(shape)
    steps = RL.steps(shape, 1.0)  # per unit absolute tolerance
    N = math.prod(shape)
    longest = max(range(len(shape)), key=lambda d: shape[d])
    sizes = []
    for l, ls in enumerate(shapes):
        if l == 0:
            nodes = [tuple(n // 2 for n in ls)]
        else:
            odd = tuple(_odd_mid(n) for n in ls)
            one = tuple(_odd_mid(n) if d == longest else 0
                        for d, n in enumerate(ls))
            nodes = [odd, one]
        worst = 0.0
        for node in nodes:
            parts = [torch.zeros(s, dtype=torch.float64, device=device)
                     for s in shapes]
            parts[l][node] = steps[l]
            out = RL.recompose(parts)
            worst = max(worst, float(out.abs().sum()) / N)
            del parts, out
        sizes.append(worst)
    return sizes


def p_exceed(rates, sizes, limit: float, top: int = 12) -> float:
    """P(sum_l n_l sizes_l > limit) for independent n_l ~ Poisson(rates_l):
    the chance that a field's flips alone pass the limit."""
    pmf = [[math.exp(-r) * r ** k / math.factorial(k) for k in range(top)]
           for r in rates]
    ok = 0.0
    for ns in itertools.product(range(top), repeat=len(rates)):
        if sum(n * s for n, s in zip(ns, sizes)) <= limit:
            ok += math.prod(p[n] for p, n in zip(pmf, ns))
    return max(0.0, 1.0 - ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--timesteps", type=int, default=4)
    ap.add_argument("--shape", default="8,39,16395,39")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--limit", type=float, default=1e-6)
    ap.add_argument("--fields-per-check", type=int, default=36)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: no readings", file=sys.stderr)
        return 3
    cfg = registry.config([BENCH], "xgc4d_f64")
    cfg["shape"] = [int(n) for n in args.shape.split(",")]
    shape = tuple(cfg["shape"])
    bound = cfg["error_bound"]
    tol, mode = float(bound["tol"]), bound["mode"]
    fields = []
    for seed in (int(s) for s in args.seeds.split(",") if s):
        for t in range(args.timesteps):
            x = field.make_field(cfg, seed, t, device)
            t0 = time.perf_counter()
            gaps = level_gaps(x, tol, mode)
            secs = time.perf_counter() - t0
            fields.append({"seed": seed, "t": t, "levels": gaps,
                           "s": round(secs, 3)})
            print(json.dumps(fields[-1]), file=sys.stderr, flush=True)
            del x
            if device.type == "cuda":
                torch.cuda.empty_cache()
    L = len(fields[0]["levels"])
    table = [{"level": l,
              "max": max(f["levels"][l]["max"] for f in fields),
              "sum_mean": sum(f["levels"][l]["sum"] for f in fields)
              / len(fields),
              "sum_max": max(f["levels"][l]["sum"] for f in fields),
              "flips": sum(f["levels"][l]["flips"] for f in fields),
              "n": fields[0]["levels"][l]["n"]} for l in range(L)]
    sizes = flip_sizes(shape, device)
    for row, s in zip(table, sizes):
        row["flip_gap_mean_over_tol"] = s
    p1 = p_exceed([r["sum_mean"] for r in table], sizes, args.limit)
    result = {"shape": list(shape), "fields": len(fields),
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "levels": table, "limit": args.limit,
              "p_field_exceeds": p1,
              "p_check_exceeds": 1.0 - (1.0 - p1) ** args.fields_per_check,
              "fields_per_check": args.fields_per_check}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
