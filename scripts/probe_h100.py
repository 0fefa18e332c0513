"""The three layout probes P1-P3 on an NVIDIA GPU (H100): every variant of
each probe against its plain PyTorch version, with its time and the least
time the card's memory allows, then the finding each probe was written for.

    python3 scripts/probe_h100.py

Builds the CUDA kernels of mgard_tpu_torch/csrc at first use (nvcc, sm_90a).
Exits nonzero without a CUDA device, or when a variant differs from its
plain version. The probes are the Hopper counterparts of
scripts/probe_dynwin.py, scripts/probe_strided_dma.py and
scripts/probe_u16.py; mgard_tpu_torch/probes.py describes them.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

QUESTIONS = {
    "dynwin": "P1: which placement should K2/K10 use for the residual "
              "planes, OR-ed shared windows or owner-computes rows?",
    "relayout": "P2: does staging the (sbc,128) -> (4 sbc,32) relayout "
                "through shared memory cost anything, and what do bank "
                "conflicts cost a thread-per-row reader?",
    "relayout_rev": "P2 (reverse): the (4 sbc,32) -> (sbc,128) copy.",
    "u16": "P3: does a u16-native register butterfly beat warp ballots for "
           "the cf stream of K2/K10 (and its mirror for K3/K11)?",
}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_h100: no CUDA device")
    from mgard_tpu_torch import probes

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    findings = probes.run_all("cuda")
    for probe, question in QUESTIONS.items():
        print(question)
        for f in (f for f in findings if f["probe"] == probe):
            lib = ("" if f["library_ms"] is None
                   else f", {probes.LIBRARY_CALL[probe]} "
                        f"{f['library_ms']:.4f} ms")
            print(f"  {probe} {f['shape']} {f['variant']}: equal to plain; "
                  f"{f['ms']:.4f} ms = {f['ms'] / f['bound_ms']:.2f}x the "
                  f"byte bound {f['bound_ms']:.4f} ms (plain "
                  f"{f['plain_ms']:.4f} ms{lib})")
    # the finding: the fastest variant of each probe at its production shape
    for probe in QUESTIONS:
        rows = [f for f in findings if f["probe"] == probe]
        big = [f for f in rows if f["shape"] == rows[-1]["shape"]]
        best = min(big, key=lambda f: f["ms"])
        others = ", ".join(f"{f['variant']} {f['ms'] / best['ms']:.2f}x"
                           for f in big if f is not best)
        print(f"finding {probe} at {best['shape']}: {best['variant']} is "
              f"fastest ({best['ms']:.4f} ms); {others}")


if __name__ == "__main__":
    main()
