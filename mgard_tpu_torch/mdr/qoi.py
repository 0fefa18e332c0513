"""MDR QoI pipeline: error-controlled retrieval for derived quantities
(port of ``mgard_tpu/mdr/qoi.py``).

Variables are refactored independently; retrieval is planned jointly so that
a derived quantity's pointwise error bound (V_TOT = sqrt(x^2+y^2+z^2), whose
Euclidean-norm form is 1-Lipschitz in (x, y, z)) meets a target, with a
reconstruct -> evaluate bound -> escalate loop (reference:
MDRHighLevel/{QoIKernel.hpp:22-147, ReconstructPipelineQoI.hpp}).
"""

from __future__ import annotations

import heapq
import math
from typing import List, Sequence

import torch

from .api import MDReconstruct, RefactoredData, RefactoredMetadata
from .components import best_step, estimate_error


class VTotQoI:
    """V_TOT = sqrt(sum_i v_i^2): 1-Lipschitz in the variable vector, so the
    pointwise QoI error is bounded by sqrt(sum_i e_i^2) for per-variable
    pointwise bounds e_i."""

    def bound(self, per_var_errors: Sequence[float]) -> float:
        return math.sqrt(sum(e * e for e in per_var_errors))

    def eval(self, variables: Sequence) -> torch.Tensor:
        """V_TOT of tensors (or arrays), in float64 on their device."""
        vs = [torch.as_tensor(v) for v in variables]
        acc = torch.zeros(vs[0].shape, dtype=torch.float64,
                          device=vs[0].device)
        for v in vs:
            acc += v.to(torch.float64) ** 2
        return torch.sqrt(acc)

    def device_bound(self, variables: Sequence,
                     per_var_errors: Sequence[float]) -> float:
        """Data-dependent pointwise QoI error bound on the actual
        reconstructed fields, in float64 on their device and reduced to its
        max there (the reference's QoIKernel compute_bound_x_square per
        variable, summed, then compute_bound_square_root_x). Independent of
        the global bound(), so a plan built from inflated tables is still
        certified or rejected against real data."""
        vs = [torch.as_tensor(v) for v in variables]
        s2 = torch.zeros(vs[0].shape, dtype=torch.float64, device=vs[0].device)
        e2 = torch.zeros_like(s2)
        for v, eb in zip(vs, per_var_errors):
            eb = float(eb)
            av = v.to(torch.float64).abs()
            s2 = s2 + av * av
            e2 = e2 + 2.0 * av * eb + eb * eb
        b = torch.where(
            s2 == 0.0,
            torch.sqrt(e2),
            torch.where(
                s2 > e2,
                e2 / (torch.sqrt(torch.clamp(s2 - e2, min=0.0))
                      + torch.sqrt(s2)),
                e2 / torch.sqrt(torch.clamp(s2, min=1e-300)),
            ),
        )
        return float(b.max())


def plan_joint_retrieval(metas: Sequence[RefactoredMetadata], qoi_tol: float,
                         qoi=None, s: float = math.inf) -> List[List[int]]:
    """Jointly greedy plan across (variable, level) steps of one or more
    bitplanes (components.best_step) so the QoI bound over per-variable
    errors meets qoi_tol."""
    qoi = qoi or VTotQoI()
    V = len(metas)
    counts = [[0] * len(m.levels) for m in metas]
    B = metas[0].number_bitplanes

    def var_err(v):
        return estimate_error(metas[v], counts[v], s)

    def push(v, l):
        # rank steps by the metric the stopping bound uses
        m = metas[v]
        g, k = best_step(m.levels[l], counts[v][l], B,
                         getattr(m, "sign_rows", 1), math.isinf(s))
        heapq.heappush(heap, (-g, v, l, k))

    heap = []
    for v, m in enumerate(metas):
        for l in range(len(m.levels)):
            push(v, l)
    while heap and qoi.bound([var_err(v) for v in range(V)]) > qoi_tol:
        _, v, l, k = heapq.heappop(heap)
        counts[v][l] += k
        if counts[v][l] < B:
            push(v, l)
    return counts


def MDReconstructQoI(metas: Sequence[RefactoredMetadata],
                     datas: Sequence[RefactoredData], qoi_tol: float,
                     qoi=None, s: float = math.inf, max_rounds: int = 4,
                     device=None):
    """Reconstruct all variables on ``device`` (default the CUDA card) with
    a QoI-driven retrieval plan. Returns (variables, qoi_field,
    certified_bound, counts). The certificate is the smaller of the global
    Lipschitz bound and the data-dependent device bound; a plan that misses
    qoi_tol escalates (the reference's reconstruct -> check -> escalate
    loop)."""
    qoi = qoi or VTotQoI()
    counts = plan_joint_retrieval(metas, qoi_tol, qoi, s)
    tol_work = qoi_tol
    for _ in range(max_rounds):
        vars_ = [MDReconstruct(m, d, c, device=device).data
                 for m, d, c in zip(metas, datas, counts)]
        per_var = [estimate_error(m, c, s) for m, c in zip(metas, counts)]
        bound = qoi.bound(per_var)
        if hasattr(qoi, "device_bound"):
            bound = min(bound, qoi.device_bound(vars_, per_var))
        if bound <= qoi_tol:
            return vars_, qoi.eval(vars_), bound, counts
        used = counts  # the plan the returned fields were built from
        tol_work *= 0.5  # escalate
        counts = plan_joint_retrieval(metas, tol_work, qoi, s)
    # rounds exhausted: report the counts that produced vars_
    return vars_, qoi.eval(vars_), bound, used
