"""Traffic kind `progressive`: one caller in a closed loop. A request is
``MDRefactor`` of a timestep field (the write), then one read per
tolerance of ``tols``, each from a fresh retrieval state: ``MDRequest``
plans the planes, ``MDReconstruct`` rebuilds the field on its device.

The planes per level are the configuration's ``bitplanes``. Cell
parameters: ``tols``, ``config`` (Config fields by name) and
``mismatch_at`` (the gap to the reference, as a share of each read's
tolerance, beyond which an element counts as mismatched).
"""

from __future__ import annotations

import math

import torch

import reference
from traffic import RequestFailed, make_config, stat_gap


def stored_bytes(meta, data) -> int:
    """Bytes a refactor stores: its metadata and every plane."""
    return len(meta.serialize()) + sum(len(p) for lv in data.planes
                                       for p in lv)


def needed_bytes(meta, data, counts) -> int:
    """Bytes of the stored planes a read of ``counts`` planes decodes: a
    level's sign plane and its first counts[l] magnitude planes."""
    sr = meta.sign_rows
    return sum(len(data.planes[l][p]) for l, c in enumerate(counts) if c > 0
               for p in range(sr + c))


class Traffic:
    def __init__(self, program, params: dict, cfg: dict, device):
        import mgard_tpu_torch.mdr as mdr

        self.M, self.mdr = program, mdr
        self.tols = [float(t) for t in params["tols"]]
        self.B = int(cfg["bitplanes"])
        self.config = make_config(program, dict(params.get("config", {}),
                                                total_num_bitplanes=self.B))
        self.mismatch_at = float(params["mismatch_at"])
        self.device = device

    def request(self, field, rec):
        mdr, nbytes = self.mdr, field.numel() * field.element_size()
        (meta, data), w = rec.call(
            "write", lambda: mdr.MDRefactor(field, self.config), nbytes)
        w["stream_bytes"] = stored_bytes(meta, data)
        reads = []
        for tol in self.tols:
            meta.prev_used = []

            def read():
                counts = mdr.MDRequest(meta, tol)
                return counts, mdr.MDReconstruct(meta, data, counts,
                                                 config=self.config,
                                                 device=self.device)

            (counts, out), r = rec.call("read", read, nbytes)
            meta.prev_used = []
            planned = mdr.retrieve_size(meta, counts)
            r["stream_bytes"] = planned
            if out.data is None:
                raise RequestFailed(f"MDReconstruct at tol {tol}: no data")
            reads.append((tol, list(counts), out.data, planned,
                          needed_bytes(meta, data, counts)))
        return reads

    def check(self, reads, field) -> dict:
        """Numbers of one kept request, the worst over its reads: the L-inf
        error over the read's tolerance, the share of elements further
        than mismatch_at * tol from the reference's read of the same
        planes, and the gap between the bytes planned and the bytes of the
        planes decoded."""
        x = field.to(torch.float64)
        coeffs, levels = reference.decompose(x)
        worst = {}
        for tol, counts, out, planned, needed in reads:
            if tuple(out.shape) != tuple(field.shape) or not bool(
                    torch.isfinite(out).all()):
                nums = {"linf_over_tol": math.inf, "mismatch_share": 1.0}
            else:
                nums = {"linf_over_tol":
                        float((out.to(torch.float64) - x).abs().max()) / tol}
                ref = reference.mdr_read(coeffs, levels, counts, self.B)
                nums.update(stat_gap(out, ref, tol, self.mismatch_at))
                del ref
            nums["planned_bytes_gap"] = abs(planned - needed)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
        return worst
