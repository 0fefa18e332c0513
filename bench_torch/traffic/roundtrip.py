"""Traffic kind `roundtrip`: one caller in a closed loop. A request is
``compress`` of a timestep field under the cell's bound and per-call
``Config`` options (the write), then ``decompress`` of that stream onto the
field's device (the read).

The bound is the configuration's ``error_bound``: ``tol``, ``s`` (a number
or "inf") and ``mode`` ("ABS" or "REL"). Cell parameters: ``config``
(Config fields by name; enum fields by member name) and ``mismatch_at``
(the gap to the reference, as a share of ``tol``, beyond which an element
counts as mismatched).
"""

from __future__ import annotations

import math

import torch

import reference
from traffic import RequestFailed, make_config, stat_gap


class Traffic:
    def __init__(self, program, params: dict, cfg: dict, device):
        self.M = program
        bound = cfg["error_bound"]
        self.tol, self.s = float(bound["tol"]), float(bound["s"])
        self.mode = program.error_bound_type[bound["mode"]]
        if bound["mode"] != "ABS" or not math.isinf(self.s):
            raise ValueError("the reference covers ABS bounds at s = inf")
        self.config = make_config(self.M, params.get("config", {}))
        if (self.config.decomposition != program.decomposition_type.Hybrid
                or int(self.config.num_local_refactoring_level) != 3):
            raise ValueError("the reference covers the Hybrid codec with "
                             "three local levels")
        self.mismatch_at = float(params["mismatch_at"])
        self.device = device

    def request(self, field, rec):
        M, nbytes = self.M, field.numel() * field.element_size()
        (blob, st), w = rec.call(
            "write", lambda: M.compress(field, self.tol, self.s, self.mode,
                                        config=self.config), nbytes)
        w["stream_bytes"] = len(blob)
        if st != M.compress_status_type.Success:
            raise RequestFailed(f"compress: {st}")
        (out, st2), r = rec.call(
            "read", lambda: M.decompress(blob, config=self.config,
                                         device=self.device), nbytes)
        r["stream_bytes"] = len(blob)
        if st2 != M.compress_status_type.Success:
            raise RequestFailed(f"decompress: {st2}")
        return out

    def check(self, out, field) -> dict:
        """Numbers of one kept request: the L-inf error over tol, and the
        share of elements further than mismatch_at * tol from the
        reference's reconstruction."""
        if tuple(out.shape) != tuple(field.shape) or not bool(
                torch.isfinite(out).all()):
            return {"linf_over_tol": math.inf, "mismatch_share": 1.0}
        x = field.to(torch.float64)
        linf = float((out.to(torch.float64) - x).abs().max()) / self.tol
        ref = reference.hybrid_roundtrip(field, self.tol)
        gap = stat_gap(out, ref, self.tol, self.mismatch_at)
        return {"linf_over_tol": linf, **gap}
