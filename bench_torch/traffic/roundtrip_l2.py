"""Traffic kind `roundtrip_l2`: one caller in a closed loop. A request is
``compress`` of a timestep field under the configuration's s = 0 bound
with the cell's ``Config`` options (the write), then ``decompress`` of that
stream onto the field's device (the read): the raw MultiDim path with the
L2 correction and the level-volume quantizer.

The bound is the configuration's ``error_bound``: ``tol``, ``mode`` ("ABS"
or "REL") and ``s``, which the plain reference (reference_l2.py) covers at
0 only. Cell parameters: ``config`` (Config fields by name) and
``mismatch_at`` (the gap to the reference, as a share of the finest level's
quantization step, beyond which an element counts as mismatched).

Each call's record keeps the change of every counter of the program over
the call (``counters``: read before and after it, outside its timing), for
the per-layer metrics that read them; a counter the program lacks is not
there.

The control. Under ``bench_torch/control.py``'s switch (float32 matrix
products allowed in TF32, set before this kind is made) the requests run
the program on the field's float32 image, the precision below the float64
the configuration states, with TF32 turned back off so the control is
plain float32; the comparison is the same.
"""

from __future__ import annotations

import math

import torch

import reference_l2
from traffic import RequestFailed, make_config

try:
    from mgard_tpu_torch.utils import trace as _trace
except ImportError:  # a program without counters
    _trace = None


def _counters() -> dict:
    return _trace.counters() if _trace is not None else {}


def _delta(before: dict, after: dict) -> dict:
    """Every counter the program has, with its change (0 included)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


class Traffic:
    def __init__(self, program, params: dict, cfg: dict, device):
        self.M = program
        bound = cfg["error_bound"]
        self.tol, self.s = float(bound["tol"]), float(bound["s"])
        self.mode_name = bound["mode"]
        self.mode = program.error_bound_type[self.mode_name]
        if self.s != 0.0:
            raise ValueError("the reference covers s = 0 (s = inf is the "
                             "roundtrip kind)")
        self.config = make_config(self.M, params.get("config", {}))
        self.mismatch_at = float(params["mismatch_at"])
        self.device = device
        self.image = None
        if torch.backends.cuda.matmul.allow_tf32:
            self.image = torch.float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")

    def _call(self, rec, kind, fn, nbytes):
        before = _counters()
        out, r = rec.call(kind, fn, nbytes)
        r["counters"] = _delta(before, _counters())
        return out, r

    def request(self, field, rec):
        M, nbytes = self.M, field.numel() * field.element_size()
        x = field if self.image is None else field.to(self.image)
        (blob, st), w = self._call(
            rec, "write", lambda: M.compress(x, self.tol, self.s, self.mode,
                                             config=self.config), nbytes)
        w["stream_bytes"] = len(blob)
        if st != M.compress_status_type.Success:
            raise RequestFailed(f"compress: {st}")
        (out, st2), r = self._call(
            rec, "read", lambda: M.decompress(blob, config=self.config,
                                              device=self.device), nbytes)
        r["stream_bytes"] = len(blob)
        if st2 != M.compress_status_type.Success:
            raise RequestFailed(f"decompress: {st2}")
        return out

    def check(self, out, field) -> dict:
        """Numbers of one kept request: the error's L2 norm over the bound
        (tol, times the field's norm under REL), the share of elements
        further than mismatch_at finest steps from the reference's
        reconstruction, and the mean gap to it over the absolute
        tolerance."""
        if tuple(out.shape) != tuple(field.shape) or not bool(
                torch.isfinite(out).all()):
            return {"l2_over_tol": math.inf, "mismatch_share": 1.0,
                    "gap_mean_over_tol": math.inf}
        x = field.to(torch.float64)
        ref, abs_tol, step = reference_l2.roundtrip(x, self.tol,
                                                    self.mode_name)
        out = out.to(torch.float64)
        l2 = reference_l2.l2_norm(out - x) / abs_tol
        gap = (out - ref).abs_()
        del ref
        return {"l2_over_tol": l2,
                "mismatch_share": float((gap > self.mismatch_at * step)
                                        .sum()) / gap.numel(),
                "gap_mean_over_tol": float(gap.mean()) / abs_tol}
