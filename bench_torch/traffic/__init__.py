"""Traffic kinds, one module each, found by the cell's ``traffic`` name.

A module defines ``Traffic(program, params, cfg, device)`` with
``request(field, recorder)`` (one request: its calls go through the
recorder; returns what the check needs, or raises RequestFailed) and
``check(kept, field)`` (a dict of the numbers compared for one kept
request). The helpers below are shared by the kinds.
"""

from __future__ import annotations

import enum

import torch


class RequestFailed(RuntimeError):
    """A call of a request returned a failure status."""


def make_config(program, options: dict):
    """A program Config with the named fields set (an enum field takes its
    member name)."""
    cfg = program.Config()
    for k, v in options.items():
        cur = getattr(cfg, k)
        if isinstance(cur, enum.Enum):
            v = type(cur)[v]
        setattr(cfg, k, v)
    return cfg


def stat_gap(out, ref, tol: float, mismatch_at: float) -> dict:
    """Gap between the program's output and the reference's, over tol:
    the share of elements beyond mismatch_at * tol, the mean and the
    largest."""
    gap = (out.to(torch.float64) - ref).abs()
    return {"mismatch_share": float((gap > mismatch_at * tol).sum())
            / gap.numel(),
            "gap_mean_over_tol": float(gap.mean()) / tol,
            "gap_max_over_tol": float(gap.max()) / tol}
