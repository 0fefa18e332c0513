"""Carry state from the JAX package into the port.

The system has no weights: the state that has to match across packages is
the configuration, the grid's coordinates and a region-of-interest mask
(and the hierarchy tables, which both packages compute in NumPy from
them). Streams are the main carrier: each package decodes the other's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .config import Config


def config_from_jax(fields: dict) -> Config:
    """``dataclasses.asdict(mgard_tpu.Config(...))`` -> the port's Config.
    Enum fields are rebuilt from their values (the packages share the
    values, which are wire ids); an unknown field raises."""
    cfg = Config()
    known = {f.name for f in dataclasses.fields(Config)}
    for name, value in fields.items():
        if name not in known:
            raise ValueError(f"unknown Config field {name!r}")
        default = getattr(cfg, name)
        if isinstance(default, enum.Enum):
            value = type(default)(int(value))
        elif isinstance(value, (list, tuple)):
            value = list(value)
        setattr(cfg, name, value)
    return cfg


def coords_to_host(coords) -> Optional[list]:
    """Per-axis node coordinates as either package takes them (NumPy, JAX
    or torch arrays, or lists) -> a list of float64 NumPy arrays, the form
    both ``compress(coords=...)`` accept and the header stores; None stays
    None (a uniform grid)."""
    if coords is None:
        return None
    return [np.asarray(_host(c), np.float64) for c in coords]


def mask_to_host(mask) -> Optional[np.ndarray]:
    """A region-of-interest node mask from either package -> a boolean
    NumPy array, the form both ``compress_roi(roi_mask=...)`` accept; None
    stays None (automatic detection)."""
    if mask is None:
        return None
    return np.asarray(_host(mask)).astype(bool)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
