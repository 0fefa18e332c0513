"""Carry configuration from the JAX package into the port.

The system has no weights: the state that has to match across packages is
the configuration (and the hierarchy tables, which both packages compute in
NumPy from it).
"""

from __future__ import annotations

import dataclasses
import enum

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
