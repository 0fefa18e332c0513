"""Timestep fields of a configuration, made on the device from the seed.

The generator is bench.py's smooth multi-mode field, rewritten in torch:
v = sum_i amp_i * sin(2 pi (kx_i x + ky_i y + kz_i z) + phase_i) on the unit
cube, with bench.py's wave vectors, amplitudes and phases (fixed by the
configuration file). Timestep t advances mode i's phase by t *
phase_step_i, as a simulation's successive outputs drift. The seed draws a
shift (a torch.Generator on the field's device) that translates the
periodic field: every seed gives the codec the same field up to where the
grid samples it, so the same spectral content and the same work.
"""

from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def phases(gen_cfg: dict, seed: int, ndim: int, device) -> list:
    """Each mode's phase for ``seed``: its own, plus 2 pi k . shift for
    the seed's shift in [0, 1)^ndim."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    shift = torch.rand(ndim, generator=g, device=device,
                       dtype=torch.float64).tolist()
    return [m["phase"] + 2.0 * math.pi * sum(k * s for k, s in
                                             zip(m["k"], shift))
            for m in gen_cfg["modes"]]


def make_field(cfg: dict, seed: int, t: int, device) -> torch.Tensor:
    """Timestep ``t`` of the configuration's field for ``seed``."""
    gen = cfg["generator"]
    if gen["kind"] != "multimode_sin":
        raise ValueError(f"unknown generator {gen['kind']!r}")
    shape = tuple(int(n) for n in cfg["shape"])
    dtype = _DTYPES[cfg["dtype"]]
    axes = [torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
            for n in shape]
    grids = [a.reshape([-1 if d == i else 1 for d in range(len(shape))])
             for i, a in enumerate(axes)]
    ph = phases(gen, seed, len(shape), device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    for (mode, step, p) in zip(gen["modes"], gen["phase_step"], ph):
        arg = sum(k * g for k, g in zip(mode["k"], grids))
        v += mode["amp"] * torch.sin(2.0 * math.pi * arg + (p + t * step))
    return v


def make_pool(cfg: dict, seed: int, device) -> list:
    """The configuration's ``timesteps`` fields for ``seed``."""
    return [make_field(cfg, seed, t, device)
            for t in range(int(cfg["timesteps"]))]
