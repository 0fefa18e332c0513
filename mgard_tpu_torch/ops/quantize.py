"""Error-bound-driven levelwise linear quantization to raw int32 symbols
(port of the dense no-outlier path of ``mgard_tpu/ops/quantize.py``).

One elementwise pass over the nested-box decomposed array: each node is
multiplied by the reciprocal step of its level (times sqrt(level volume)
when s != inf) and rounded half away from zero to an int32 symbol. The raw
symbol backends (BFX, BFP) carry any int32 magnitude in-stream, so there is
no dictionary shift and no outlier side list (``quantize_with_scales`` and
the outlier capture serve the Huffman-class backends, which are not ported
yet).

The per-level factors are computed on the host in float64 and cast to the
field's type, the order the JAX package computes them in, so equal
coefficients give equal symbols in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchy import Hierarchy

_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


def node_levels(hier: Hierarchy, device="cpu"):
    """Per-node level in the nested-box layout: max over dims of the per-axis
    level marks (reference: LinearQuantization.hpp:78-82). int64, of
    hier.shape, on `device`."""
    lvl = None
    for d in range(hier.D):
        shape = [1] * hier.D
        shape[d] = hier.shape[d]
        marks = torch.as_tensor(hier.level_marks[d], device=device).reshape(
            shape)
        lvl = marks if lvl is None else torch.maximum(lvl, marks)
    return lvl.expand(hier.shape).long()


def _scales(hier: Hierarchy, quantizers, s_inf: bool, reciprocal: bool,
            dtype) -> np.ndarray:
    """Per-level multiplicative factors (host NumPy, float64 arithmetic,
    cast to `dtype`): quantize factor = sqrt(level volume)/q_l (volume only
    when s != inf); the dequantize factor is its reciprocal."""
    q = np.asarray(quantizers, np.float64)
    if s_inf:
        scale = 1.0 / q if reciprocal else q
    else:
        vol = np.asarray(hier.vol_sqrt, np.float64)
        scale = vol / q if reciprocal else q / vol
    return scale.astype(dtype)


def _scales_dense(hier: Hierarchy, quantizers, s_inf: bool, reciprocal: bool,
                  dtype, device):
    """Per-node scale factors. s = inf: the per-level steps are all equal
    (reference CalcQuantizers, LinearQuantization.hpp:234-298), so the
    scale is one scalar (a Python float holding the `dtype` value). Finite
    s: the level table looked up per node."""
    tab = _scales(hier, quantizers, s_inf, reciprocal, dtype)
    if s_inf:
        return float(tab[0])
    return torch.as_tensor(tab, device=device)[node_levels(hier, device)]


def _mult(step_mult, dtype, device):
    return torch.as_tensor(step_mult, device=device).to(dtype)


def quantize_symbols(dec, hier: Hierarchy, quantizers, s_inf: bool,
                     step_mult=None):
    """Quantize a decomposed (nested-box) array to raw int32 symbols.
    step_mult: optional per-node reciprocal-step multiplier (> 1 = finer
    quantization), used by ROI compression."""
    np_dtype = np.dtype(hier.dtype)
    scale = _scales_dense(hier, quantizers, s_inf, True, np_dtype, dec.device)
    if step_mult is not None:
        scale = scale * _mult(step_mult, dec.dtype, dec.device)
    t = dec * scale
    # round half away from zero: trunc(t -+ 0.5), never torch.round
    return torch.trunc(torch.where(t < 0, t - 0.5, t + 0.5)).to(torch.int32)


def dequantize_symbols(sym, hier: Hierarchy, quantizers, s_inf: bool,
                       step_mult=None):
    """Inverse of quantize_symbols (symbols -> decomposed array in the
    hierarchy's type)."""
    np_dtype = np.dtype(hier.dtype)
    work = _TORCH[np_dtype]
    scale = _scales_dense(hier, quantizers, s_inf, False, np_dtype,
                          sym.device)
    if step_mult is not None:
        scale = scale / _mult(step_mult, work, sym.device)
    return sym.reshape(hier.shape).to(work) * scale
