"""K14's host side: the MultiDim transform of a 3D field on a CUDA card.

``ops/refactor.py::decompose`` / ``recompose`` hand a 3D field on a CUDA
device here, in either type and basis, on any coordinates; everything else
keeps the dense operators and the slice path there, which are K14's plain
versions (the CPU's route, and the one the tests hold against the JAX
package). One call of ``csrc/multidim.cu`` runs one level step: for
``decompose`` the residual pass and, in the L2 basis, the correction
(restriction along each axis, then Thomas sweeps); for ``recompose`` the
correction, then the interpolation pass.

Layout: the output is the nested-box array of the dense path. The
residuals of level l go straight to their reordered positions in it; the
coarse values of each level go to a compact buffer of their own (two,
used in turn), which is the next level's input, and at level 1 to the
leading box. So no pass reads what another thread of the same pass writes,
and nothing moves a whole level box again (the dense path's ``update_box``
clones the whole array a level).

Tables: per level and axis the lerp weights, the 5-point mass and
restriction stencil of each coarse node (built in float64 from the
hierarchy's ``h_ext``, ``rw_left``, ``rw_right``) and the Thomas factors,
in the field's type: O(n) a level. They go to the device once per
(hierarchy, device) and stay on the hierarchy (uniform hierarchies are
cached by ``get_hierarchy``), so after the first call a transform copies
nothing up.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..hierarchy import AxisLevel, Hierarchy
from ..utils.trace import count, to_device

_CACHE = "_k14_tables"


def takes(hier: Hierarchy, device) -> bool:
    """K14 runs the transform of a field of ``hier`` on ``device``: a 3D
    field on a CUDA device."""
    return hier.D == 3 and torch.device(device).type == "cuda"


def axis_table(al: AxisLevel, dtype) -> np.ndarray:
    """One axis of one level step: [wl, wr (ncoef) | W (nc, 5) | f, binv, g
    (nc)] in ``dtype``. W[j, q] weighs the extended node 2j + q - 2 in
    coarse node j's mass-and-restriction sum (``axis.mass_restrict_axis``:
    out_j = m_2j + rw_left_j m_2j-1 + rw_right_j m_2j+1, with
    m_e = h_e-1/6 r_e-1 + (h_e-1 + h_e)/3 r_e + h_e/6 r_e+1)."""
    nf, nc = al.n_fine, al.n_coarse
    t = al.lerp_t.astype(np.float64)
    h = al.h_ext.astype(np.float64)
    hl = np.concatenate([[0.0], h])  # h_{e-1}, length n_ext
    hr = np.concatenate([h, [0.0]])  # h_e
    # the stencil of m_e on the extended grid (2 nc - 1 nodes: a level
    # step's axis has nf >= 3), zero outside it
    pad = lambda a: np.concatenate([[0.0], a, [0.0]])  # noqa: E731
    a, b, c = pad(hl / 6.0), pad((hl + hr) / 3.0), pad(hr / 6.0)
    e = 2 * np.arange(nc) + 1  # index of m_2j in the padded arrays
    rl = al.rw_left.astype(np.float64)
    rr = al.rw_right.astype(np.float64)
    W = np.stack([rl * a[e - 1],
                  rl * b[e - 1] + a[e],
                  rl * c[e - 1] + b[e] + rr * a[e + 1],
                  c[e] + rr * b[e + 1],
                  rr * c[e + 1]], axis=1)
    parts = [1.0 - t, t, W.ravel(), al.fwd_f, al.bwd_binv, al.bwd_g]
    return np.concatenate([np.asarray(p, np.float64) for p in parts]
                          ).astype(dtype)


def level_table(hier: Hierarchy, l: int) -> np.ndarray:
    """The table of level step l (fine level l -> l - 1): axes 0, 1, 2."""
    return np.concatenate([axis_table(al, hier.dtype)
                           for al in hier.axis[l - 1]])


def _tables(hier: Hierarchy, device) -> list:
    """Every level's table on ``device`` (index l - 1), copied up once per
    (hierarchy, device) and counted then in ``transform.put_bytes``."""
    cache = hier.__dict__.setdefault(_CACHE, {})
    key = str(torch.device(device))
    if key not in cache:
        host = [level_table(hier, l) for l in range(1, hier.l_target + 1)]
        flat = to_device(np.concatenate(host), device)
        count("transform.put_bytes", flat.nbytes)
        cache[key] = list(torch.split(flat, [h.size for h in host]))
    return cache[key]


def scratch_elems(hier: Hierarchy) -> int:
    """Elements of the correction's scratch at the finest level: the
    restrictions along axis 0 (nc0, nf1, nf2), axis 1 (nc0, nc1, nf2) and
    axis 2 (nc0, nc1, nc2), back to back."""
    (f0, f1, f2) = hier.level_shape[hier.l_target]
    (c0, c1, c2) = hier.level_shape[hier.l_target - 1]
    return c0 * f1 * f2 + c0 * c1 * f2 + c0 * c1 * c2


def _buffers(hier: Hierarchy, like) -> list:
    """The two compact coarse-value buffers: level L - 1's box, and level
    L - 2's (empty where no level needs it)."""
    L = hier.l_target
    sizes = [math.prod(hier.level_shape[L - 1]) if L >= 2 else 0,
             math.prod(hier.level_shape[L - 2]) if L >= 3 else 0]
    return [like.new_empty(n) for n in sizes]


def _check_level(name, t, n, like):
    if (t.dtype != like.dtype or t.device != like.device
            or not t.is_contiguous() or t.numel() < n):
        raise ValueError(f"{name}: expected a contiguous {like.dtype} tensor "
                         f"of at least {n} elements on {like.device}")


def decompose_level(src, out, cd, cstr, tab, scr, nf, orthogonal: bool):
    """K14 wrapper, one decompose level step: the compact fine box ``src``
    (shape ``nf``) -> residuals into ``out`` (its strides) at their
    nested-box positions, coarse values (+ correction) into ``cd`` (strides
    ``cstr``, unit last)."""
    nc = tuple(n // 2 + 1 for n in nf)
    _check_level("src", src, math.prod(nf), out)
    _check_level("tab", tab, 0, out)
    if orthogonal:
        _check_level("scr", scr, nc[0] * nf[1] * nf[2]
                     + nc[0] * nc[1] * (nf[2] + nc[2]), out)
    kernels.launch("multidim_decompose", src.data_ptr(), out.data_ptr(),
                   out.stride(0), out.stride(1), cd.data_ptr(), cstr[0],
                   cstr[1], tab.data_ptr(), scr.data_ptr(), *nf,
                   int(orthogonal), int(out.dtype == torch.float64),
                   kernels.stream(out.device))


def recompose_level(dec, c, dst, tab, scr, nf, orthogonal: bool):
    """K14 wrapper, one recompose level step: the compact coarse box ``c``
    (the correction taken off in place) and the residuals of ``dec`` (its
    strides) -> the compact fine box ``dst`` (shape ``nf``)."""
    nc = tuple(n // 2 + 1 for n in nf)
    _check_level("c", c, math.prod(nc), dec)
    _check_level("dst", dst, math.prod(nf), dec)
    if orthogonal:
        _check_level("scr", scr, nc[0] * nf[1] * nf[2]
                     + nc[0] * nc[1] * (nf[2] + nc[2]), dec)
    kernels.launch("multidim_recompose", dec.data_ptr(), dec.stride(0),
                   dec.stride(1), c.data_ptr(), dst.data_ptr(),
                   tab.data_ptr(), scr.data_ptr(), *nf, int(orthogonal),
                   int(dec.dtype == torch.float64),
                   kernels.stream(dec.device))


def decompose(v, hier: Hierarchy, orthogonal: bool):
    """The full decomposition of the 3D field ``v``, finest level first, in
    the nested-box layout: one K14 call a level."""
    L = hier.l_target
    if L == 0:
        return v
    v = v.contiguous()
    tabs = _tables(hier, v.device)
    out = torch.empty_like(v)
    scr = v.new_empty(scratch_elems(hier) if orthogonal else 0)
    bufs = _buffers(hier, v)
    src = v
    for l in range(L, 0, -1):
        nc = hier.level_shape[l - 1]
        if l == 1:
            cd, cstr = out, out.stride()[:2]
        else:
            cd, cstr = bufs[(L - l) % 2][:math.prod(nc)], (nc[1] * nc[2],
                                                           nc[2])
        decompose_level(src, out, cd, cstr, tabs[l - 1], scr,
                        hier.level_shape[l], orthogonal)
        src = cd
    return out


def recompose(dec, hier: Hierarchy, orthogonal: bool):
    """Inverse of ``decompose``, coarsest level first."""
    L = hier.l_target
    if L == 0:
        return dec
    dec = dec.contiguous()
    tabs = _tables(hier, dec.device)
    out = torch.empty_like(dec)
    scr = dec.new_empty(scratch_elems(hier) if orthogonal else 0)
    bufs = _buffers(hier, dec)
    s0 = hier.level_shape[0]
    c = dec[:s0[0], :s0[1], :s0[2]].clone(
        memory_format=torch.contiguous_format).reshape(-1)
    for l in range(1, L + 1):
        nf = hier.level_shape[l]
        dst = out if l == L else bufs[(L - 1 - l) % 2][:math.prod(nf)]
        recompose_level(dec, c, dst, tabs[l - 1], scr, nf, orthogonal)
        c = dst
    return out
