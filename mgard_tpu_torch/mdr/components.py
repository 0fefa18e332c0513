"""MDR component kit: interleavers, error estimators, size interpreter
(port of ``mgard_tpu/mdr/components.py``).

* Interleavers (reference: MDR-X/Interleaver/): a level's coefficients are
  the slab regions of the nested-box layout; each region is flattened in
  direct (row-major), blocked (4^D spatial tiles) or SFC (Morton) order by
  reshapes and permutes of the device tensor.
* Error estimators (reference: MDR-X/ErrorEstimator/): per-level
  per-bitplane error tables -> a global bound.
* GreedyBasedSizeInterpreter (reference: MDR-X/SizeInterpreter/): per-level
  bitplane counts by error reduction per byte, in steps of one or more
  planes, until the bound meets the tolerance.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..hierarchy import Hierarchy
from ..utils.trace import traced


def level_regions(hier: Hierarchy, l: int) -> List[Tuple[slice, ...]]:
    """Slab regions of level l in the nested-box layout."""
    D = hier.D
    if l == 0:
        return [tuple(slice(0, s) for s in hier.level_shape[0])]
    fine = hier.level_shape[l]
    coarse = hier.level_shape[l - 1]
    regions = []
    for mask in range(1, 2**D):
        sl = tuple(
            slice(coarse[d], fine[d]) if (mask >> d) & 1 else slice(0, coarse[d])
            for d in range(D)
        )
        if all(s.stop > s.start for s in sl):
            regions.append(sl)
    return regions


# Interleaver modes (reference: MDR-X/Interleaver/{Direct,Blocked,SFC}
# Interleaver.hpp). Blocked emits each region in BxBx..xB spatial tiles; a
# region whose dims don't all divide B falls back to direct order. SFC emits
# each region in Morton (Z) order; its dims must all be the same power of
# two, else the region falls back to blocked, then direct (the same
# deterministic rule on both sides).
INTERLEAVE_DIRECT = 0
INTERLEAVE_BLOCKED = 1
INTERLEAVE_SFC = 2
BLOCK_B = 4


def _blocked_ok(shape, B: int = BLOCK_B) -> bool:
    return len(shape) >= 2 and all(s % B == 0 and s >= B for s in shape)


def _sfc_ok(shape) -> bool:
    s0 = shape[0]
    return (
        len(shape) >= 2
        and s0 >= 2
        and (s0 & (s0 - 1)) == 0
        and all(s == s0 for s in shape)
    )


def _morton_fwd(box):
    """Morton-order ravel of a (2^k,)*D box: most significant bits of every
    dim first (dim 0 leading), then the next bits. One halving step at a
    time, so no tensor has more than 2D+1 dims (the JAX package transposes
    all k*D bit axes at once)."""
    D = box.ndim
    s = int(box.shape[0])
    x = box.reshape((1,) + (s,) * D)
    while s > 1:
        s //= 2
        g = x.shape[0]
        x = x.reshape((g,) + (2, s) * D)
        perm = (0,) + tuple(1 + 2 * d for d in range(D)) \
            + tuple(2 + 2 * d for d in range(D))
        x = x.permute(perm).reshape((g * 2**D,) + (s,) * D)
    return x.reshape(-1)


def _morton_inv(flat, shape):
    shape = tuple(int(s) for s in shape)
    D = len(shape)
    n = shape[0]
    s = 1
    x = flat.reshape((flat.numel(),) + (1,) * D)
    while s < n:
        g = x.shape[0] // 2**D
        x = x.reshape((g,) + (2,) * D + (s,) * D)
        perm = [0]
        for d in range(D):
            perm += [1 + d, 1 + D + d]
        s *= 2
        x = x.permute(perm).reshape((g,) + (s,) * D)
    return x.reshape(shape)


def region_interleave(box, mode: int):
    """Flatten one region box in the selected interleave order."""
    shape = tuple(int(s) for s in box.shape)
    if mode == INTERLEAVE_SFC:
        if _sfc_ok(shape):
            return _morton_fwd(box)
        mode = INTERLEAVE_BLOCKED  # deterministic fallback chain
    if mode == INTERLEAVE_BLOCKED and _blocked_ok(shape):
        D = len(shape)
        split = []
        for s in shape:
            split += [s // BLOCK_B, BLOCK_B]
        x = box.reshape(split)
        perm = tuple(range(0, 2 * D, 2)) + tuple(range(1, 2 * D, 2))
        return x.permute(perm).reshape(-1)
    return box.reshape(-1)


def region_deinterleave(flat, shape, mode: int):
    """Inverse of region_interleave -> tensor of `shape`."""
    shape = tuple(int(s) for s in shape)
    if mode == INTERLEAVE_SFC:
        if _sfc_ok(shape):
            return _morton_inv(flat, shape)
        mode = INTERLEAVE_BLOCKED
    if mode == INTERLEAVE_BLOCKED and _blocked_ok(shape):
        D = len(shape)
        grid = [s // BLOCK_B for s in shape]
        x = flat.reshape(tuple(grid) + (BLOCK_B,) * D)
        perm = []
        for d in range(D):
            perm += [d, D + d]
        return x.permute(perm).reshape(shape)
    return flat.reshape(shape)


def interleave_level(dec, hier: Hierarchy, l: int,
                     mode: int = INTERLEAVE_DIRECT):
    """Extract level l's coefficients as one flat stream."""
    parts = [region_interleave(dec[r], mode) for r in level_regions(hier, l)]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def deinterleave_level(out, stream, hier: Hierarchy, l: int,
                       mode: int = INTERLEAVE_DIRECT):
    """Write a flat level stream back into the nested-box tensor `out` (in
    place)."""
    off = 0
    for r in level_regions(hier, l):
        shape = tuple(s.stop - s.start for s in r)
        n = int(np.prod(shape))
        out[r] = region_deinterleave(stream[off:off + n], shape, mode)
        off += n
    return out


def level_num_elems(hier: Hierarchy, l: int) -> int:
    if l == 0:
        return int(np.prod(hier.level_shape[0]))
    return int(np.prod(hier.level_shape[l])) - int(np.prod(hier.level_shape[l - 1]))


# ----------------------------------------------------------------------
# Error estimation + greedy retrieval planning (host)
# ----------------------------------------------------------------------
def estimate_error(meta, counts: Sequence[int], s: float) -> float:
    """Global error bound when using counts[l] magnitude planes per level.

    L-inf (s=inf): sum over levels of per-level max errors (hierarchical
    prolongation is a partition of unity -> amplification <= 1 per level;
    the L2-orthogonal basis also routes coefficient errors through the
    correction operator, bounded by a factor 2). L2 (s finite): triangle
    inequality over levels, each level's coefficient-domain error amplified
    by its basis functions' footprint on the finest grid (~2^{D(L-l)}
    nodes per coefficient), normalized to an RMS bound.
    """
    if math.isinf(s):
        tot = float(sum(m.err_max[c] for m, c in zip(meta.levels, counts)))
        if getattr(meta, "orthogonal", False):
            tot *= 2.0
        return tot
    L = len(meta.levels) - 1
    D = len(meta.shape)
    total = 0.0
    for l, (m, c) in enumerate(zip(meta.levels, counts)):
        amp = 2.0 ** (D * (L - l))
        total += math.sqrt(float(m.err_sq[c]) * amp)
    return total / math.sqrt(meta.total_num_elems)


def best_step(lm, b: int, B: int, sign_rows: int, inf_norm: bool):
    """A level's best next step from b magnitude planes held: (error
    reduction per byte, planes in the step), the maximum over k of
    (err[b] - err[b+k]) / bytes(planes b..b+k-1), the sign plane's bytes
    added when b == 0; the shortest step wins a tie. A plane that reduces
    nothing by itself (the first magnitude plane is empty: the level
    exponent keeps the fixed point under 2^(B-1)) is thus spanned by a
    longer step, not waited out."""
    err = lm.err_max if inf_norm else lm.err_sq
    cost = lm.plane_sizes[0] if (b == 0 and sign_rows) else 0
    best_gain, best_k = -math.inf, 1
    for k in range(1, B - b + 1):
        cost += lm.plane_sizes[b + k - 1 + sign_rows]
        g = float(err[b] - err[b + k]) / max(cost, 1)
        if g > best_gain:
            best_gain, best_k = g, k
    return best_gain, best_k


@traced("codec.plan")
def interpret_retrieve_size(meta, tol: float, s: float) -> List[int]:
    """Greedy (error reduction / byte) plane selection: per-level magnitude
    plane counts whose estimated global error is <= tol (or every plane).
    Each level offers its best step of one or more planes (best_step), and
    taking a candidate takes the whole step. The JAX package offers one
    plane per level, ranked by that plane alone, and so reads each level to
    its last plane before it opens the next; its plans meet the same bound
    with more bytes."""
    L = len(meta.levels)
    counts = [0] * L
    B = meta.number_bitplanes
    sr = getattr(meta, "sign_rows", 1)
    inf_norm = math.isinf(s)

    def push(l):
        g, k = best_step(meta.levels[l], counts[l], B, sr, inf_norm)
        heapq.heappush(heap, (-g, l, k))

    heap = []
    for l in range(L):
        push(l)
    while heap and estimate_error(meta, counts, s) > tol:
        _, l, k = heapq.heappop(heap)
        counts[l] += k
        if counts[l] < B:
            push(l)
    return counts
