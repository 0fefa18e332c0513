"""Per-axis split of the multigrid transform (port of the part of
``mgard_tpu/ops/axis.py`` that the dense-matrix fast path uses).

Axis-size convention (see hierarchy.py): a size-n axis coarsens to
n//2 + 1 nodes = the even indices plus, for even n, the last node.
"""

from __future__ import annotations

from . import _be


def split_axis(v, axis: int, nf: int):
    """Fine axis -> (coarse part, coefficient part).

    coarse = even indices (+ last node when nf even); coeff = the rest."""
    if nf % 2 == 1:
        coarse = _be.sl(v, axis, 0, nf, 2)
        coeff = _be.sl(v, axis, 1, nf, 2)
    else:
        coarse = _be.concat(
            [_be.sl(v, axis, 0, nf - 1, 2), _be.sl(v, axis, nf - 1, nf)], axis
        )
        coeff = _be.sl(v, axis, 1, nf - 2, 2)
    return coarse, coeff
