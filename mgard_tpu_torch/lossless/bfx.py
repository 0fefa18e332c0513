"""The helpers of ``mgard_tpu/lossless/bfx.py`` that the BFP codec imports.

The BFX codec itself (kernels K5/K6, the backend for streams under
``bfp.SB_PALLAS_MIN * 32`` symbols) is ROADMAP queue 1 item 8; until it is
ported, ``encode``/``decode`` raise. Packed words are int32 bit patterns:
torch lacks shifts on uint32, so logical right shifts mask the sign bits.
"""

from __future__ import annotations

import torch

BS = 32  # symbols per block

_BF_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_BF_SHIFTS = (16, 8, 4, 2, 1)


def _zigzag(d):
    """int32 symbols -> int32 bit patterns of the u32 zigzag code."""
    d = d.to(torch.int32)
    return (d << 1) ^ (d >> 31)


def _unzigzag(z):
    """int32 bit patterns of u32 zigzag codes -> int32 symbols. The halving
    shift is logical (mask off the sign-extended bit)."""
    z = z.to(torch.int32)
    return ((z >> 1) & 0x7FFFFFFF) ^ -(z & 1)


def _bit_transpose32(zt):
    """32x32 bit-matrix transpose along axis 0 of int32 zt (32, ...): row k
    holds symbol k of every block; on return row j holds plane j (bit k of
    output row j == bit j of input row k). Self-inverse 5-step butterfly;
    each mask clears the bits an arithmetic shift drags in."""
    for s, m in zip(_BF_SHIFTS, _BF_MASKS):
        g = 32 // (2 * s)
        x = zt.reshape((g, 2, s) + tuple(zt.shape[1:]))
        a = x[:, 0]
        b = x[:, 1]
        t = ((a >> s) ^ b) & m
        a = a ^ (t << s)
        b = b ^ t
        zt = torch.stack([a, b], dim=1).reshape(zt.shape)
    return zt


def _not_ported():
    raise NotImplementedError(
        "the BFX codec (kernels K5/K6) is not ported yet: ROADMAP queue 1 "
        "item 8. Streams of at least bfp.SB_PALLAS_MIN*32 symbols use BFP.")


def encode(symbols, config=None) -> bytes:
    _not_ported()


def decode(data: bytes, offset: int = 0, device="cpu"):
    _not_ported()
