"""``device_get_prefix`` of ``mgard_tpu/lossless/huffman.py``; the Huffman
codecs are ROADMAP queue 1 item 11."""

from __future__ import annotations

import numpy as np

from ..utils.trace import to_host


def device_get_prefix(arr, n: int) -> np.ndarray:
    """Copy only the n leading elements of a tensor to the host. (The JAX
    package rounds n up to a bucket to bound recompiles; torch has none.)"""
    return to_host(arr[:n])
