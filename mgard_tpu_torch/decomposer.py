"""Domain decomposition for larger-than-memory inputs (port of
``mgard_tpu.decomposer``; free memory comes from the CUDA device the
input lives on).

Re-design of the reference DomainDecomposer
(reference: include/mgard-x/DomainDecomposer/DomainDecomposer.hpp:22-857):
decides whether an input must be split (estimated footprint vs available
device memory / config.max_memory_footprint), picks a strategy
(MaxDim: halve the largest dim until a chunk fits, :192-223;
Block: uniform D-dim blocks, :226-250; Variable: user sizes along one dim),
and exposes per-subdomain shapes/slices. Subdomains are halo-free and
independently compressed — the global error bound is preserved by local
tolerance rescaling (calc_local_abs_tol, ErrorToleranceCalculator.hpp:127-147).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import Config
from .dtypes import domain_decomposition_type, error_bound_type


def _block_axis_slices(s: int, bs: int) -> List[slice]:
    """Per-axis block boundaries; a size-1 tail (s % bs == 1) is absorbed
    into the previous block because a Hierarchy axis must be >= 2. Shared
    by the compress-side strategy and from_metadata so both sides slice
    identically."""
    bounds = list(range(0, s, bs)) + [s]
    if len(bounds) >= 3 and bounds[-1] - bounds[-2] == 1:
        del bounds[-2]
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


def estimate_memory_footprint(shape: Sequence[int], dtype) -> int:
    """Device-workspace estimate for compressing one (sub)domain.

    Counts the transform temporaries, int32 quantized copy and Huffman
    working set (mirrors the role of Compressor::EstimateMemoryFootprint,
    reference Compressor.hpp:88-120, with this pipeline's actual buffers).
    """
    n = int(np.prod(shape))
    elem = np.dtype(dtype).itemsize
    # v + interp + resid + reorder temporaries (~4 live T arrays), quantized
    # int32, huffman (C,K) working set ~6 int32 arrays
    return n * (4 * elem + 4 + 6 * 4)


def available_device_memory(device=None, default: int = 12 * 2**30) -> int:
    """Free memory of a CUDA ``device`` (90% of what CUDA reports free);
    the fixed ``default`` for the CPU or no device."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        free, _total = torch.cuda.mem_get_info(torch.device(device))
        return int(free * 0.9)
    return default


def calc_local_abs_tol(
    ebtype: error_bound_type, norm: float, tol: float, s: float, num_subdomain: int
) -> float:
    """Reference ErrorToleranceCalculator.hpp:127-147."""
    if ebtype == error_bound_type.REL:
        if math.isinf(s):
            return tol * norm
        return math.sqrt((tol * norm) ** 2 / num_subdomain)
    if math.isinf(s):
        return tol
    return math.sqrt(tol * tol / num_subdomain)


class DomainDecomposer:
    def __init__(
        self,
        shape: Sequence[int],
        dtype,
        config: Optional[Config] = None,
        available_memory: Optional[int] = None,
        device=None,
    ):
        self.shape = tuple(int(s) for s in shape)
        self.D = len(self.shape)
        self.dtype = np.dtype(dtype)
        self.config = config or Config()
        self._avail = (
            available_memory
            if available_memory is not None  # explicit 0 = maximal split
            else min(available_device_memory(device),
                     int(self.config.max_memory_footprint))
        )

        self.domain_decomposed = False
        self.domain_decomposed_dim = 0
        self.domain_decomposed_size = self.shape[0]
        ddt = self.config.domain_decomposition

        forced = ddt in (
            domain_decomposition_type.Block,
            domain_decomposition_type.Variable,
        )
        if not self._need(self.shape) and not forced:
            self._subdomains = [tuple(slice(0, s) for s in self.shape)]
            return

        self.domain_decomposed = True
        if ddt == domain_decomposition_type.MaxDim:
            self._strategy_max_dim()
        elif ddt == domain_decomposition_type.Block:
            self._strategy_block()
        else:
            self._strategy_variable()

    # ------------------------------------------------------------------
    def _need(self, shape) -> bool:
        return estimate_memory_footprint(shape, self.dtype) >= self._avail

    def _strategy_max_dim(self):
        shape = list(self.shape)
        dim = int(np.argmax(shape))
        self.domain_decomposed_dim = dim
        chunk = shape[dim]
        chunk_shape = list(shape)
        while self._need(chunk_shape) and chunk > 3:
            chunk = (chunk - 1) // 2 + 1
            chunk_shape[dim] = chunk
        self.domain_decomposed_size = chunk
        self._subdomains = []
        for start in range(0, shape[dim], chunk):
            end = min(start + chunk, shape[dim])
            if shape[dim] - end == 1:
                # a size-1 tail cannot form a Hierarchy (axis >= 2);
                # absorb the last node into this chunk instead
                end = shape[dim]
            sl = [slice(0, s) for s in shape]
            sl[dim] = slice(start, end)
            self._subdomains.append(tuple(sl))
            if end == shape[dim]:
                break

    def _strategy_block(self):
        bs = int(self.config.block_size)
        while True:
            chunk_shape = [min(bs, s) for s in self.shape]
            if not self._need(chunk_shape) or bs <= 3:
                break
            bs = (bs - 1) // 2 + 1
        self.domain_decomposed_size = bs
        grids = [_block_axis_slices(s, bs) for s in self.shape]
        self._subdomains = []
        import itertools

        for sls in itertools.product(*grids):
            self._subdomains.append(
                tuple(sls)
            )

    def _strategy_variable(self):
        dim = int(self.config.domain_decomposition_dim)
        sizes = list(self.config.domain_decomposition_sizes)
        if not sizes or sum(sizes) != self.shape[dim]:
            raise ValueError(
                "Variable decomposition requires domain_decomposition_sizes "
                f"summing to shape[{dim}]={self.shape[dim]}"
            )
        self.domain_decomposed_dim = dim
        self.domain_decomposed_size = max(sizes)
        self._subdomains = []
        start = 0
        for sz in sizes:
            sl = [slice(0, s) for s in self.shape]
            sl[dim] = slice(start, start + sz)
            self._subdomains.append(tuple(sl))
            start += sz

    # ------------------------------------------------------------------
    @property
    def num_subdomains(self) -> int:
        return len(self._subdomains)

    def subdomain_slices(self, i: int) -> Tuple[slice, ...]:
        return self._subdomains[i]

    def subdomain_shape(self, i: int) -> Tuple[int, ...]:
        return tuple(sl.stop - sl.start for sl in self._subdomains[i])

    def uniform_subdomain_shapes(self) -> bool:
        shapes = {self.subdomain_shape(i) for i in range(self.num_subdomains)}
        return len(shapes) == 1

    def extract(self, arr, i: int):
        return arr[self.subdomain_slices(i)]

    @classmethod
    def from_metadata(cls, shape, dtype, meta, config: Config) -> "DomainDecomposer":
        """Rebuild the exact decomposition from a compressed stream's header."""
        dd = cls.__new__(cls)
        dd.shape = tuple(int(s) for s in shape)
        dd.D = len(dd.shape)
        dd.dtype = np.dtype(dtype)
        dd.config = config
        dd.domain_decomposed = bool(meta.domain_decomposed)
        dd.domain_decomposed_dim = int(meta.domain_decomposed_dim)
        dd.domain_decomposed_size = int(meta.domain_decomposed_size)
        if not dd.domain_decomposed:
            dd._subdomains = [tuple(slice(0, s) for s in dd.shape)]
            return dd
        ddt = meta.ddtype
        chunk = dd.domain_decomposed_size
        if ddt == domain_decomposition_type.Variable and meta.dd_variable_sizes:
            dim = dd.domain_decomposed_dim
            dd._subdomains = []
            start = 0
            for sz in meta.dd_variable_sizes:
                sl = [slice(0, s) for s in dd.shape]
                sl[dim] = slice(start, start + int(sz))
                dd._subdomains.append(tuple(sl))
                start += int(sz)
            return dd
        if ddt == domain_decomposition_type.Block:
            import itertools

            grids = [_block_axis_slices(s, chunk) for s in dd.shape]
            dd._subdomains = [
                tuple(sls) for sls in itertools.product(*grids)
            ]
        else:  # MaxDim and Variable-as-recorded both slice one dim
            dim = dd.domain_decomposed_dim
            dd._subdomains = []
            for start in range(0, dd.shape[dim], chunk):
                end = min(start + chunk, dd.shape[dim])
                if dd.shape[dim] - end == 1:
                    # mirror _strategy_max_dim's size-1 tail absorption
                    end = dd.shape[dim]
                sl = [slice(0, s) for s in dd.shape]
                sl[dim] = slice(start, end)
                dd._subdomains.append(tuple(sl))
                if end == dd.shape[dim]:
                    break
        return dd
