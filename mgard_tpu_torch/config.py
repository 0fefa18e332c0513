"""Runtime configuration of the PyTorch port.

The same fields, defaults and enum values as ``mgard_tpu.config.Config``, so
one set of knobs drives both packages (``interop.config_from_jax``). Fields
that only the JAX package reads (mesh, Huffman knobs) are carried
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .dtypes import (
    bitplane_encoding_type,
    block_delta_mode_type,
    compressor_type,
    decomposition_type,
    domain_decomposition_type,
    lossless_type,
)

_UNLIMITED = 2**63 - 1


@dataclasses.dataclass
class Config:
    # --- compression pipeline selection -------------------------------
    compressor: compressor_type = compressor_type.MGARD
    # Hybrid decomposition (blockwise 8^3 local refactor + multilevel
    # transform of the corner remainder, reference
    # HybridHierarchyCompressor) with the BFP width-sorted prefix codec.
    # Every choice is recorded in the self-describing header.
    decomposition: decomposition_type = decomposition_type.Hybrid
    lossless: lossless_type = lossless_type.BFP
    # float64 input whose L-inf budget covers the f64->f32 cast error is
    # compressed as its float32 image with that error deducted from the
    # tolerance (a "demoted" stream: float32 payload, float64 header).
    f64_demote: bool = True

    # --- quantization / entropy knobs (JAX package backends) ----------
    estimate_outlier_ratio: float = 1.0
    huffman_mono: bool = True
    huff_dict_size: int = 8192
    huff_block_size: int = 1024
    block_delta_block_size: int = 256
    block_delta_mode: block_delta_mode_type = block_delta_mode_type.Delta
    zstd_compress_level: int = 3

    # --- hierarchy / shape handling ------------------------------------
    normalize_coordinates: bool = True
    reorder: int = 0
    max_larget_level: int = _UNLIMITED  # (sic) reference spelling
    adjust_shape: bool = False

    # --- domain decomposition ------------------------------------------
    domain_decomposition: domain_decomposition_type = domain_decomposition_type.MaxDim
    domain_decomposition_dim: int = 0
    domain_decomposition_sizes: Sequence[int] = dataclasses.field(default_factory=list)
    max_memory_footprint: int = _UNLIMITED

    # --- pipelining ------------------------------------------------------
    # Overlap one subdomain's device phase with the previous one's host
    # serialization (the port runs subdomains in order for now).
    prefetch: bool = True

    # --- MDR ------------------------------------------------------------
    total_num_bitplanes: int = 32
    block_size: int = 256
    mdr_qoi_mode: bool = False
    mdr_qoi_num_variables: int = 3
    mdr_encoding: bitplane_encoding_type = bitplane_encoding_type.SignMagnitude
    mdr_orthogonal_basis: bool = False
    mdr_level_compressor: str = "zlib"
    mdr_interleaver: str = "direct"

    # --- hybrid refactoring ----------------------------------------------
    # 3 local levels = the full 8 -> 5 -> 3 -> 2 in-block chain (reference
    # Decompose8x8x8).
    num_local_refactoring_level: int = 3
    # Group hybrid symbols by minor-axis position class (z mod 8) before
    # the lossless stage; recorded in the header.
    hybrid_level_grouping: bool = True

    # --- misc -------------------------------------------------------------
    log_level: int = 0

    # --- additions of the JAX package --------------------------------------
    outlier_capacity_ratio: float = 1.0 / 64.0
    mesh_axis: str = "subdomain"
    # BFX superblock size in 32-symbol blocks (None = default).
    bfx_sb_blocks: Optional[int] = None
    # BFP base plane count (0 = chosen from the first stream's width
    # histogram, sticky per stream size) and residual plane capacity (0 =
    # default 8; explicit range 1..15 — residual lengths are 4-bit nibbles).
    bfp_base_planes: int = 0
    bfp_resid_planes: int = 0
    # The fused transform+pack front end (hybrid flag 2, kernels K10/K11):
    # streams of a shape whose BFP base-plane count is known (set above, or
    # primed by the shape's first flag-1 stream) are packed by one entry
    # point, chunks in tile-major order.
    hybrid_fused_pack: bool = False
    # BFP superblock size in 32-symbol blocks (None = default).
    bfp_sb_blocks: Optional[int] = None
    # BFP sort-chunk size in blocks (0 = default); recorded in each blob.
    bfp_chunk: int = 0
    # Consult a tuner table on compress(); a no-op in the port for now.
    autotune_lookup: bool = True

    def apply_autotune(self, shape, dtype):
        """No-op: the port has no tuner table yet (ROADMAP queue 1 item 13,
        which retargets utils/autotuner.py at the port's launch
        parameters). Returns self unchanged."""
        return self
