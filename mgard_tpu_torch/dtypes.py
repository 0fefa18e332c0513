"""Core enums and scalar types of the PyTorch port.

A copy of ``mgard_tpu.dtypes``: every enum value is a wire id written into
stream headers and sections, so the two packages must agree on all of them
(tests/test_torch_host.py checks that they do).
"""

from __future__ import annotations

import enum

import numpy as np


class decomposition_type(enum.IntEnum):
    MultiDim = 0
    SingleDim = 1
    Hybrid = 2


class decomposition_basis_type(enum.IntEnum):
    Orthoganal = 0  # (sic) -- reference spelling kept for parity
    Hierarchical = 1


class processor_type(enum.IntEnum):
    CPU = 0
    GPU_CUDA = 1
    X_SERIAL = 2
    X_OPENMP = 3
    X_CUDA = 4
    X_HIP = 5
    X_SYCL = 6
    X_TPU = 7  # new backend identifier for this framework


class error_bound_type(enum.IntEnum):
    REL = 0
    ABS = 1


class norm_type(enum.IntEnum):
    L_Inf = 0
    L_2 = 1


class lossless_type(enum.IntEnum):
    Huffman = 0
    Huffman_LZ4 = 1
    Huffman_Zstd = 2
    CPU_Lossless = 3
    BlockDelta = 4
    LZ4 = 5
    ZeroRLE_Rans = 6
    SymbolRans = 7
    # block fixed-width bitplane codec (lossless/bfx.py)
    BFX = 8
    BFX_Zstd = 9
    # width-sorted prefix bitplane codec (lossless/bfp.py)
    BFP = 10
    BFP_Zstd = 11


class bitplane_encoding_type(enum.IntEnum):
    """MDR bitplane encodings (reference: MDR-X BPEncoderRegisterBlock
    EncodeBinary/EncodeNegaBinary, BPEncoderRegisterBlock.hpp:111,183)."""

    SignMagnitude = 0
    NegaBinary = 1


class block_delta_mode_type(enum.IntEnum):
    Fixed = 0
    Delta = 1
    Outlier = 2


class data_type(enum.IntEnum):
    Float = 0
    Double = 1


class data_structure_type(enum.IntEnum):
    Cartesian_Grid_Uniform = 0
    Cartesian_Grid_Non_Uniform = 1


class endiness_type(enum.IntEnum):
    Little_Endian = 0
    Big_Endian = 1


class domain_decomposition_type(enum.IntEnum):
    MaxDim = 0
    Block = 1
    Variable = 2


class operation_type(enum.IntEnum):
    Compression = 0
    MDR = 1


class compress_status_type(enum.IntEnum):
    Success = 0
    Failure = 1
    OutputTooLargeFailure = 2
    NotSupportHigherNumberOfDimensionsFailure = 3
    NotSupportDataTypeFailure = 4
    BackendNotAvailableFailure = 5


class compressor_type(enum.IntEnum):
    MGARD = 0
    ZFP = 1


class cpu_parallelization_mode(enum.IntEnum):
    INTRA_BLOCK = 0
    INTER_BLOCK = 1


def np_dtype(dt: data_type) -> np.dtype:
    return np.dtype(np.float32) if dt == data_type.Float else np.dtype(np.float64)


def dtype_enum(dtype) -> data_type:
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        return data_type.Float
    if dtype == np.float64:
        return data_type.Double
    raise TypeError(f"unsupported dtype {dtype}; mgard-tpu supports float32/float64")


# Maximum number of dimensions the dynamic API dispatches over
# (reference: compress_x.hpp D=1..5).
MAX_DIM = 5

# Quantized symbol stream dtype on device.
QUANTIZED_DTYPE = np.int32
# Outlier value dtype (parity with reference QUANTIZED_INT = std::int64_t,
# RuntimeX/DataTypes.h:13-135).
OUTLIER_DTYPE = np.int64
