"""MDR / MDR-X: progressive multi-precision refactoring and retrieval (port
of ``mgard_tpu.mdr``): decompose -> per-level interleave -> bitplane encode
with per-bitplane error tables (kernel K9 on the card) -> size-interpreted,
error-driven progressive retrieval -> incremental reconstruction, on the
CUDA card unless the caller asks for the CPU.
"""

from .api import (  # noqa: F401
    DecomposedMDR,
    MDReconstruct,
    MDReconstructDecomposed,
    MDRequest,
    MDRequestDecomposed,
    MDRefactor,
    MDRefactorDecomposed,
    ReconstructedData,
    RefactoredData,
    RefactoredMetadata,
    read_mdr_metadata,
    read_mdr_planes,
    retrieve_size,
    write_mdr,
)
