"""mgard_tpu_torch: the PyTorch/CUDA port of mgard-tpu (error-bounded lossy
compression of scientific grids), written for one NVIDIA H100.

It sits beside the JAX package ``mgard_tpu``, which stays the reference, and
writes and reads the same streams. It imports neither JAX nor ``mgard_tpu``.
It covers ``compress``/``decompress``/``compress_roi`` of 1D-5D float32 and
float64 fields (s = inf and finite s, ABS and REL bounds, the Hybrid,
MultiDim and SingleDim decompositions, non-uniform grids) with the BFP or
BFX lossless stage, ``norm`` (the s-norms the bounds are stated in), and
the MDR progressive refactor/retrieval API (``mgard_tpu_torch.mdr``).
``decompress`` also reads the streams the reference MGARD libraries write;
``formats/`` holds their readers and writers (MGARD-X, the CPU generation,
MDR-X archives), with host byte codecs in ``native/``. The hand-written
CUDA kernels live in ``csrc/`` and are built at first use
(``kernels.py``). Entry points run on the CUDA card unless the
caller asks for the CPU (``device="cpu"``).
"""

import torch as _torch

# Float32 matmuls at full precision (the remainder transform is a chain of
# float32 tensordots): TF32 keeps ~3 decimal digits, which would cost a
# large share of a 1e-3 error budget. Set here, for the whole process.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import Config  # noqa: E402
from .dtypes import (  # noqa: E402
    compress_status_type,
    data_type,
    decomposition_type,
    domain_decomposition_type,
    error_bound_type,
    lossless_type,
)
from .hierarchy import Hierarchy, get_hierarchy  # noqa: E402
from .highlevel import (  # noqa: E402
    adjust_shape,
    calculate_norm,
    compress,
    compress_roi,
    decompress,
)
from .ops.norms import norm  # noqa: E402

__version__ = "0.1.0"
__all__ = [
    "Config",
    "Hierarchy",
    "get_hierarchy",
    "adjust_shape",
    "calculate_norm",
    "compress",
    "compress_roi",
    "decompress",
    "norm",
    "compress_status_type",
    "data_type",
    "decomposition_type",
    "domain_decomposition_type",
    "error_bound_type",
    "lossless_type",
]
