"""LZ4 block-format codec on the host (port of
``mgard_tpu/lossless/lz4.py``, bound to the port's ``native/lz4.cpp``).

The reference's device LZ4 (reference: include/mgard-x/Lossless/LZ4/
LZ4Kernels.hpp) chases bytes with data-dependent trip counts; here, as in
the JAX package, the public LZ4 block format runs in native host code. It
serves the reference's X_LZ4 container (``formats/ref_stream.py``).
"""

from __future__ import annotations

import ctypes

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..native import load

        lib = load("lz4")
        lib.mgard_lz4_bound.restype = ctypes.c_int64
        lib.mgard_lz4_bound.argtypes = [ctypes.c_int64]
        for fn in (lib.mgard_lz4_compress, lib.mgard_lz4_decompress):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int64]
        _LIB = lib
    return _LIB


def compress(data: bytes) -> bytes:
    lib = _lib()
    data = bytes(data)
    n = len(data)
    cap = lib.mgard_lz4_bound(n)
    out = ctypes.create_string_buffer(cap)
    written = lib.mgard_lz4_compress(data, n, out, cap)
    if written < 0:
        raise RuntimeError("lz4 compress failed")
    return out.raw[:written]


def decompress(data: bytes, out_size: int) -> bytes:
    lib = _lib()
    data = bytes(data)
    out = ctypes.create_string_buffer(out_size)
    written = lib.mgard_lz4_decompress(data, len(data), out, out_size)
    if written != out_size:
        raise RuntimeError(
            f"lz4 decompress produced {written} bytes, expected {out_size}")
    return out.raw
