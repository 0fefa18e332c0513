"""Native (C++) host stages of the port, built at first use with the
system's C++ compiler and loaded through ctypes.

Two byte-serial codecs live here, copies of the JAX package's
``mgard_tpu/native`` sources so that both packages write and read the same
bytes: ``lz4.cpp`` (the public LZ4 block format, for the reference's X_LZ4
container) and ``huffdec.cpp`` (the tree walk of the reference CPU
library's Huffman streams). Both are chains of data-dependent steps over a
byte stream, host work in the reference too (its Zstd stage,
include/mgard-x/Lossless/Zstd.hpp:30-120).

A library goes to ``build/native/`` at the root of the checkout, beside
the CUDA kernels' ``build/kernels/``, named by a hash of its source and
flags, so a changed source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parent.parent / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LOADED: dict = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *FLAGS,
           str(_SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeBuildError(
            f"building {name}.cpp failed: "
            f"{detail.decode(errors='replace') or e}") from e
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the named native module."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(_build(name)))
        return _LOADED[name]
