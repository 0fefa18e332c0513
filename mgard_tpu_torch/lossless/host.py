"""Host-side byte codecs: Zstd and zlib (port of
``mgard_tpu/lossless/host.py``).

The reference's host stages: CPU_Lossless (reference:
include/mgard-x/Lossless/CPU.hpp:92-168, host zstd of the quantized
stream) and the Zstd second stage (reference:
include/mgard-x/Lossless/Zstd.hpp:30-120). Zstd comes from the optional
``zstandard`` package. Without it, a writer stores zlib in its place, as
the JAX package does, and both packages read such a blob back; a real zstd
frame (magic ``28 b5 2f fd``) then cannot be read and raises
``ZstdNotAvailable``, which ``decompress`` reports as
``compress_status_type.BackendNotAvailableFailure``.
"""

from __future__ import annotations

import zlib

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - depends on the host
    _zstd = None

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class ZstdNotAvailable(RuntimeError):
    """A zstd frame met on a host without the ``zstandard`` package."""


def have_zstd() -> bool:
    return _zstd is not None


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    """One single-threaded zstd frame (the same bytes as the JAX package's
    default), or zlib without the zstandard package."""
    if _zstd is not None:
        return _zstd.ZstdCompressor(level=level).compress(data)
    return zlib.compress(data, min(level + 3, 9))


def zstd_decompress(blob: bytes, expected_size: int | None = None) -> bytes:
    is_zstd = bytes(blob[:4]) == ZSTD_MAGIC
    if _zstd is not None:
        try:
            return _zstd.ZstdDecompressor().decompress(
                blob, max_output_size=expected_size or 0)
        except _zstd.ZstdError:
            if is_zstd:
                raise
            # written by the zlib fallback of another host
            return zlib.decompress(blob)
    if is_zstd:
        raise ZstdNotAvailable(
            "a zstd frame needs the zstandard package, which this host "
            "does not have")
    return zlib.decompress(blob)
