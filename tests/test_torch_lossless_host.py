"""PyTorch port, the host byte stages (``mgard_tpu_torch/lossless/lz4.py``
on the port's ``native/lz4.cpp``, ``lossless/host.py``) against the JAX
package's (``mgard_tpu/lossless/lz4.py``, ``mgard_tpu/lossless/host.py``).

LZ4 blocks are byte-equal both ways, and each package decodes the other's.
With ``zstandard`` hidden from the port (as on a host without it), a blob
that the zlib fallback wrote still decodes in both packages, while a real
zstd frame raises the port's typed error and ``decompress`` reports
BackendNotAvailableFailure."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu.lossless import host as JH, lz4 as JL
from mgard_tpu_torch import native
from mgard_tpu_torch.formats import ref_stream as TR
from mgard_tpu_torch.lossless import host as TH, lz4 as TL

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

GOLDEN = Path(__file__).resolve().parent / "golden"


def _payloads():
    rng = np.random.default_rng(0)
    yield b""
    yield b"a"
    yield bytes(range(13))
    yield rng.integers(0, 8, 100, dtype=np.uint8).tobytes()
    yield rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()  # random
    yield np.repeat(np.arange(300, dtype=np.int64), 50).tobytes()  # runs
    yield (np.arange(1 << 15, dtype="<i8") % 97).tobytes()  # a whole chunk


@pytest.mark.parametrize("k", range(7))
def test_lz4_blocks_equal_the_jax_codec_both_ways(k):
    data = list(_payloads())[k]
    tb, jb = TL.compress(data), JL.compress(data)
    assert tb == jb
    assert TL.decompress(jb, len(data)) == data
    assert JL.decompress(tb, len(data)) == data


def test_lz4_refuses_a_truncated_block():
    data = list(_payloads())[5]
    block = TL.compress(data)
    with pytest.raises(RuntimeError):
        TL.decompress(block[: len(block) // 2], len(data))


def test_x_lz4_container_equals_the_jax_writer():
    from mgard_tpu.formats import ref_stream as JR

    raw = (np.arange(100000, dtype="<i8") % 1013 - 500).tobytes()
    blob = TR._encode_x_lz4(raw)
    assert blob == JR._encode_x_lz4(raw)
    assert TR._decode_x_lz4(blob) == raw == JR._decode_x_lz4(blob)


def test_native_builds_beside_the_kernels():
    path = native.library_path("lz4")
    assert path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path.parent.parent == native._SRC_DIR.parent.parent / "build"
    native.load("lz4")
    native.load("huffdec")
    assert path.exists() and native.library_path("huffdec").exists()


def test_zstd_roundtrip_and_the_zlib_fallback_of_both_packages(monkeypatch):
    data = np.arange(5000, dtype="<i4").tobytes()
    if TH.have_zstd():
        frame = TH.zstd_compress(data)
        assert frame[:4] == TH.ZSTD_MAGIC and frame == JH.zstd_compress(data)
        assert TH.zstd_decompress(frame, len(data)) == data
        assert JH.zstd_decompress(frame, len(data)) == data
    # the fallback of a host without zstandard writes zlib, which both
    # packages read with or without zstandard
    monkeypatch.setattr(TH, "_zstd", None)
    fallback = TH.zstd_compress(data)
    assert fallback[:4] != TH.ZSTD_MAGIC
    assert zlib.decompress(fallback) == data
    assert TH.zstd_decompress(fallback, len(data)) == data
    assert JH.zstd_decompress(fallback, len(data)) == data
    monkeypatch.setattr(JH, "_HAVE_ZSTD", False)
    assert JH.zstd_decompress(fallback, len(data)) == data


def _hufzstd_section():
    """ref_blob_3d65_f32_hufzstd_s0's section: u64 raw size + a zstd frame
    (Lossless/Zstd.hpp)."""
    blob = (GOLDEN / "ref_blob_3d65_f32_hufzstd_s0.mgard").read_bytes()
    p = TR.parse_header(blob).header_bytes
    (size,) = struct.unpack_from("<Q", blob, p)
    section = blob[p + 8: p + 8 + size]
    assert section[8:12] == TH.ZSTD_MAGIC and not blob[p + 8 + size:]
    return section


def _zlib_twin():
    """ref_blob_3d65_f32_huf_abs (bare GPU-Huffman) rewritten as the
    Huffman+Zstd class whose frame is the zlib a host without zstandard
    writes: the header's compressor 3 -> 5 (re-CRC'd), the section u64 raw
    size + zlib of the Huffman container."""
    blob = (GOLDEN / "ref_blob_3d65_f32_huf_abs.mgard").read_bytes()
    h = TR.parse_header(blob)
    assert h.compressor == TR.ENC_X_HUFFMAN
    (hsize,) = struct.unpack_from("<Q", blob, 5)
    body = bytearray(blob[17: 17 + hsize])
    idx = bytes(body).find(bytes([11 << 3 | 2]))  # Encoding submessage
    sub = bytes(body[idx + 2: idx + 2 + body[idx + 1]])
    cidx = sub.find(bytes([2 << 3 | 0, TR.ENC_X_HUFFMAN]))
    assert idx >= 0 and cidx >= 0
    body[idx + 2 + cidx + 1] = TR.ENC_X_HUFFMAN_ZSTD
    header = (blob[:13] + struct.pack("<I", zlib.crc32(bytes(body)))
              + bytes(body))
    p = h.header_bytes
    (size,) = struct.unpack_from("<Q", blob, p)
    raw = blob[p + 8: p + 8 + size]
    section = struct.pack("<Q", len(raw)) + zlib.compress(raw, 6)
    return blob, header + struct.pack("<Q", len(section)) + section


def test_without_zstandard_a_zstd_frame_is_backend_not_available(
        monkeypatch):
    section = _hufzstd_section()
    (n,) = struct.unpack_from("<Q", section, 0)
    monkeypatch.setattr(TH, "_zstd", None)
    with pytest.raises(TH.ZstdNotAvailable):
        TH.zstd_decompress(section[8:], n)
    for name in ("ref_blob_3d65_f32_hufzstd_s0.mgard",
                 "cpu_stream_3d9917_f32_s0.mgard"):
        out, st = M.decompress((GOLDEN / name).read_bytes(), device="cpu")
        assert out is None
        assert st == M.compress_status_type.BackendNotAvailableFailure
    # the CPU generation's zlib class needs no zstd
    out, st = M.decompress(
        (GOLDEN / "cpu_stream_zlib_1d17_f32.mgard").read_bytes(),
        device="cpu")
    assert st == M.compress_status_type.Success


def test_without_zstandard_a_fallback_stream_decodes_in_both(monkeypatch):
    import mgard_tpu

    blob, twin = _zlib_twin()
    want, st = M.decompress(blob, device="cpu")
    assert st == M.compress_status_type.Success
    monkeypatch.setattr(TH, "_zstd", None)
    out, st = M.decompress(twin, device="cpu")
    assert st == M.compress_status_type.Success
    assert torch.equal(out, want)
    monkeypatch.setattr(JH, "_HAVE_ZSTD", False)
    jout, jst = mgard_tpu.decompress(twin)
    assert int(jst) == 0
    np.testing.assert_allclose(np.asarray(jout), want.numpy(), rtol=0,
                               atol=1e-6)
