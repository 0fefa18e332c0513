"""PyTorch port, streams written by the reference MGARD-X library: not
decoded yet (ROADMAP queue 1 item 12), and refused loudly. ``decompress``
raises NotImplementedError naming the item for a reference-written golden,
while this package's own streams never match the reference signature and
decode as before. No JAX: the goldens are files."""

from pathlib import Path

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu_torch.formats import ref_stream
from mgard_tpu_torch.formats.metadata import MAGIC

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

GOLDEN = Path(__file__).resolve().parent / "golden"
# reference-format streams of each kind: written by the X library (LZ4,
# hybrid, Huffman, a domain-decomposed s=0 stream), by the reference CPU
# library, and in both formats by the JAX package's reference writers
# (which the reference library reads back)
REFERENCE_BLOBS = ("ref_blob_3d65_f32_lz4_abs.mgard",
                   "ref_blob_3d65_f32_hyb.mgard",
                   "ref_blob_3d65_f32_huf_abs.mgard",
                   "ref_blob_3d643333_f32_lz4_s0_dd.mgard",
                   "cpu_stream_1d17_f32_sinf.mgard",
                   "cpuwrite_2d179_f64_nonuni.mgard",
                   "xwrite_3d65_f32_abs.mgard")


@pytest.mark.parametrize("name", REFERENCE_BLOBS)
def test_reference_stream_raises_not_implemented(name):
    blob = (GOLDEN / name).read_bytes()
    assert ref_stream.sniff(blob[:8])
    with pytest.raises(NotImplementedError, match="item 12"):
        M.decompress(blob, device="cpu")


@pytest.mark.parametrize("shape,s", [((17, 17, 17), np.inf),
                                     ((33, 40), 0.0), ((1000,), np.inf)])
def test_port_stream_is_not_sniffed_and_decodes(shape, s):
    rng = np.random.default_rng(11)
    v = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    blob, st = M.compress(v, 1e-2, s=s, device="cpu")
    assert st == M.compress_status_type.Success
    assert blob[:len(MAGIC)] == MAGIC and not ref_stream.sniff(blob[:8])
    out, st2 = M.decompress(blob, device="cpu")
    assert st2 == M.compress_status_type.Success
    assert out.shape == shape
    if np.isinf(s):
        assert float(np.abs(out.numpy() - v).max()) <= 1e-2


def test_signature_check_edges():
    assert not ref_stream.sniff(MAGIC)
    assert not ref_stream.sniff(b"")
    assert not ref_stream.sniff(b"MGAR")
    assert ref_stream.sniff(b"MGARD\x00\x00\x00")
    # a truncated stream of this package stays a Failure, not a refusal
    blob, _ = M.compress(np.linspace(0, 1, 500, dtype=np.float32), 1e-3,
                         device="cpu")
    out, st = M.decompress(blob[:12], device="cpu")
    assert out is None and st == M.compress_status_type.Failure
