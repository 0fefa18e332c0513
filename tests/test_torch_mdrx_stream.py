"""PyTorch port, reference MDR-X refactored-data directories
(``mgard_tpu_torch/formats/mdrx_stream.py``): counterparts of
tests/test_mdrx_stream.py (its two command-line tests wait for the port's
MDR command line), with the JAX package's reader and writer
(``mgard_tpu/formats/mdrx_stream.py``) as the oracle of the integer
products: the plane requests, the decoded bitplane groups and levels, the
LevelLinearizer offsets, and the written archive's files (planes and error
tables). Goldens: tests/golden/mdrx* (written by the reference MDR-X build,
with its own reconstructions). The transform runs on the CPU here
(``device="cpu"``)."""

import importlib.util
import math
import os
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from mgard_tpu.formats import mdrx_stream as JX
from mgard_tpu_torch.formats.mdrx_stream import (
    MDRXArchive,
    _decode_group,
    read_metadata,
    request_planes,
    write_mdrx,
)
from mgard_tpu_torch.formats import mdrx_stream as TX
from mgard_tpu_torch.formats.metadata import FormatError

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

GOLD = Path(__file__).resolve().parent / "golden"
ARCHIVE = str(GOLD / "mdrx")
CPU = "cpu"


def reconstruct_mdrx(path, tol, **kw):
    return TX.reconstruct_mdrx(str(path), tol, device=CPU, **kw).numpy()


def _input():
    return np.fromfile(GOLD / "mdrx_input.bin",
                       np.float32).reshape(33, 33, 33)


def _make_field(shape):
    """gen_mdrx.cpp's make_field (f64 accumulate, f32 cast)."""
    n = int(np.prod(shape))
    idx = np.arange(n)
    acc = np.zeros(n)
    prod = np.ones(n)
    rem = idx.copy()
    for d in range(len(shape) - 1, -1, -1):
        x = (rem % shape[d]) / (shape[d] - 1 if shape[d] > 1 else 1)
        rem //= shape[d]
        acc += np.sin(2 * np.pi * (d + 1) * x)
        prod *= np.cos(np.pi * x + 0.3 * (d + 1))
    return (acc + 0.5 * prod).astype(np.float32).reshape(shape)


def test_mdrx_metadata_parses():
    md = read_metadata(ARCHIVE)[0]
    jd = JX.read_metadata(ARCHIVE)[0]
    assert int(md.num_levels) == 6 and int(md.num_bitplanes) == 32
    assert int(md.level_num_elems[-1]) == 31024
    assert int(md.level_num_elems.sum()) == 33 ** 3
    for name in ("level_error_bounds", "level_squared_errors",
                 "level_sizes", "level_num_elems"):
        np.testing.assert_array_equal(getattr(md, name), getattr(jd, name))


@pytest.mark.parametrize(
    "tol,ref_name,ref_planes",
    [
        (1e-1, "mdrx_rec_1e-01.bin", [12, 12, 12, 12, 4, 4]),
        (1e-3, "mdrx_rec_1e-03.bin", [20, 20, 20, 20, 12, 12]),
    ],
)
def test_mdrx_reconstruction_matches_reference(tol, ref_name, ref_planes):
    md = read_metadata(ARCHIVE)[0]
    assert request_planes(md, tol) == ref_planes
    out = reconstruct_mdrx(ARCHIVE, tol)
    ref = np.fromfile(GOLD / ref_name, np.float32).reshape(33, 33, 33)
    np.testing.assert_allclose(out.astype(np.float64), ref, rtol=0,
                               atol=1e-6)
    assert float(np.max(np.abs(out.astype(np.float64) - _input()))) <= tol


def test_mdrx_progressive_improves_with_planes():
    v = _input()
    errs = []
    for planes in ([4] * 6, [8] * 6, [16] * 6):
        out = reconstruct_mdrx(ARCHIVE, 1.0, planes=planes)
        errs.append(float(np.max(np.abs(out.astype(np.float64) - v))))
    assert errs[0] > errs[1] > errs[2]


def test_mdrx_field_replication_matches():
    ref = np.fromfile(GOLD / "mdrx_input.bin",
                      np.float32).reshape(33, 33, 33)
    np.testing.assert_allclose(_make_field((33, 33, 33)).astype(np.float64),
                               ref.astype(np.float64), rtol=0, atol=1e-6)


def test_mdrx_at_scale_161():
    archive = GOLD / "mdrx2"
    md = read_metadata(str(archive))[0]
    assert int(md.num_levels) == 9
    assert request_planes(md, 2e-1) == [8, 12, 8, 8, 8, 4, 4, 4, 4]
    out = reconstruct_mdrx(archive, 2e-1)
    v = _make_field((161, 161, 161))
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= 2e-1
    ref_prefix = np.frombuffer(zlib.decompress(
        (GOLD / "mdrx2_rec_2e-01.bin.zz").read_bytes()), np.float32)
    np.testing.assert_allclose(
        out.ravel()[: ref_prefix.size].astype(np.float64),
        ref_prefix.astype(np.float64), rtol=0, atol=1e-6)


def test_mdrx3_compressed_groups():
    """Both compressed group forms of the reference (MGXRLEC, MGXHUFF),
    decoded to the JAX package's bytes."""
    archive = GOLD / "mdrx3"
    with open(archive / "component_0_7_0", "rb") as f:
        assert f.read(7) == b"MGXRLEC"
    with open(archive / "component_0_7_4", "rb") as f:
        assert f.read(7) == b"MGXHUFF"
    a = MDRXArchive(str(archive), CPU)
    assert a.request(2e-2) == [8, 8, 16, 4, 4, 4, 4, 8]
    out = a.reconstruct(2e-2).numpy()

    spec = importlib.util.spec_from_file_location(
        "gen_mdrx3_field", GOLD / "gen_mdrx3_field.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    v = gen.make_field3()
    assert float(np.max(np.abs(out.astype(np.float64)
                               - v.astype(np.float64)))) <= 2e-2
    ref_prefix = np.frombuffer(zlib.decompress(
        (GOLD / "mdrx3_rec_2e-02.bin.zz").read_bytes()), np.float32)
    np.testing.assert_allclose(
        out.ravel()[: ref_prefix.size].astype(np.float64),
        ref_prefix.astype(np.float64), rtol=0, atol=1e-6)
    # decoded-group caching: a second tolerance agrees with a fresh read
    out2 = a.reconstruct(2e-1).numpy()
    np.testing.assert_array_equal(out2, reconstruct_mdrx(archive, 2e-1))
    # the groups (raw, RLE, Huffman) equal the JAX decoder's, bit for bit
    for level, bp in ((7, 0), (7, 4), (6, 0)):
        row_len = 2 * ((int(a.md.level_num_elems[level]) + 31) // 32)
        blob = (archive / f"component_0_{level}_{bp}").read_bytes()
        want = row_len * 4 * 4
        assert _decode_group(blob, want) == JX._decode_group(blob, want)


def test_mdrx_singledim_rejected():
    with pytest.raises(FormatError, match="singledim"):
        reconstruct_mdrx(GOLD / "mdrx_sd", 1e-2)


def test_mdrx_domain_decomposed_rejected():
    archive = str(GOLD / "mdrx_dd")
    mds = read_metadata(archive)
    assert len(mds) == 4
    assert float(mds[0].level_error_bounds[1]) > 1e15
    with pytest.raises(FormatError, match="one.*subdomain|subdomain"):
        reconstruct_mdrx(archive, 1e-1)


def test_mdrx_truncated_metadata_fails_cleanly(tmp_path):
    bad = tmp_path / "mdrx"
    shutil.copytree(ARCHIVE, bad)
    meta = bad / "metadata"
    meta.write_bytes(meta.read_bytes()[:40])
    with pytest.raises(FormatError):
        reconstruct_mdrx(bad, 1e-3)


def test_mdrx_write_reference_reads(tmp_path):
    """write_mdrx reproduces the committed mdrxw/ archive (written by the
    JAX package and reconstructed by the reference build, mdrxw_rec_*)
    byte for byte, planes and error tables included; the port's reader
    agrees with the reference's reconstruction."""
    committed = GOLD / "mdrxw"
    v = _input()
    out_dir = tmp_path / "mdrxw"
    write_mdrx(str(out_dir), v, device=CPU)
    names = sorted(os.listdir(committed))
    assert sorted(os.listdir(out_dir)) == names
    for name in names:
        assert (out_dir / name).read_bytes() == \
            (committed / name).read_bytes(), name
    a = MDRXArchive(str(committed), CPU)
    for tol, name in ((1e-1, "mdrxw_rec_1e-01.bin.zz"),
                      (1e-3, "mdrxw_rec_1e-03.bin.zz")):
        out = a.reconstruct(tol).numpy()
        assert float(np.max(np.abs(out.astype(np.float64) - v))) <= tol
        ref = np.frombuffer(zlib.decompress((GOLD / name).read_bytes()),
                            np.float32)
        np.testing.assert_allclose(out.ravel().astype(np.float64),
                                   ref.astype(np.float64), rtol=0, atol=1e-6)


def test_mdrx_finite_s_requests():
    a = MDRXArchive(str(GOLD / "mdrxw"), CPU)
    assert a.request(1e-1, s=0.0) == [12, 16, 16, 16, 12, 12]
    assert a.request(1e-3, s=0.0) == [20, 32, 32, 32, 32, 32]
    out = a.reconstruct(1e-1, s=0.0).numpy()
    l2 = float(np.sqrt(np.mean((out.astype(np.float64) - _input()) ** 2)))
    assert l2 <= 1e-1
    with pytest.raises(FormatError, match="squared-error tables"):
        reconstruct_mdrx(ARCHIVE, 1e-1, s=0.0)


def test_mdrx_write_tiny_magnitudes(tmp_path):
    v = (_make_field((17, 17, 17)) * np.float32(1e-30)).astype(np.float32)
    d = tmp_path / "tiny"
    write_mdrx(str(d), v, device=CPU)
    out = MDRXArchive(str(d), CPU).reconstruct(1e-33).numpy()
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= 1e-33


def test_mdrx_group_payload_rle_roundtrip():
    runs = [(5, 0), (3, 7), (8, 0), (4, 255), (12, 1)]
    expected = b"".join(bytes([s]) * c for c, s in runs)
    blob = (b"MGXRLEC\x00"
            + struct.pack("<QQ", len(runs), len(expected))
            + b"".join(struct.pack("<I", c) for c, _ in runs)
            + bytes(s for _, s in runs))
    assert _decode_group(blob, len(expected)) == expected


def test_mdrx_corrupt_fails_cleanly(tmp_path):
    bad = tmp_path / "mdrx"
    shutil.copytree(ARCHIVE, bad)
    comp = bad / "component_0_5_0"
    comp.write_bytes(comp.read_bytes()[:100])
    with pytest.raises(FormatError):
        reconstruct_mdrx(bad, 1e-3)


# ----------------------------------------------------------------------
# integer products and written bytes against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("archive,tols", [
    ("mdrx", (1e-1, 1e-2, 1e-3, 1e-5)), ("mdrx2", (2e-1, 1e-2)),
    ("mdrx3", (2e-2, 1e-3)), ("mdrxw", (1e-1, 1e-4)),
])
def test_requests_offsets_and_levels_equal_the_jax_readers(archive, tols):
    path = str(GOLD / archive)
    md, jd = read_metadata(path)[0], JX.read_metadata(path)[0]
    for tol in tols:
        assert request_planes(md, tol) == JX.request_planes(jd, tol)
    a = MDRXArchive(path, CPU)
    offs = TX.level_offsets(a.hier)
    shape = a.hier.shape
    from mgard_tpu.config import Config as JConfig
    from mgard_tpu.hierarchy import get_hierarchy as j_hier

    jc = JConfig()
    jc.normalize_coordinates = False
    joffs = JX.level_offsets(j_hier(shape, a.header.dtype, None, jc))
    for t, j in zip(offs, joffs):
        np.testing.assert_array_equal(t, j)
    # the first level's rows decoded by both packages, bit for bit
    n = int(md.level_num_elems[-1])
    row_len = 2 * ((n + 31) // 32)
    rows = a._group_rows(len(offs) - 1, 0, row_len)
    for k in (1, 4):
        np.testing.assert_array_equal(
            TX.decode_level(rows, k, float(md.level_error_bounds[-1]), n),
            JX.decode_level(rows, k, float(jd.level_error_bounds[-1]), n))


@pytest.mark.parametrize("shape,scale", [((17, 17, 17), 1.0),
                                         ((9, 33, 17), 1e-3)])
def test_writer_equals_the_jax_writer_and_both_read_both(tmp_path, shape,
                                                         scale):
    """write_mdrx of both packages on the same field: the same files (the
    header, the metadata with its bounds and squared-error tables, every
    plane group); each package's reader reconstructs either archive to
    the same field within the bound."""
    v = (_make_field(shape) * np.float32(scale)).astype(np.float32)
    td, jd = tmp_path / "port", tmp_path / "jax"
    write_mdrx(str(td), v, device=CPU)
    JX.write_mdrx(str(jd), v)
    names = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == names
    for name in names:
        assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    tol = 1e-3 * scale
    out_t = MDRXArchive(str(jd), CPU).reconstruct(tol).numpy()
    out_j = np.asarray(JX.MDRXArchive(str(td)).reconstruct(tol))
    for out in (out_t, out_j):
        assert float(np.abs(out.astype(np.float64) - v).max()) <= tol
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-6 * scale)
    assert math.isfinite(float(out_t.sum()))
