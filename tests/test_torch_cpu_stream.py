"""PyTorch port, streams of the reference MGARD **CPU generation**
(``mgard_tpu_torch/formats/cpu_stream.py``): counterparts of
tests/test_cpu_stream.py, and the JAX package's reader and writer
(``mgard_tpu/formats/cpu_stream.py``) as the oracle of the integer
products.

The goldens tests/golden/cpu_* were written by the reference CPU library
(generate_cpu_stream.sh) with its own decompressed output: both payload
classes (CPU_HUFFMAN_ZSTD, CPU_HUFFMAN_ZLIB), float32/float64, 1D-3D,
dyadic and non-dyadic shapes, a flat axis, s = inf / 0 / 0.5 / -0.5 and
non-uniform coordinates. The CPU-Huffman symbols equal the JAX decoder's
bit for bit; the writer's bytes equal the committed streams (which the
reference read back) and the JAX writer's; decoded fields agree with the
reference decoder's output to the rounding of the stream's type."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mgard_tpu_torch as M
from mgard_tpu.formats import cpu_stream as JC, ref_stream as JR
from mgard_tpu_torch.formats import cpu_stream as TC, ref_stream as TR
from mgard_tpu_torch.formats.cpu_stream import (
    CpuHierarchy,
    compress_cpu,
    decompose_cpu,
    recompose_cpu,
)

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

GOLDEN = Path(__file__).resolve().parent / "golden"
_DT = {"f32": np.float32, "f64": np.float64}


def _manifest():
    out = []
    for variant in ("zstd", "zlib"):
        with open(GOLDEN / f"cpu_manifest_{variant}.json") as f:
            out.extend(dict(e, variant=variant) for e in json.load(f) if e)
    return out


def _decode(blob):
    out, st = M.decompress(blob, device="cpu")
    assert int(st) == 0 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("entry", _manifest(), ids=lambda e: e["tag"])
def test_cpu_stream_matches_reference_decompressor(entry):
    tag = entry["tag"]
    shape = tuple(entry["shape"])
    dt = _DT[entry["dtype"]]
    blob = (GOLDEN / f"cpu_stream_{tag}.mgard").read_bytes()
    ref_own = np.fromfile(GOLDEN / f"cpu_output_{tag}.bin",
                          dt).reshape(shape)
    out = _decode(blob)
    assert out.dtype == dt and out.shape == shape
    atol = 2e-6 if dt == np.float32 else 1e-12
    np.testing.assert_allclose(out.astype(np.float64), ref_own, rtol=0,
                               atol=atol)
    if entry["s"] == "inf":
        v = np.fromfile(GOLDEN / f"cpu_input_{tag}.bin", dt).reshape(shape)
        assert float(np.max(np.abs(out.astype(np.float64) - v))) \
            <= entry["tol"]
    # the symbols of the payload equal the JAX decoder's, bit for bit
    th, jh = TR.parse_header(blob), JR.parse_header(blob)
    payload = blob[th.header_bytes:]
    n = int(np.prod(shape))
    if entry["variant"] == "zstd":
        ts = TC.decode_huffman_cpu(payload, n, zstd=True)
        js = JC.decode_huffman_cpu(payload, n, zstd=True)
        assert ts.dtype == js.dtype == np.int64
        np.testing.assert_array_equal(ts, js)
    q_t = TC._quantum_grid(CpuHierarchy(shape, th.coords), th.s, th.tol)
    q_j = JC._quantum_grid(JC.CpuHierarchy(shape, jh.coords), jh.s, jh.tol)
    np.testing.assert_array_equal(q_t, q_j)


@pytest.mark.parametrize(
    "tag,shape,dt",
    [
        ("1d17_f32", (17,), np.float32),
        ("1d17_f64", (17,), np.float64),
        ("2d9x17_f64", (9, 17), np.float64),
        ("3d9x9x17_f64", (9, 9, 17), np.float64),
        ("3d15x16x17_f64", (15, 16, 17), np.float64),
    ],
)
def test_cpu_recompose_inverts_reference_decompose(tag, shape, dt):
    dec = np.fromfile(GOLDEN / f"decomposed_{tag}.bin", dt).reshape(shape)
    inp = np.fromfile(GOLDEN / f"input_{tag}.bin", dt).reshape(shape)
    hier = CpuHierarchy(shape)
    rec = recompose_cpu(dec.astype(np.float64), hier)
    atol = 5e-7 if dt == np.float32 else 1e-13
    np.testing.assert_allclose(rec, inp.astype(np.float64), rtol=0, atol=atol)
    np.testing.assert_array_equal(hier.shuffle_perm,
                                  JC.CpuHierarchy(shape).shuffle_perm)


def test_cpu_decompose_roundtrip_nondyadic():
    rng = np.random.RandomState(7)
    v = rng.rand(11, 1, 14)
    hier = CpuHierarchy(v.shape)
    w = decompose_cpu(v, hier)
    np.testing.assert_allclose(recompose_cpu(w, hier), v, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(w, JC.decompose_cpu(v, JC.CpuHierarchy(
        v.shape)))


_WRITE_CASES = [
    ("3d151617_f64_sinf", "input_3d15x16x17_f64.bin", np.float64,
     (15, 16, 17), np.inf, 1e-3, None),
    ("3d151617_f64_s0", "input_3d15x16x17_f64.bin", np.float64,
     (15, 16, 17), 0.0, 1e-3, None),
    ("3d9917_f32_sinf", "input_3d9x9x17_f32.bin", np.float32,
     (9, 9, 17), np.inf, 1e-3, None),
    ("2d179_f64_nonuni", "cpu_input_2d179_f64_nonuni.bin", np.float64,
     (17, 9), np.inf, 1e-3,
     ("cpu_coords_2d179_f64_nonuni_d0.bin",
      "cpu_coords_2d179_f64_nonuni_d1.bin")),
]


@pytest.mark.parametrize("case", _WRITE_CASES, ids=lambda c: c[0])
def test_cpu_write_accepted_by_reference(case):
    """cpuwrite_*.mgard were written by the JAX package's compress_cpu and
    read back by the reference CPU library (cpuwrite_dec_*.bin): the
    port's writer gives the same bytes, both packages decode the stream,
    and the port's decode agrees with the reference's reconstruction."""
    tag, inp, dt, shape, s, tol, coord_files = case
    v = np.fromfile(GOLDEN / inp, dt).reshape(shape)
    coords = None
    if coord_files:
        coords = [np.fromfile(GOLDEN / c, np.float64) for c in coord_files]
    blob = compress_cpu(v, tol, s, coords=coords)
    assert blob == (GOLDEN / f"cpuwrite_{tag}.mgard").read_bytes()
    assert blob == JC.compress_cpu(v, tol, s, coords=coords)
    ref_dec = np.fromfile(GOLDEN / f"cpuwrite_dec_{tag}.bin",
                          dt).reshape(shape)
    if np.isinf(s):
        assert float(np.max(np.abs(ref_dec.astype(np.float64) - v))) <= tol
    out = _decode(blob)
    atol = 2e-6 if dt == np.float32 else 1e-12
    np.testing.assert_allclose(out.astype(np.float64), ref_dec, rtol=0,
                               atol=atol)
    # cross-decode: the JAX reader on the port's bytes, the same field
    np.testing.assert_array_equal(
        JC.decompress_cpu(blob, JR.parse_header(blob)), out)


def test_cpu_stream_truncation_fails_cleanly():
    blob = (GOLDEN / "cpu_stream_3d9917_f32_s0.mgard").read_bytes()
    for cut in (10, 80, len(blob) // 2, len(blob) - 3):
        out, st = M.decompress(blob[:cut], device="cpu")
        assert out is None and int(st) != 0, f"cut={cut}"
