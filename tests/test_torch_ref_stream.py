"""PyTorch port, streams of the reference MGARD-X library
(``mgard_tpu_torch/formats/ref_stream.py``) against the JAX package's
reader and writer (``mgard_tpu/formats/ref_stream.py``) and against the
reference's own files in tests/golden.

Integer products are held bit for bit: the parsed headers and the symbols
every section decoder gives, on every ``ref_blob_*`` and ``xwrite_*``
golden. Decoded fields are held, as in tests/test_ref_stream.py, within the
certified bound and against the reference decoder's own output. The
writer's bytes equal the JAX writer's, or meet the symbol contract of
tests/test_torch_generic.py, and each package decodes the other's stream.
The port decodes on the CPU here (``device="cpu"``)."""

import dataclasses
import math
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import mgard_tpu as J
import mgard_tpu_torch as M
from mgard_tpu.formats import ref_stream as JR
from mgard_tpu_torch.formats import ref_stream
from mgard_tpu_torch.formats.metadata import MAGIC, FormatError

torch.set_num_threads(1)  # pytest-xdist workers share the machine's cores

GOLDEN = Path(__file__).resolve().parent / "golden"
CPU = "cpu"
OK = M.compress_status_type.Success
REF_BLOBS = sorted(p.name for p in GOLDEN.glob("ref_blob_*.mgard"))
X_BLOBS = sorted(p.name for p in GOLDEN.glob("xwrite_*.mgard"))

CASES = [
    ("3d65_f32_lz4_abs", (65, 65, 65), np.float32, 1e-3, "abs"),
    ("3d606570_f64_lz4_abs", (60, 65, 70), np.float64, 1e-4, "abs"),
    ("3d65_f32_lz4_rel", (65, 65, 65), np.float32, 1e-3, "rel"),
]


def _load(tag, shape, dt):
    blob = (GOLDEN / f"ref_blob_{tag}.mgard").read_bytes()
    v = np.fromfile(GOLDEN / f"ref_input_{tag}.bin", dt).reshape(shape)
    return blob, v


def _input65():
    return np.fromfile(GOLDEN / "ref_input_3d65_f32_lz4_abs.bin",
                       np.float32).reshape(65, 65, 65)


def _decode(blob):
    out, st = M.decompress(blob, device=CPU)
    assert st == OK
    assert out.device.type == "cpu"
    return out.numpy()


# reference-format streams of each kind: written by the X library (LZ4,
# hybrid, Huffman, a domain-decomposed s=0 stream), by the reference CPU
# library, and in both formats by the JAX package's reference writers
# (which the reference library reads back), each with the reference
# decoder's own output or the input and bound the JAX tests hold it to
REFERENCE_BLOBS = {
    "ref_blob_3d65_f32_lz4_abs.mgard": (
        "ref_input_3d65_f32_lz4_abs.bin", np.float32, (65, 65, 65), 1e-3),
    "ref_blob_3d65_f32_hyb.mgard": None,  # refused, as in the JAX package
    "ref_blob_3d65_f32_huf_abs.mgard": (
        "ref_input_3d65_f32_huf_abs.bin", np.float32, (65, 65, 65), 1e-3),
    "ref_blob_3d643333_f32_lz4_s0_dd.mgard": (
        "ref_dec_3d643333_f32_lz4_s0_dd.bin", np.float32, (64, 33, 33),
        1e-5),
    "cpu_stream_1d17_f32_sinf.mgard": (
        "cpu_output_1d17_f32_sinf.bin", np.float32, (17,), 2e-6),
    "cpuwrite_2d179_f64_nonuni.mgard": (
        "cpuwrite_dec_2d179_f64_nonuni.bin", np.float64, (17, 9), 1e-12),
    "xwrite_3d65_f32_abs.mgard": (
        "xwrite_dec_3d65_f32_abs.bin", np.float32, (65, 65, 65), 1e-5),
}


@pytest.mark.parametrize("name", list(REFERENCE_BLOBS))
def test_reference_stream_decodes(name):
    """decompress reads a stream of each reference kind, as the JAX
    package does: within the bound of its input, or next to the reference
    decoder's own output; the Hybrid layout is refused with Failure."""
    blob = (GOLDEN / name).read_bytes()
    assert ref_stream.sniff(blob[:8])
    out, st = M.decompress(blob, device=CPU)
    check = REFERENCE_BLOBS[name]
    if check is None:
        assert out is None and st == M.compress_status_type.Failure
        return
    ref_name, dt, shape, lim = check
    assert st == OK and out.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
    assert tuple(out.shape) == shape
    ref = np.fromfile(GOLDEN / ref_name, dt).reshape(shape)
    assert float(np.abs(out.numpy().astype(np.float64) - ref).max()) <= lim


# ----------------------------------------------------------------------
# counterparts of tests/test_ref_stream.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tag,shape,dt,tol,mode", CASES)
def test_reference_blob_decompresses_within_bound(tag, shape, dt, tol, mode):
    blob, v = _load(tag, shape, dt)
    out = _decode(blob)
    assert out.shape == shape and out.dtype == dt
    err = float(np.max(np.abs(out.astype(np.float64) - v)))
    bound = tol * (float(np.abs(v).max()) if mode == "rel" else 1.0)
    assert err <= bound, f"{err} > {bound}"


def test_reference_header_parse():
    blob, _ = _load(*CASES[0][:3])
    h = ref_stream.parse_header(blob)
    assert h.shape == (65, 65, 65)
    assert h.dtype == np.float32
    assert h.compressor == ref_stream.ENC_X_LZ4
    assert np.isinf(h.s)
    assert abs(h.tol - 1e-3) < 1e-9
    assert ref_stream.sniff(blob[:8])
    assert not ref_stream.sniff(b"MGARDTPU")


def test_reference_header_crc_detects_corruption():
    blob, _ = _load(*CASES[0][:3])
    bad = bytearray(blob)
    bad[20] ^= 0xFF  # flip a protobuf byte
    with pytest.raises(FormatError):
        ref_stream.parse_header(bytes(bad))
    out, st = M.decompress(bytes(bad), device=CPU)
    assert out is None and st == M.compress_status_type.Failure


def test_reference_unsupported_backend_clean_error():
    """An out-of-enum backend id fails with a clear message."""
    blob, _ = _load(*CASES[0][:3])
    (hsize,) = struct.unpack_from("<Q", blob, 5)
    body = bytearray(blob[17: 17 + hsize])
    # Encoding submessage: field 11, wire type 2; compressor: field 2 varint
    idx = bytes(body).find(bytes([11 << 3 | 2]))
    assert idx >= 0
    ln = body[idx + 1]
    sub = body[idx + 2: idx + 2 + ln]
    cidx = bytes(sub).find(bytes([2 << 3 | 0, ref_stream.ENC_X_LZ4]))
    assert cidx >= 0
    body[idx + 2 + cidx + 1] = 13
    crc = zlib.crc32(bytes(body)) & 0xFFFFFFFF
    forged = (blob[:13] + struct.pack("<I", crc) + bytes(body)
              + blob[17 + hsize:])
    with pytest.raises(FormatError, match="unknown lossless backend"):
        ref_stream.decompress_reference(forged, CPU)
    out, st = M.decompress(forged, device=CPU)
    assert out is None and st == M.compress_status_type.Failure


@pytest.mark.parametrize(
    "tag,shape",
    [("335", (3, 3, 5)), ("559", (5, 5, 9)), ("5917", (5, 9, 17)),
     ("59", (5, 9))],
)
def test_singledim_x_recompose_inverts_reference(tag, shape):
    """recompose_single_x on the reference's own SingleDim coefficients
    (sdx_*.bin) reproduces the input to float64 eps, on a NumPy array and
    on a float64 tensor (the device path)."""
    from mgard_tpu_torch.hierarchy import get_hierarchy
    from mgard_tpu_torch.ops.refactor import recompose_single_x

    dec = np.fromfile(GOLDEN / f"sdx_dec_{tag}.bin",
                      np.float64).reshape(shape)
    inp = np.fromfile(GOLDEN / f"sdx_in_{tag}.bin", np.float64).reshape(shape)
    hier = get_hierarchy(shape, np.float64, None, M.Config())
    rec = recompose_single_x(dec, hier)
    np.testing.assert_allclose(rec, inp, rtol=0, atol=1e-12)
    rec_t = recompose_single_x(torch.from_numpy(dec), hier)
    assert isinstance(rec_t, torch.Tensor)
    np.testing.assert_allclose(rec_t.numpy(), inp, rtol=0, atol=1e-12)


def test_reference_singledim_stream_decodes():
    blob = (GOLDEN / "ref_blob_3d65_f32_sdim.mgard").read_bytes()
    ref_own = np.fromfile(GOLDEN / "ref_dec_3d65_f32_sdim.bin",
                          np.float32).reshape(65, 65, 65)
    out = _decode(blob)
    np.testing.assert_allclose(out.astype(np.float64), ref_own, rtol=0,
                               atol=2e-6)
    assert float(np.max(np.abs(out.astype(np.float64) - _input65()))) <= 1e-3


def test_reference_hybrid_stream_clean_error():
    blob = (GOLDEN / "ref_blob_3d65_f32_hyb.mgard").read_bytes()
    with pytest.raises(FormatError, match="hybrid"):
        ref_stream.decompress_reference(blob, CPU)
    out, st = M.decompress(blob, device=CPU)
    assert out is None and int(st) != 0


@pytest.mark.parametrize("tag", [
    "3d65_f32_bdfixed", "3d65_f32_bddelta", "3d65_f32_bdoutlier",
    "3d65_f32_symrans", "3d65_f32_zrlerans",
])
def test_reference_alt_lossless_classes_decode(tag):
    blob = (GOLDEN / f"ref_blob_{tag}.mgard").read_bytes()
    ref_own = np.fromfile(GOLDEN / f"ref_dec_{tag}.bin",
                          np.float32).reshape(65, 65, 65)
    out = _decode(blob)
    np.testing.assert_allclose(out.astype(np.float64), ref_own, rtol=0,
                               atol=1e-6)
    assert float(np.max(np.abs(out.astype(np.float64) - _input65()))) <= 1e-3


def test_reference_s0_blob_holds_l2_bound():
    blob, v = _load("3d65_f32_lz4_s0", (65, 65, 65), np.float32)
    out = _decode(blob)
    l2 = float(np.sqrt(np.mean((out.astype(np.float64) - v) ** 2)))
    assert l2 <= 1e-3, l2


@pytest.mark.parametrize("tag", [
    "3d643333_f32_lz4_abs_dd", "3d643333_f32_lz4_s0_dd",
])
def test_reference_decomposed_blob_matches_reference_decompressor(tag):
    """MaxDim domain-decomposed streams: ulp-level agreement with the
    reference's own decompressor (its decomposed compress is faulty, so
    its output, not the input, is the oracle)."""
    blob, _v = _load(tag, (64, 33, 33), np.float32)
    refdec = np.fromfile(GOLDEN / f"ref_dec_{tag}.bin",
                         np.float32).reshape(64, 33, 33)
    out = _decode(blob)
    assert float(np.max(np.abs(out.astype(np.float64) - refdec))) <= 1e-5


@pytest.mark.parametrize("tag,metric", [
    ("3d65_f32_huf_abs", "linf"),
    ("3d65_f32_huflz4_abs", "linf"),
    ("3d65_f32_hufzstd_s0", "l2"),
])
def test_reference_huffman_class_blob_decodes(tag, metric):
    blob, v = _load(tag, (65, 65, 65), np.float32)
    d = _decode(blob).astype(np.float64) - v
    err = float(np.max(np.abs(d)) if metric == "linf"
                else np.sqrt(np.mean(d ** 2)))
    assert err <= 1e-3, err


def test_write_reference_stream_roundtrip():
    _, v = _load("3d65_f32_lz4_abs", (65, 65, 65), np.float32)
    blob = ref_stream.compress_reference(v, 1e-3, math.inf, device=CPU)
    assert ref_stream.sniff(blob[:8])
    assert float(np.max(np.abs(_decode(blob).astype(np.float64) - v))) \
        <= 1e-3
    # a tensor is compressed where it lives
    assert ref_stream.compress_reference(torch.from_numpy(v), 1e-3) == blob


@pytest.mark.parametrize("tag,dt,tol,metric", [
    ("3d65_f32_abs", np.float32, 1e-3, "linf"),
    ("3d65_f32_s0", np.float32, 1e-3, "l2"),
    ("3d65_f64_abs", np.float64, 1e-4, "linf"),
])
def test_reference_decodes_our_written_stream(tag, dt, tol, metric):
    """xwrite_*.mgard was written by the JAX package's compress_reference
    and xwrite_dec_*.bin is the reference library's reconstruction of it:
    the port's writer gives the same bytes, and its decoder agrees with
    the reference's reconstruction to ulp."""
    v = _input65().astype(dt)
    refdec = np.fromfile(GOLDEN / f"xwrite_dec_{tag}.bin",
                         dt).reshape(65, 65, 65)
    d = refdec.astype(np.float64) - v
    err = float(np.max(np.abs(d)) if metric == "linf"
                else np.sqrt(np.mean(d ** 2)))
    assert err <= tol, err
    blob = (GOLDEN / f"xwrite_{tag}.mgard").read_bytes()
    s = 0.0 if tag.endswith("s0") else math.inf
    assert ref_stream.compress_reference(v, tol, s, device=CPU) == blob
    atol = 1e-5 if dt == np.float32 else 1e-12
    np.testing.assert_allclose(_decode(blob), refdec, rtol=0, atol=atol)


# ----------------------------------------------------------------------
# integer products against the JAX package's reader
# ----------------------------------------------------------------------
def _sections(mod, blob):
    """(header, per-subdomain section symbols) by `mod`'s section
    decoders."""
    h = mod.parse_header(blob)
    if h.decomposition == "hybrid":
        return h, []
    n_sub = 1
    if h.dd_method == 1:
        n_sub = -(-h.shape[h.dd_dim] // h.dd_size)
    p, out = h.header_bytes, []
    for k in range(n_sub):
        shp = list(h.shape)
        if h.dd_method == 1:
            shp[h.dd_dim] = min(h.dd_size, h.shape[h.dd_dim] - k * h.dd_size)
        (size,) = struct.unpack_from("<Q", blob, p)
        out.append(mod._decode_section(blob[p + 8: p + 8 + size],
                                       h.compressor, h.huff_dict_size or 8192,
                                       expected=int(np.prod(shp))))
        p += 8 + size
    return h, out


@pytest.mark.parametrize("name", REF_BLOBS + X_BLOBS)
def test_headers_and_section_symbols_equal_the_jax_readers(name):
    blob = (GOLDEN / name).read_bytes()
    th, tsyms = _sections(ref_stream, blob)
    jh, jsyms = _sections(JR, blob)
    td, jd = dataclasses.asdict(th), dataclasses.asdict(jh)
    tc, jc = td.pop("coords"), jd.pop("coords")
    assert td.pop("ebtype").name == jd.pop("ebtype").name
    assert td == jd
    assert (tc is None) == (jc is None)
    if tc is not None:
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)
    assert len(tsyms) == len(jsyms) and (len(tsyms) > 0) == (
        "hyb" not in name)
    for a, b in zip(tsyms, jsyms):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,dt,s,mode", [
    ((65, 65, 65), np.float32, math.inf, "ABS"),
    ((33, 40), np.float64, math.inf, "REL"),
    ((17, 17, 17), np.float32, 0.0, "ABS"),
])
def test_header_serializer_equals_the_jax_one(shape, dt, s, mode):
    args = (shape, dt, 1e-3, s)
    jb = JR.serialize_reference_header(*args, J.error_bound_type[mode],
                                       2.5, 6)
    tb = ref_stream.serialize_reference_header(
        *args, M.error_bound_type[mode], 2.5, 6)
    assert tb == jb


def _symbols(mod, blob):
    return _sections(mod, blob)[1][0]


def _smooth(shape, dtype, seed=0):
    """test_torch_generic.smooth: the fields the symbol contract is stated
    on."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    v = np.zeros(shape)
    for _ in range(4):
        acc = rng.uniform(0, 2 * np.pi)
        for k, g in zip(rng.integers(1, 5, len(shape)), grids):
            acc = acc + 2 * np.pi * k * g
        v = v + rng.uniform(0.3, 1.0) * np.sin(acc)
    return v.astype(dtype)


@pytest.mark.parametrize("field,shape,dt,s,mode", [
    ("walk", (33, 33, 33), np.float32, math.inf, "ABS"),
    ("walk", (20, 31, 9), np.float64, math.inf, "REL"),
    ("smooth", (33, 33, 33), np.float32, 0.0, "ABS"),
    ("smooth", (1000,), np.float32, 0.0, "REL"),
])
def test_writer_equals_the_jax_writer_and_both_decode_both(field, shape, dt,
                                                           s, mode):
    """compress_reference of both packages: the same bytes, or the same
    header and symbols within the symbol contract (at most 1 apart at under
    1e-4 of the positions) where the float transform's rounding moves a
    symbol; each package decodes the other's stream within the bound."""
    rng = np.random.default_rng(3)
    v = (np.cumsum(rng.standard_normal(shape), axis=-1).astype(dt)
         if field == "walk" else _smooth(shape, dt))
    tol = 1e-3
    jb = JR.compress_reference(v, tol, s, J.error_bound_type[mode])
    tb = ref_stream.compress_reference(v, tol, s, M.error_bound_type[mode],
                                       device=CPU)
    if tb != jb:
        jh, th = JR.parse_header(jb), ref_stream.parse_header(tb)
        assert jb[:jh.header_bytes] == tb[:th.header_bytes] or (
            mode == "REL" and not math.isinf(s)
            and abs(jh.norm - th.norm) <= 1e-14 * jh.norm)
        js, ts = _symbols(JR, jb), _symbols(ref_stream, tb)
        d = np.abs(js - ts)
        assert d.max() <= 1 and np.count_nonzero(d) < 1e-4 * d.size
    scale = (float(np.abs(v).max()) if math.isinf(s)
             else float(np.sqrt(np.sum(v.astype(np.float64) ** 2))))
    lim = tol * (scale if mode == "REL" else 1.0)
    for blob in (jb, tb):
        out_t = _decode(blob).astype(np.float64)
        out_j, st = J.decompress(blob)
        assert int(st) == 0
        np.testing.assert_allclose(out_t, np.asarray(out_j, np.float64),
                                   rtol=0, atol=1e-5 * max(1.0, scale))
        if math.isinf(s):
            assert float(np.abs(out_t - v).max()) <= lim


# ----------------------------------------------------------------------
# this package's own streams are not reference streams
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,s", [((17, 17, 17), np.inf),
                                     ((33, 40), 0.0), ((1000,), np.inf)])
def test_port_stream_is_not_sniffed_and_decodes(shape, s):
    rng = np.random.default_rng(11)
    v = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    blob, st = M.compress(v, 1e-2, s=s, device=CPU)
    assert st == OK
    assert blob[:len(MAGIC)] == MAGIC and not ref_stream.sniff(blob[:8])
    out, st2 = M.decompress(blob, device=CPU)
    assert st2 == OK
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
                         device=CPU)
    out, st = M.decompress(blob[:12], device=CPU)
    assert out is None and st == M.compress_status_type.Failure
    # and a truncated reference stream too
    ref = (GOLDEN / "ref_blob_3d65_f32_lz4_abs.mgard").read_bytes()
    for cut in (10, 40, len(ref) // 2):
        out, st = M.decompress(ref[:cut], device=CPU)
        assert out is None and st == M.compress_status_type.Failure
