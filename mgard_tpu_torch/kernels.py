"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and linked into
one shared library with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds). The library goes to ``build/kernels/``
at the root of the checkout, named by a hash of the sources and flags, so a
changed source builds anew and an unchanged one is reused.

Each C entry point launches its kernel (for K2/K3 a short chain of
kernels; for K14 the passes of one level step; for a probe the variant it
is asked for) on the stream
it is given and returns ``cudaGetLastError()``; ``launch`` raises on a
nonzero code and only then counts the launch in ``LAUNCHES`` (the ``launch``
group of ``utils/trace.py``'s counters). The build and the load are the
spans ``kernel.build`` / ``kernel.load``, counted with their nanoseconds.
Nothing here runs on import, and nothing falls back: a CUDA tensor either
reaches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .utils import trace

_CSRC = Path(__file__).resolve().parent / "csrc"
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# -fmad=false: the plain versions compute a*b + c as two rounded IEEE
# operations; contracting them into an fma would change the low bits.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # v, inv_q, pay, cw, rem, X, Y, Z, C, nl, stream
    "hybrid_fwd_v2": [_P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # pay, rem, q, out, X, Y, Z, nl, stream
    "hybrid_inv_v2": [_P, _P, _F, _P, _I, _I, _I, _I, _P],
    # rows, wide, rank, inv (scratch), woff, rband, sb_off, base, resid, NB,
    # C, sbc, K, E, stream
    "bfp_encode": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                   _P],
    # base, resid, rank, inv (scratch), woff, rband, sb_off, cnt, out, wide,
    # NB, C, sbc, K, E, stream
    "bfp_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                   _I, _P],
    # resid, tab, out, bands, C, stream
    "bfp_compact": [_P, _P, _P, _L, _I, _P],
    # wire, tab, resid, bands, C, stream
    "bfp_expand": [_P, _P, _P, _L, _I, _P],
    # sym, widths, scratch, offs, out, NB, sb, align, stream
    "bfx_encode": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    # words, widths, scratch, sym, NB, sb, align, stream
    "bfx_decode": [_P, _P, _P, _P, _L, _I, _I, _P],
    # v, inv_q, sym, rem, X, Y, Z, nl, stream
    "hybrid_fwd": [_P, _F, _P, _P, _I, _I, _I, _I, _P],
    # sym, rem, q, out, X, Y, Z, nl, stream
    "hybrid_inv": [_P, _P, _F, _P, _I, _I, _I, _I, _P],
    # v, exp, planes, emax, esq, m, B, stream
    "bitplane_encode": [_P, _P, _P, _P, _P, _L, _I, _P],
    # v, inv_q, base, resid, cw, rem, X, Y, Z, nl, K, E, stream
    "hybrid_pack_v3": [_P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # base, crl, resid, rem, q, out, X, Y, Z, nl, K, E, stream
    "hybrid_unpack_v3": [_P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I, _I, _P],
    # K14, one MultiDim level step of a 3D field:
    # src, out, S0, S1, cd, C0, C1, tab, scr, n0, n1, n2, orthogonal, f64,
    # stream
    "multidim_decompose": [_P, _P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _I,
                           _I, _I, _P],
    # dec, S0, S1, c, dst, tab, scr, n0, n1, n2, orthogonal, f64, stream
    "multidim_recompose": [_P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P],
    # the layout probes P1-P3 (csrc/probes.cu), each with a variant number:
    # planes, woff, sb_off, out, NSB, E, W, total_rows, variant, stream
    "probe_dynwin": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, out, rows of 32 words, mul, variant, stream
    "probe_relayout": [_P, _P, _L, _I, _I, _P],
    # zz, out, S, variant, stream
    "probe_u16_planes": [_P, _P, _L, _I, _P],
}
# A probe's launches are counted per variant, under these names.
_PROBE_COUNTERS = (
    "probe_dynwin_or", "probe_dynwin_owner", "probe_dynwin_run",
    "probe_dynwin_bulk", "probe_relayout_direct",
    "probe_relayout_cpasync", "probe_relayout_row32", "probe_relayout_row33",
    "probe_u16_ballot", "probe_u16_butterfly")

# Launch counts per kernel, bumped only where a kernel was launched: the
# "launch" group of the counter registry.
LAUNCHES = trace.group("launch")
LAUNCHES.update({name: 0 for name in _SIGNATURES
                 if not name.startswith("probe_")})
LAUNCHES.update({name: 0 for name in _PROBE_COUNTERS})
# nvcc's output of the last build (register and shared-memory use).
BUILD_LOG = ""

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    cands += [_DEFAULT_NVCC]
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit of the GPU host")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmgard_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists: one nvcc
    per source, run in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter_ns()
    with trace.span("kernel.build"):
        _build(out)
    trace.count("kernel.build")
    trace.count("kernel.build_ns", time.perf_counter_ns() - t0)
    return out


def _build(out: Path) -> None:
    global BUILD_LOG
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cus, _ = _sources()
    objs = [tmp.with_name(f"{tmp.name}.{cu.stem}.o") for cu in cus]
    logs = [o.with_suffix(".log") for o in objs]
    try:
        procs = []
        for cu, obj, log in zip(cus, objs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o",
                     str(obj), str(cu)], stdout=f, stderr=subprocess.STDOUT))
        codes = [p.wait() for p in procs]
        BUILD_LOG = "".join(log.read_text() for log in logs)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{BUILD_LOG}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        BUILD_LOG += res.stdout + res.stderr
        if res.returncode:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{BUILD_LOG}")
        os.replace(tmp, out)
    finally:
        for path in objs + logs + [tmp]:
            path.unlink(missing_ok=True)


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path = build()
        t0 = time.perf_counter_ns()
        with trace.span("kernel.load"):
            L = _load(path)
        trace.count("kernel.load")
        trace.count("kernel.load_ns", time.perf_counter_ns() - t0)
        _lib = L
    return _lib


def _load(path: Path):
    L = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(L, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    L.mgard_cuda_error_string.argtypes = [ctypes.c_int]
    L.mgard_cuda_error_string.restype = ctypes.c_char_p
    # Z, int[2] out: a query, not a launch
    L.hybrid_v3_max_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    L.hybrid_v3_max_clusters.restype = ctypes.c_int
    return L


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what every wrapper checks before handing a pointer over)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: must be contiguous on {device}")


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args, count_as: str = None) -> None:
    """Launch kernel ``name``; raise if CUDA refused it, else count it
    (under ``count_as`` where one entry point serves several variants)."""
    L = lib()
    rc = getattr(L, name)(*args)
    if rc:
        msg = L.mgard_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[count_as or name] += 1
