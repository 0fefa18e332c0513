"""P1-P3: the Hopper counterparts of the JAX package's three TPU layout
probes (``scripts/probe_dynwin.py``, ``scripts/probe_strided_dma.py``,
``scripts/probe_u16.py``).

Each TPU probe asked one layout question before a BFP kernel was written;
none is on a path of the package. The kernels of ``csrc/probes.cu``
compute what the probes compute and put the same questions to the card, in
the variants the answer chooses between (``VARIANTS``):

- P1 ``dynwin_place``: place the residual planes of each superblock at
  content-dependent row offsets, then E*W zero capacity rows. Each plane's
  content rows are one contiguous run at both ends: "bulk" (the default,
  the fastest on an H100) copies a run per block by TMA bulk copies
  through shared memory, "run" by 16-byte loads, four in flight a thread;
  "or": zero a shared tile and OR the plane windows in, as the TPU kernel
  did in VMEM; "owner": each output row copies the one plane that owns it.
  Every variant writes each output row once, the tail included, in one
  launch.
- P2 ``relayout``: (sbc, 128) <-> (4 sbc, 32) with the rows doubled on the
  way forward. One layout in linear memory; the variants differ in staging:
  "direct" 16-byte loads, "cpasync" through shared memory with a warp per
  row, "row32"/"row33" a thread per row at a pitch of 32 or 33 words.
- P3 ``u16_planes``: (S, 32) u16 symbols -> (16, S) plane words. "ballot":
  a warp per block, 16 ``__ballot_sync``; "butterfly": a thread per block,
  a 4-step register butterfly on both 16-symbol halves at once.

Each wrapper has its plain PyTorch version beside it, which serves CPU
tensors and the comparison on the card; a CUDA tensor launches the kernel
or raises. Words are int32 bit patterns and u16 symbols int16 bit
patterns, as everywhere in the port. ``run_all`` drives every variant at
the probe's own shape and at one production shape and returns the
findings; ``scripts/probe_h100.py`` prints them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .lossless.bfx import _bit_transpose32

_I32 = torch.int32
LANES = 128

VARIANTS = {
    "dynwin": ("or", "owner", "run", "bulk"),
    "relayout": ("direct", "cpasync", "row32", "row33"),
    "u16": ("ballot", "butterfly"),
}


def counter(probe: str, variant: str) -> str:
    """Key of a variant's launch count in ``kernels.LAUNCHES``."""
    return f"probe_{probe}_{variant}"


def _variant(probe: str, variant: str) -> int:
    if variant not in VARIANTS[probe]:
        raise ValueError(f"{probe}: variant {variant!r} not in "
                         f"{VARIANTS[probe]}")
    return VARIANTS[probe].index(variant)


def _need_cuda(t, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")


# ----------------------------------------------------------------------
# P1: dynamic-window placement
# ----------------------------------------------------------------------
def dynwin_inputs(NSB: int, E: int, W: int, seed: int = 0, device="cpu"):
    """The probe's inputs at geometry (NSB, E, W): random plane words with
    rows past each plane's random row count zero (the sorted-suffix-zero
    invariant), the row offsets of each plane inside its superblock, each
    superblock's offset, and the total row count."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(1, 1 << 30, size=(NSB, E, W, LANES),
                          dtype=np.int64).astype(np.int32)
    rows = rng.integers(1, W + 1, size=(NSB, E)).astype(np.int32)
    planes[np.arange(W)[None, None, :] >= rows[:, :, None]] = 0
    woff = (np.cumsum(rows, 1) - rows).astype(np.int32)
    tot = rows.sum(1)
    sb_off = (np.cumsum(tot) - tot).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(planes), to(woff), to(sb_off), int(tot.sum())


def _dynwin_check(planes, woff, sb_off):
    if planes.ndim != 4 or planes.shape[3] != LANES:
        raise ValueError(f"planes: expected (NSB, E, W, {LANES}), got "
                         f"{tuple(planes.shape)}")
    NSB, E, W, _ = planes.shape
    dev = planes.device
    kernels.check_tensor("planes", planes, _I32, (NSB, E, W, LANES), dev)
    kernels.check_tensor("woff", woff, _I32, (NSB, E), dev)
    kernels.check_tensor("sb_off", sb_off, _I32, (NSB,), dev)
    return NSB, E, W


def dynwin_place_plain(planes, woff, sb_off, total_rows: int):
    """Plain version of P1: (total_rows + E*W, 128) int32, superblock i's
    planes concatenated at row sb_off[i], plane j at woff[i, j], the E*W
    capacity rows past the end zero."""
    NSB, E, W = _dynwin_check(planes, woff, sb_off)
    end = torch.cat([sb_off[1:], sb_off.new_full((1,), total_rows)])
    nxt = torch.cat([woff[:, 1:], (end - sb_off)[:, None]], dim=1)
    w = torch.arange(W, device=planes.device)
    valid = w[None, None, :] < (nxt - woff)[:, :, None]
    dst = (sb_off[:, None, None] + woff[:, :, None] + w[None, None, :]).long()
    out = torch.zeros((total_rows + E * W, LANES), dtype=_I32,
                      device=planes.device)
    out[dst[valid]] = planes[valid]
    return out


def _dynwin_launch(planes, woff, sb_off, total_rows: int, variant: str):
    """The card's branch of dynwin_place: one launch, every output row
    written by the kernel, total_rows passed as an int (no host-to-device
    copy, so a call can be captured in a CUDA graph)."""
    NSB, E, W, _ = planes.shape
    out = torch.empty((total_rows + E * W, LANES), dtype=_I32,
                      device=planes.device)
    kernels.launch("probe_dynwin", planes.data_ptr(), woff.data_ptr(),
                   sb_off.data_ptr(), out.data_ptr(), NSB, E, W,
                   int(total_rows), _variant("dynwin", variant),
                   kernels.stream(planes.device),
                   count_as=counter("dynwin", variant))
    return out


def dynwin_place(planes, woff, sb_off, total_rows: int,
                 variant: str = "bulk"):
    """P1 wrapper (replaces the pallas_call of scripts/probe_dynwin.py).
    Same output as dynwin_place_plain."""
    _variant("dynwin", variant)
    _dynwin_check(planes, woff, sb_off)
    if planes.device.type == "cpu":
        return dynwin_place_plain(planes, woff, sb_off, total_rows)
    _need_cuda(planes, "dynwin_place")
    return _dynwin_launch(planes, woff, sb_off, total_rows, variant)


# ----------------------------------------------------------------------
# P2: chunk-row relayout
# ----------------------------------------------------------------------
def _relayout_check(x, reverse: bool):
    cols = 32 if reverse else LANES
    if x.ndim != 2 or x.shape[1] != cols or (reverse and x.shape[0] % 4):
        raise ValueError(f"relayout: expected (n, {cols}) rows, got "
                         f"{tuple(x.shape)}")
    kernels.check_tensor("x", x, _I32, x.shape, x.device)
    return (x.shape[0] // 4, LANES) if reverse else (x.shape[0] * 4, 32)


def relayout_plain(x, reverse: bool = False):
    """Plain version of P2. Forward: (sbc, 128) -> (4 sbc, 32), row 4c+g =
    lanes [32g, 32g+32) of row c, doubled. Reverse: (4 sbc, 32) ->
    (sbc, 128), copied."""
    shape = _relayout_check(x, reverse)
    return x.reshape(shape).clone() if reverse else x.reshape(shape) * 2


def relayout(x, reverse: bool = False, variant: str = "direct"):
    """P2 wrapper (replaces both pallas_calls of
    scripts/probe_strided_dma.py). Same output as relayout_plain."""
    v = _variant("relayout", variant)
    shape = _relayout_check(x, reverse)
    if x.device.type == "cpu":
        return relayout_plain(x, reverse)
    _need_cuda(x, "relayout")
    out = torch.empty(shape, dtype=_I32, device=x.device)
    kernels.launch("probe_relayout", x.data_ptr(), out.data_ptr(),
                   x.numel() // 32, 1 if reverse else 2, v,
                   kernels.stream(x.device),
                   count_as=counter("relayout", variant))
    return out


# ----------------------------------------------------------------------
# P3: u16 symbols -> 16 plane words
# ----------------------------------------------------------------------
def _u16_check(zz):
    if zz.ndim != 2 or zz.shape[1] != 32:
        raise ValueError(f"u16_planes: expected (S, 32), got "
                         f"{tuple(zz.shape)}")
    kernels.check_tensor("zz", zz, torch.int16, zz.shape, zz.device)
    return zz.shape[0]


def u16_planes_plain(zz):
    """Plain version of P3: (S, 32) int16 (u16 bits) -> (16, S) int32, bit k
    of word (j, b) = bit j of symbol k of block b."""
    _u16_check(zz)
    zi = (zz.to(_I32) & 0xFFFF).t()  # row k = symbol k of every block
    return _bit_transpose32(zi)[:16].contiguous()


def u16_planes(zz, variant: str = "ballot"):
    """P3 wrapper (replaces the pallas_call of scripts/probe_u16.py). Same
    output as u16_planes_plain."""
    v = _variant("u16", variant)
    S = _u16_check(zz)
    if zz.device.type == "cpu":
        return u16_planes_plain(zz)
    _need_cuda(zz, "u16_planes")
    out = torch.empty((16, S), dtype=_I32, device=zz.device)
    kernels.launch("probe_u16_planes", zz.data_ptr(), out.data_ptr(), S, v,
                   kernels.stream(zz.device),
                   count_as=counter("u16", variant))
    return out


# ----------------------------------------------------------------------
# The probe run
# ----------------------------------------------------------------------
# (probe's own shape, one production shape): P1 (NSB, E, W), the second
# K2's geometry at 512^3 (bfp.SB_BLOCKS 16384: 256 superblocks, E 8, 128
# rows a plane); P2 sbc, the second 128 MB; P3 S, the second the 512^3 cf
# stream (268 MB each way).
SHAPES = {
    "dynwin": ((8, 4, 4), (256, 8, 128)),
    "relayout": (256, 1 << 18),
    "u16": (4096, 1 << 22),
}
# P2's tail case: rows of 128 words whose int4 count (32 a row) is no
# multiple of the 1024 a block of the direct variant moves, so its last
# block is ragged, over more than one wave of blocks
RELAYOUT_TAIL = (1 << 16) + 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
LIBRARY_CALL = {"relayout": "reshape*2", "relayout_rev": "reshape.clone"}


def _time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn over reps launches (CUDA events, one
    warm-up)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cases(device, seed: int = 0, production: bool = True):
    """Yield (probe, shape, variants, kernel(variant), plain(), library() or
    None, bytes moved) for every probe at both shapes, inputs on `device`.
    library() is the one PyTorch call that computes the same function,
    where there is one: P2's ``reshape * 2`` forward and ``reshape.clone``
    in reverse (LIBRARY_CALL names it).
    Bytes: each word the function must read, once, and each it must write,
    once; for P1 the content rows this run's data holds, read and written,
    and the E*W zero tail rows written, not the planes' capacity. Without
    `production`, the probes' own small shapes only; with it, also P2's
    ragged RELAYOUT_TAIL."""
    rng = np.random.default_rng(seed)
    take = slice(None) if production else slice(0, 1)
    for geom in SHAPES["dynwin"][take]:
        args = dynwin_inputs(*geom, seed=seed, device=device)
        yield ("dynwin", geom, VARIANTS["dynwin"],
               lambda v, a=args: dynwin_place(*a, variant=v),
               lambda a=args: dynwin_place_plain(*a), None,
               (2 * args[3] + geom[1] * geom[2]) * LANES * 4)
    tail = (RELAYOUT_TAIL,) if production else ()
    for sbc in SHAPES["relayout"][take] + tail:
        x = torch.from_numpy(rng.integers(0, 1 << 30, (sbc, LANES),
                                          dtype=np.int64).astype(np.int32))
        x = x.to(device)
        t = relayout_plain(x) // 2  # a (4 sbc, 32) input of the reverse
        for rev, inp in ((False, x), (True, t)):
            yield ("relayout_rev" if rev else "relayout", sbc,
                   VARIANTS["relayout"][:2] if rev else VARIANTS["relayout"],
                   lambda v, i=inp, r=rev: relayout(i, r, variant=v),
                   lambda i=inp, r=rev: relayout_plain(i, r),
                   (lambda i=inp: i.reshape(-1, LANES).clone()) if rev
                   else (lambda i=inp: i.reshape(-1, 32) * 2),
                   2 * inp.numel() * 4)
    for S in SHAPES["u16"][take]:
        zz = torch.from_numpy(rng.integers(0, 1 << 14, (S, 32),
                                           dtype=np.int64).astype(np.int16))
        zz = zz.to(device)
        yield ("u16", S, VARIANTS["u16"],
               lambda v, z=zz: u16_planes(z, variant=v),
               lambda z=zz: u16_planes_plain(z), None, 2 * S * 64)


def run_all(device="cuda", timed: bool = True, production: bool = True):
    """Run every variant of every probe at both shapes on `device` and hold
    it against the plain version; on a CUDA device also time it. Returns a
    list of findings, one per (probe, shape, variant): dict(probe, shape,
    variant, equal, ms, plain_ms, library_ms, bytes, bound_ms). Raises if a variant
    differs from its plain version."""
    dev = torch.device(device)
    on_card = dev.type == "cuda" and timed
    out = []
    for probe, shape, variants, kern, plain, library, moved in cases(
            dev, production=production):
        want = plain()
        plain_ms = _time_ms(plain, 2) if on_card else None
        lib_ms = _time_ms(library) if on_card and library else None
        for v in variants:
            got = kern(v)
            if not torch.equal(got, want):
                raise AssertionError(f"probe {probe} at {shape}, variant {v}: "
                                     "differs from the plain version")
            out.append(dict(
                probe=probe, shape=shape, variant=v, equal=True,
                ms=_time_ms(lambda: kern(v)) if on_card else None,
                plain_ms=plain_ms, library_ms=lib_ms, bytes=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3))
        del want
    return out
