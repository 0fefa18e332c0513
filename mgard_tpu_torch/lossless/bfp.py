"""BFP — width-sorted prefix bitplane codec, blob format "BFP5" (port of
``mgard_tpu/lossless/bfp.py``; the wire format is documented there and in
doc/FORMAT.md, and the two packages write identical bytes for identical
symbols).

Per superblock of sb 32-symbol blocks, chunks of C blocks are stably sorted
by residual length (a counting sort, ``_sort_plan``); every block stores K
dense base planes and E residual planes of which exactly the chunks with
rl > j hold plane K+j, so after sorting each residual plane is a prefix.
Chunks wider than K+E ship verbatim as exceptions.

Two CUDA kernels do the bit packing on the GPU: ``encode_bands`` (K2,
csrc/bfp.cu) and ``decode_bands`` (K3). Both take natural-order chunk rows
and the sort rank; on the card a thread owns a block of a sorted column
and reads (or writes) its chunk through the inverse of rank, so the sort
needs no row gather pass on either side. Two more map K2's row-padded
bands to the compact wire words and back: ``compact_wire`` (K12) and
``expand_wire`` (K13), so that the host moves each wire byte once (a copy
straight into the blob, an upload straight from it). Each wrapper takes
the plain version beside it for CPU tensors and launches its kernel for
CUDA tensors: a blob has one path on every device.

Packed words are int32 bit patterns and u16 payloads ``torch.int16`` bit
patterns (torch lacks shifts and max on uint32/uint16 on the CPU).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import kernels
from ..ops.compact import masked_indices
from ..ops.hybrid import bit_length
from ..utils.trace import count, span, to_device, to_host, traced
from .bfx import BS, _bit_transpose32, _blob_tensor, _unzigzag, _zigzag

SB_BLOCKS = 16384
# Below SB_PALLAS_MIN*32 symbols a stream uses BFX (highlevel
# ``_effective_raw_lt``), and an explicit v2 superblock must reach it
# (``_v2_sb``): a format threshold, the same in both packages.
SB_PALLAS_MIN = 8192
SB_BLOCKS_SMALL = 256
E_DEFAULT = 8
LANES = 128
CHUNK = 8

_MAGIC = b"BFP5"
_HDR = "<4sQQBBIBQ"

_I32 = torch.int32


def _chunk_widths(zz_rows):
    """(NC,) bit widths of the u32 max of each row of int32 zigzag
    patterns (a negative int32 has bit 31 set: width 32)."""
    w = bit_length(zz_rows.amax(1))
    return torch.where(zz_rows.amin(1) < 0, torch.full_like(w, 32), w)


# ----------------------------------------------------------------------
# Counting sort (shared by encode and decode; must be bit-identical)
# ----------------------------------------------------------------------
def _sort_plan(rl2, E: int):
    """Stable descending counting sort of rl2 (NSB, sbc) in [0, E].

    Returns (rank (NSB, sbc) int32 — destination column of each natural
    chunk, cnt (NSB, E) int32 — cnt[:, j] = #(rl > j))."""
    NSB, sbc = rl2.shape
    rank = torch.zeros((NSB, sbc), dtype=_I32, device=rl2.device)
    cnt_gt = torch.zeros((NSB, 1), dtype=_I32, device=rl2.device)
    cnts = []
    for k in range(E, -1, -1):
        eq = (rl2 == k).to(_I32)
        # dtype= pins int32: torch promotes cumsum/sum to int64 otherwise
        prefix = torch.cumsum(eq, 1, dtype=_I32) - eq
        rank = rank + eq * (cnt_gt + prefix)
        cnts.append(cnt_gt)  # before adding bucket k: #(rl > k)
        cnt_gt = cnt_gt + torch.sum(eq, 1, keepdim=True, dtype=_I32)
    cnt = torch.cat([cnts[E - j] for j in range(E)], dim=1)
    return rank, cnt


def _plan_offsets(cnt_c, C: int):
    """Per-band row counts rband (NSB, E), plane row offsets woff within
    each superblock, superblock row offsets sb_off (NSB,), and the total
    row count (0-dim tensor). Each plane stores C bands of rband rows."""
    rband = (cnt_c + (LANES - 1)) // LANES
    rows = rband * C
    woff = torch.cumsum(rows, 1, dtype=_I32) - rows
    tot = torch.sum(rows, 1, dtype=_I32)
    sb_off = torch.cumsum(tot, 0, dtype=_I32) - tot
    return rband, woff, sb_off, sb_off[-1] + tot[-1]


def _static_plan(NSB: int, E: int, sb: int, C: int, device):
    """(rband, woff, sb_off) of the static-cap layout (the fused flag-2
    front end): superblock i owns CAP = E*sb/128 rows at row i*CAP, and
    band (plane j, slot b) the full BPR = sbc/128 rows at (j*C + b)*BPR
    inside it, whatever the widths."""
    BPR = (sb // C) // LANES
    rband = torch.full((NSB, E), BPR, dtype=_I32, device=device)
    woff = (torch.arange(E, dtype=_I32, device=device) * (C * BPR)
            ).repeat(NSB, 1)
    sb_off = torch.arange(NSB, dtype=_I32, device=device) * (E * (sb // LANES))
    return rband, woff, sb_off


@traced("codec.bfp_plan")
def _zz_plan(crl, E: int, sb: int, C: int, static_cap: bool):
    """Sort plan and band offsets of a prepared-payload stream: (rank, cnt,
    rband, woff, sb_off, resid_rows, alloc_rows)."""
    NSB = crl.shape[0] * C // sb
    rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sb // C), E)
    CAP = E * (sb // LANES)
    if static_cap:
        rband, woff, sb_off = _static_plan(NSB, E, sb, C, crl.device)
        return rank_c, cnt_c, rband, woff, sb_off, NSB * CAP, NSB * CAP
    rband, woff, sb_off, resid_rows = _plan_offsets(cnt_c, C)
    return rank_c, cnt_c, rband, woff, sb_off, resid_rows, (NSB + 1) * CAP


# ----------------------------------------------------------------------
# K2 / K3: plain versions and kernel wrappers
# ----------------------------------------------------------------------
def _band_index(woff, rband, sb_off, j: int, C: int, sbc: int):
    """Flat resid word index of (sb, band b, column c') for plane j, and
    the in-band mask c' < rband*128. Shapes (NSB, C, sbc)."""
    dev = woff.device
    rb = rband[:, j].long()[:, None, None]
    start = (sb_off.long() + woff[:, j].long())[:, None, None]
    b = torch.arange(C, device=dev)[None, :, None]
    col = torch.arange(sbc, device=dev)[None, None, :]
    return (start + b * rb) * LANES + col, col


def encode_bands_plain(rows, rank, woff, rband, sb_off, K: int, E: int,
                       sb: int, C: int, alloc_rows: int):
    """Plain version of K2: natural-order zigzag chunk rows (NC, 32C)
    (int16 = u16 bits, or int32 = u32 bits) + rank (NSB, sbc) -> (base
    (NSB, max(K,1), C, sbc) int32, resid2d (alloc_rows, 128) int32)."""
    NC = rows.shape[0]
    sbc = sb // C
    NSB = NC // sbc
    dev = rows.device
    rank_g = (rank.long()
              + torch.arange(NSB, device=dev)[:, None] * sbc).reshape(-1)
    srt = torch.empty_like(rows)
    srt[rank_g] = rows
    u = srt.to(_I32)
    if rows.dtype == torch.int16:
        u = u & 0xFFFF
    # zi[k, s, b, c'] = symbol k of block slot b of sorted chunk c'
    zi = u.reshape(NSB, sbc, C, BS).permute(3, 0, 2, 1)
    zt = _bit_transpose32(zi)
    base = torch.zeros((NSB, max(K, 1), C, sbc), dtype=_I32, device=dev)
    if K:
        base[:, :K] = zt[:K].permute(1, 0, 2, 3)
    resid = torch.zeros(alloc_rows * LANES, dtype=_I32, device=dev)
    for j in range(E):
        idx, col = _band_index(woff, rband, sb_off, j, C, sbc)
        ok = (col < rband[:, j].long()[:, None, None] * LANES).expand(
            NSB, C, sbc)
        resid[idx[ok]] = zt[K + j][ok]
    return base, resid.reshape(alloc_rows, LANES)


def decode_bands_plain(base, resid2d, rank, woff, rband, sb_off, cnt_c,
                       K: int, E: int, sb: int, C: int, wide: bool):
    """Plain version of K3: band buffers -> natural-order zigzag chunk rows
    (NC, 32C), int32 (wide) or int16 (u16 bits)."""
    NSB = base.shape[0]
    sbc = sb // C
    dev = base.device
    flat = resid2d.reshape(-1)
    zt = torch.zeros((32, NSB, C, sbc), dtype=_I32, device=dev)
    if K:
        zt[:K] = base[:, :K].permute(1, 0, 2, 3)
    for j in range(E):
        idx, col = _band_index(woff, rband, sb_off, j, C, sbc)
        ok = (col < cnt_c[:, j].long()[:, None, None]).expand(NSB, C, sbc)
        zt[K + j] = torch.where(ok, flat[torch.where(ok, idx, 0)], 0)
    srt = _bit_transpose32(zt).permute(1, 3, 2, 0).reshape(NSB * sbc, C * BS)
    rank_g = (rank.long()
              + torch.arange(NSB, device=dev)[:, None] * sbc).reshape(-1)
    nat = srt[rank_g]
    return nat if wide else nat.to(torch.int16)


# Edge cases of K2/K3, run by the CPU schedule test and by chip_smoke.py on
# the card: (name, row bits, K, E, sb, C, superblocks, chunk widths,
# static-cap layout). Widths: "mixed" random in [0, w_max] with one
# superblock of zero chunks first, "all" every width 0..w_max in shuffled
# order, "one" a single width (rank is the identity), "low" at most K+2
# (rband 0 on the planes above); w_max = min(K+E, row bits).
BAND_CASES = (
    ("u16 K=4 E=8 mixed", 16, 4, 8, 256, 2, 3, "mixed", False),
    ("u16 K=0 (Kp=1)", 16, 0, 8, 256, 2, 2, "mixed", False),
    ("u16 K+E=16 every width", 16, 8, 8, 512, 4, 2, "all", False),
    ("u16 rows K+E=18", 16, 10, 8, 256, 2, 2, "mixed", False),
    ("u32 K+E=32 every width", 32, 17, 15, 256, 2, 2, "all", False),
    ("u32 K=12 E=8 C=1", 32, 12, 8, 256, 1, 2, "mixed", False),
    ("u32 rows K+E=12", 32, 4, 8, 256, 2, 2, "mixed", False),
    ("one width (rank identity)", 16, 3, 8, 256, 2, 2, "one", False),
    ("low widths (rband 0)", 16, 5, 8, 256, 2, 2, "low", False),
    ("sb=16384 C=8", 16, 3, 8, 16384, 8, 1, "mixed", False),
    ("static-cap layout", 16, 8, 8, 512, 4, 2, "mixed", True),
)


def case_widths(spec, rng) -> np.ndarray:
    """The (NC,) chunk widths of one BAND_CASES entry, drawn from rng."""
    _name, bits, K, E, sb, C, nsb, widths, _static = spec
    sbc = sb // C
    NC = nsb * sbc
    wmax = min(K + E, bits)
    if widths == "all":
        return rng.permutation(np.arange(NC) % (wmax + 1))
    if widths == "one":
        return np.full(NC, min(K + 3, wmax))
    cw = rng.integers(0, (K + 3 if widths == "low" else wmax) + 1, NC)
    if widths == "mixed":
        cw[:sbc] = 0
    return cw


def band_case(spec, device="cpu", seed: int = 0):
    """Inputs of one BAND_CASES entry: (encode_bands arguments, cnt,
    resid_rows). Every chunk's width stays within K+E and the row width,
    so K3 gives the rows back."""
    _name, bits, K, E, sb, C, nsb, _widths, static = spec
    rng = np.random.default_rng(seed)
    cw = case_widths(spec, rng)
    NC = cw.shape[0]
    sym = rng.integers(0, 1 << 32, (NC, C * BS), np.uint64)
    sym &= (np.uint64(1) << cw[:, None].astype(np.uint64)) - np.uint64(1)
    top = np.where(cw > 0, np.uint64(1) << np.maximum(cw - 1, 0).astype(
        np.uint64), np.uint64(0))
    sym[np.arange(NC), rng.integers(0, C * BS, NC)] |= top  # width exactly cw
    rows = (sym.astype(np.uint16).view(np.int16) if bits == 16
            else sym.astype(np.uint32).view(np.int32))
    crl = torch.from_numpy(np.clip(cw - K, 0, E).astype(np.int32)).to(device)
    rank, cnt, rband, woff, sb_off, resid_rows, alloc_rows = _zz_plan(
        crl, E, sb, C, static)
    args = (torch.from_numpy(rows).to(device), rank, woff, rband, sb_off, K,
            E, sb, C, alloc_rows)
    return args, cnt, int(resid_rows)


def _check_plan(rank, woff, rband, sb_off, NSB, sbc, E, device):
    check = kernels.check_tensor
    check("rank", rank, _I32, (NSB, sbc), device)
    check("woff", woff, _I32, (NSB, E), device)
    check("rband", rband, _I32, (NSB, E), device)
    check("sb_off", sb_off, _I32, (NSB,), device)


def encode_bands(rows, rank, woff, rband, sb_off, K: int, E: int, sb: int,
                 C: int, alloc_rows: int):
    """K2 wrapper (replaces mgard_tpu/lossless/bfp.py _encode_pallas), both
    modes: the cf stream (u16 rows) and the generic stream (u16 or u32
    rows). Same outputs as encode_bands_plain. On the card rows must be
    16-byte aligned (vector loads): a misaligned view raises."""
    dev = rows.device
    if rows.dtype not in (torch.int16, _I32) or rows.ndim != 2:
        raise ValueError(f"rows: expected int16/int32 (NC, 32C), got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if sb % (C * LANES) or rows.shape[1] != C * BS or not 1 <= E <= 15:
        raise ValueError(f"bad geometry sb={sb} C={C} E={E}")
    if K < 0 or K + E > 32:
        raise ValueError(f"K={K}, E={E}: K+E must be at most 32")
    NC = rows.shape[0]
    sbc = sb // C
    if NC % sbc:
        raise ValueError(f"{NC} chunks do not fill superblocks of {sbc}")
    NSB = NC // sbc
    kernels.check_tensor("rows", rows, rows.dtype, (NC, C * BS), dev)
    _check_plan(rank, woff, rband, sb_off, NSB, sbc, E, dev)
    if dev.type == "cpu":
        return encode_bands_plain(rows, rank, woff, rband, sb_off, K, E, sb,
                                  C, alloc_rows)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    # the kernel writes every base word when K > 0, and of resid only the
    # band rows of this plan
    base = (torch.empty if K else torch.zeros)(
        (NSB, max(K, 1), C, sbc), dtype=_I32, device=dev)
    resid = torch.zeros((alloc_rows, LANES), dtype=_I32, device=dev)
    inv = torch.empty_like(rank)
    kernels.launch("bfp_encode", rows.data_ptr(), int(rows.dtype == _I32),
                   rank.data_ptr(), inv.data_ptr(), woff.data_ptr(),
                   rband.data_ptr(), sb_off.data_ptr(), base.data_ptr(),
                   resid.data_ptr(), NC * C, C, sbc, K, E,
                   kernels.stream(dev))
    return base, resid


def decode_bands(base, resid2d, rank, woff, rband, sb_off, cnt_c, K: int,
                 E: int, sb: int, C: int, wide: bool):
    """K3 wrapper (replaces mgard_tpu/lossless/bfp.py _decode_pallas), both
    modes; emits natural chunk order. Same output as decode_bands_plain."""
    dev = base.device
    if sb % (C * LANES) or not 1 <= E <= 15 or K < 0 or K + E > 32:
        raise ValueError(f"bad geometry sb={sb} C={C} K={K} E={E}")
    NSB = base.shape[0]
    sbc = sb // C
    kernels.check_tensor("base", base, _I32, (NSB, max(K, 1), C, sbc), dev)
    if resid2d.dtype != _I32 or resid2d.ndim != 2 or \
            resid2d.shape[1] != LANES or not resid2d.is_contiguous() or \
            resid2d.device != dev:
        raise ValueError("resid2d: expected contiguous int32 (rows, 128) "
                         f"on {dev}")
    _check_plan(rank, woff, rband, sb_off, NSB, sbc, E, dev)
    kernels.check_tensor("cnt", cnt_c, _I32, (NSB, E), dev)
    if dev.type == "cpu":
        return decode_bands_plain(base, resid2d, rank, woff, rband, sb_off,
                                  cnt_c, K, E, sb, C, wide)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((NSB * sbc, C * BS),
                      dtype=_I32 if wide else torch.int16, device=dev)
    inv = torch.empty_like(rank)
    kernels.launch("bfp_decode", base.data_ptr(), resid2d.data_ptr(),
                   rank.data_ptr(), inv.data_ptr(), woff.data_ptr(),
                   rband.data_ptr(), sb_off.data_ptr(), cnt_c.data_ptr(),
                   out.data_ptr(), int(wide), NSB * sb, C, sbc, K, E,
                   kernels.stream(dev))
    return out


# ----------------------------------------------------------------------
# Device cores
# ----------------------------------------------------------------------
@traced("kernel.bfp_encode")
def encode_core(sym_padded, K: int, E: int, sb: int, exc_cap: int,
                C: int = CHUNK):
    """sym_padded (N,) int32, N % (sb*32) == 0.

    Returns (base (NSB, max(K,1), C, sbc) int32 [sorted order], crl (NC,)
    int32 [chunk residual lengths, natural order], resid2d (alloc_rows, 128)
    int32, exc_ids (exc_cap,) int32, exc_blocks (exc_cap, 32C) int32,
    exc_count)."""
    N = sym_padded.shape[0]
    NB = N // BS
    NC = NB // C
    NSB = NB // sb
    sbc = sb // C
    sym_rows = sym_padded.reshape(NC, C * BS)
    zz_rows = _zigzag(sym_rows)
    cw = _chunk_widths(zz_rows)
    # exception chunks ship verbatim in the side stream; their sorted-stream
    # content is zeroed (crl = 0, zero planes), as in the JAX package
    mask = cw > (K + E)
    exc_count = torch.sum(mask, dtype=_I32)
    exc_ids = masked_indices(mask, exc_cap, NC)
    exc_blocks = sym_rows[exc_ids.clamp(0, NC - 1).long()]
    crl = torch.where(mask, 0, (cw - K).clamp(0, E)).to(_I32)
    zz_rows = torch.where(mask[:, None], 0, zz_rows)
    # narrow payload: with K+E <= 16 every surviving code fits 16 bits
    payload = zz_rows.to(torch.int16) if (K + E) <= 16 else zz_rows
    with span("codec.bfp_plan"):
        rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sbc), E)
        rband, woff, sb_off, _ = _plan_offsets(cnt_c, C)
    alloc_rows = (NSB + 1) * E * (sb // LANES)
    base, resid2d = encode_bands(payload.contiguous(), rank_c, woff, rband,
                                 sb_off, K, E, sb, C, alloc_rows)
    return base, crl, resid2d, exc_ids, exc_blocks, exc_count


@traced("kernel.bfp_decode")
def decode_core(base4d, crl, resid2d, exc_ids, exc_blocks, K: int, E: int,
                sb: int, NB: int, C: int = CHUNK):
    """Inverse of encode_core -> (NB*32,) int32 symbols."""
    NC = NB // C
    NSB = NB // sb
    sbc = sb // C
    with span("codec.bfp_plan"):
        rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sbc), E)
        rband, woff, sb_off, _ = _plan_offsets(cnt_c, C)
    narrow = (K + E) <= 16
    rows = decode_bands(base4d, resid2d, rank_c, woff, rband, sb_off, cnt_c,
                        K, E, sb, C, wide=not narrow)
    zz = rows.to(_I32) & 0xFFFF if narrow else rows
    sym_rows = _unzigzag(zz)
    keep = exc_ids < NC
    sym_rows[exc_ids[keep].long()] = exc_blocks[keep]
    return sym_rows.reshape(NB * BS)


@traced("kernel.bfp_encode")
def encode_core_zz(payload_rows, crl, K: int, E: int, sb: int, C: int,
                   static_cap: bool = False):
    """Prepared-payload encode (hybrid v2 cf stream): payload_rows (NC, 32C)
    int16 u16 zigzag codes, grouped and exception-free; crl (NC,) int32.
    Returns (base, resid2d). static_cap writes the residual planes in the
    static-cap layout (_static_plan), the device layout of the fused flag-2
    front end; resid2d then has exactly NSB*CAP rows."""
    rank_c, _, rband, woff, sb_off, _, alloc_rows = _zz_plan(
        crl, E, sb, C, static_cap)
    return encode_bands(payload_rows, rank_c, woff, rband, sb_off, K, E, sb,
                        C, alloc_rows)


@traced("kernel.bfp_decode")
def decode_core_zz(base4d, crl, resid2d, K: int, E: int, sb: int, NB: int,
                   C: int, static_cap: bool = False):
    """Inverse of encode_core_zz -> (NC, 32C) int16 u16 zigzag rows in
    natural order (the hybrid-v2 inverse consumes them directly)."""
    rank_c, cnt_c, rband, woff, sb_off, _, _ = _zz_plan(crl, E, sb, C,
                                                        static_cap)
    return decode_bands(base4d, resid2d, rank_c, woff, rband, sb_off, cnt_c,
                        K, E, sb, C, wide=False)


# ----------------------------------------------------------------------
# Wire compaction: map between the row-padded band layout of K2/K3 and the
# compact valid-words wire layout, from the sidecar alone: K12/K13
# (csrc/bfp.cu) for a residual tensor on the card, their plain versions
# for one on the CPU.
# ----------------------------------------------------------------------
def _wire_counts(crl, E: int, C: int, sb: int) -> np.ndarray:
    """(NSB, E) host array cnt[s, j] = #(rl > j) over superblock s of the
    residual lengths crl (NC,): each superblock's histogram summed from
    the top, counted where crl lies (a host array, or a tensor: on the card
    one small copy brings the counts over)."""
    t = torch.as_tensor(crl).long()
    NSB = t.shape[0] * C // sb
    keys = t.reshape(NSB, -1) + (E + 1) * torch.arange(
        NSB, device=t.device)[:, None]
    hist = torch.bincount(keys.reshape(-1), minlength=NSB * (E + 1))
    return to_host(hist.reshape(NSB, E + 1)[:, 1:].flip(1).cumsum(1).flip(1))


def _band_geometry(crl, E: int, C: int, sb: int, static_cap: bool = False):
    """Per-(superblock, plane) valid word count cnt, band row count rband,
    global band start row, and total padded rows, from the residual
    lengths crl (_wire_counts). Counts are permutation-invariant, so the
    sidecar alone determines them. static_cap describes the device layout
    of the fused flag-2 front end (_static_plan); the wire bytes are the
    same either way, since compaction strips the padding."""
    cnt = _wire_counts(crl, E, C, sb)
    NSB = cnt.shape[0]
    sbc = sb // C
    if static_cap:
        CAP = E * (sb // LANES)
        rband = np.full_like(cnt, sbc // LANES)
        rows_p = rband * C
        band_start = (np.arange(NSB)[:, None] * CAP
                      + np.cumsum(rows_p, axis=1) - rows_p)
        return cnt, rband, band_start, NSB * CAP
    rband = -(-cnt // LANES)
    rows_p = (rband * C).reshape(-1)
    ends = np.cumsum(rows_p)
    band_start = (ends - rows_p).reshape(NSB, E)
    rows = int(ends[-1]) if ends.size else 0
    return cnt, rband, band_start, rows


def _wire_table(cnt, rband, band_start, C: int) -> np.ndarray:
    """(bands, 4) int64 rows (start row, rband, cnt, wire offset) of K12 /
    K13, one a (superblock, plane) band, in wire order."""
    if C * LANES * int(rband.max(initial=0)) >= 2 ** 31:
        raise ValueError("a BFP band of 2^31 words or more")
    words = C * cnt.reshape(-1)
    return np.stack([band_start.reshape(-1), rband.reshape(-1),
                     cnt.reshape(-1), np.cumsum(words) - words],
                    1).astype(np.int64)


def _wire_index(tab, C: int):
    """Band-buffer word of every wire word, in wire order (plain K12/K13)."""
    row0, rband, cnt, woff = tab.unbind(1)
    n = C * cnt
    band = torch.repeat_interleave(
        torch.arange(tab.shape[0], device=tab.device), n)
    k = torch.arange(int(n.sum()), device=tab.device) - woff[band]
    b = k // cnt[band]
    return (row0[band] + b * rband[band]) * LANES + k - b * cnt[band]


def compact_wire_plain(resid2d, tab, C: int):
    """Plain version of K12: the (words,) int32 wire words of the bands of
    tab (int64, _wire_table) in resid2d's row-padded layout."""
    return resid2d.reshape(-1)[_wire_index(tab, C)]


def expand_wire_plain(wire, tab, C: int, rows: int):
    """Plain version of K13: wire words -> (rows, 128) int32 band buffer,
    zero past each slot's valid words."""
    out = torch.zeros(rows * LANES, dtype=_I32, device=wire.device)
    out[_wire_index(tab, C)] = wire
    return out.reshape(rows, LANES)


def _check_wire(tab_h, C: int, rows: int):
    """The band rows of tab_h fit in rows; returns the wire word count."""
    if tab_h.ndim != 2 or tab_h.shape[1] != 4 or C < 1:
        raise ValueError(f"bad wire table {tab_h.shape}, C={C}")
    end = tab_h[:, 0] + C * tab_h[:, 1]
    if int(end.max(initial=0)) > rows or (tab_h[:, 2]
                                          > LANES * tab_h[:, 1]).any():
        raise ValueError(f"wire table outside {rows} band rows")
    return C * int(tab_h[:, 2].sum())


@traced("kernel.bfp_compact")
def compact_wire(resid2d, tab_h: np.ndarray, C: int):
    """K12 wrapper: the row-padded bands of resid2d (rows, 128) int32 ->
    the (words,) int32 compact wire words of the bands of tab_h (host,
    _wire_table), on resid2d's device. Same output as compact_wire_plain."""
    dev = resid2d.device
    if resid2d.dtype != _I32 or resid2d.ndim != 2 or \
            resid2d.shape[1] != LANES or not resid2d.is_contiguous():
        raise ValueError("resid2d: expected contiguous int32 (rows, 128)")
    words = _check_wire(tab_h, C, resid2d.shape[0])
    tab = to_device(tab_h, dev)
    if dev.type == "cpu":
        return compact_wire_plain(resid2d, tab, C)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty(words, dtype=_I32, device=dev)
    if words:
        kernels.launch("bfp_compact", resid2d.data_ptr(), tab.data_ptr(),
                       out.data_ptr(), tab.shape[0], C, kernels.stream(dev))
    return out


@traced("kernel.bfp_expand")
def expand_wire(wire, tab_h: np.ndarray, C: int, rows: int):
    """K13 wrapper: (words,) int32 wire words -> (rows, 128) int32 band
    buffer on wire's device, every word written (zero past each slot's
    valid words). Same output as expand_wire_plain; a stream with no band
    rows gets one row of zeros (K3's plain version indexes it)."""
    dev = wire.device
    words = _check_wire(tab_h, C, rows)
    kernels.check_tensor("wire", wire, _I32, (words,), dev)
    if not rows:
        return torch.zeros((1, LANES), dtype=_I32, device=dev)
    tab = to_device(tab_h, dev)
    if dev.type == "cpu":
        return expand_wire_plain(wire, tab, C, rows)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((rows, LANES), dtype=_I32, device=dev)
    kernels.launch("bfp_expand", wire.data_ptr(), tab.data_ptr(),
                   out.data_ptr(), tab.shape[0], C, kernels.stream(dev))
    return out


def _count_wire(device) -> None:
    """Count a blob's wire map where it ran: K12/K13 on the card, or their
    plain versions on CPU tensors."""
    count("bfp.wire.host" if torch.device(device).type == "cpu"
          else "bfp.wire.device")


@traced("codec.bfp_blob")
def _blob_parts(n: int, K: int, E: int, sb: int, C: int, crl, base,
                resid2d, exc_cnt: int, static_cap: bool = False) -> list:
    """BFP5 blob as bytesink parts: header, nibble sidecar, base planes and
    the compact residual words. compact_wire maps the residual to the wire
    on its device, and the base planes and the wire words are Fills that
    copy them straight into the final blob."""
    from ..utils.bytesink import device_fill

    cnt, rband, band_start, _ = _band_geometry(crl, E, C, sb, static_cap)
    rl_h = to_host(crl).astype(np.uint8)
    if rl_h.shape[0] % 2:
        rl_h = np.concatenate([rl_h, np.zeros(1, np.uint8)])
    nib = rl_h[0::2] | (rl_h[1::2] << 4)
    words = int(cnt.sum()) * C
    head = struct.pack(_HDR, _MAGIC, n, words, K, E, sb, C, exc_cnt)
    parts = [head, nib]
    _count_wire(resid2d.device)
    if K:
        parts.append(device_fill(base[:, :K].contiguous()))
    if words:
        parts.append(device_fill(compact_wire(
            resid2d, _wire_table(cnt, rband, band_start, C), C)))
    return parts


def serialize_prepared_parts(n: int, K: int, E: int, sb: int, C: int, crl,
                             base, resid2d, static_cap: bool = False) -> list:
    """encode_core_zz result as bytesink parts (exception-free blob);
    static_cap names the layout of resid2d, the bytes do not depend on it."""
    return _blob_parts(n, K, E, sb, C, crl, base, resid2d, 0, static_cap)


@traced("codec.bfp_parse")
def _parse(data: bytes, offset: int):
    """Header and sidecar of a BFP5 blob: (geometry, residual lengths (NC,)
    int32, offset of the body: base planes, then residual words)."""
    magic, n, resid_words, K, E, sb, C, cnt = struct.unpack_from(
        _HDR, data, offset)
    if magic != _MAGIC:
        raise ValueError("bad BFP blob")
    p = offset + struct.calcsize(_HDR)
    geom = dict(n=n, resid_words=resid_words, K=K, E=E, sb=sb, C=C, cnt=cnt)
    if n == 0:
        return geom, None, p
    if not (1 <= E <= 15 and K + E <= 32 and sb % LANES == 0 and C >= 1
            and sb % (C * LANES) == 0):
        raise ValueError(f"BFP blob geometry K={K} E={E} sb={sb} C={C}")
    NC = _pad_to(n, sb) // BS // C
    nnib = (NC + 1) // 2
    nib = np.frombuffer(data, np.uint8, nnib, p)
    p += nnib
    rl = np.empty(nnib * 2, np.int32)
    rl[0::2] = nib & 0xF
    rl[1::2] = nib >> 4
    rl = rl[:NC]
    if rl.max(initial=0) > E:
        raise ValueError(f"BFP sidecar holds residual lengths above E={E}")
    return geom, rl, p


def _body(data: bytes, p: int, geom: dict, rl: np.ndarray, device,
          static_cap: bool = False):
    """The sidecar rl and the body of a blob at p as int32 tensors on
    device: base planes (NSB, max(K,1), C, sbc), residual lengths (NC,),
    row-padded residual bands (rows, 128), and the offset past the body.
    Both word ranges go to the device in one copy straight from the blob,
    and expand_wire expands the bands there. static_cap expands into the
    static-cap layout."""
    n, K, E, sb, C = (geom[k] for k in ("n", "K", "E", "sb", "C"))
    NB = _pad_to(n, sb) // BS
    NSB, sbc = NB // sb, sb // C
    nbase, words = K * NB, geom["resid_words"]
    end = p + 4 * (nbase + words)
    crl = to_device(rl, device)
    _count_wire(device)
    cnt, rband, band_start, rows = _band_geometry(crl, E, C, sb, static_cap)
    if int(cnt.sum()) * C != words:
        raise ValueError(f"BFP resid stream has {words} words, sidecar "
                         f"implies {int(cnt.sum()) * C}")
    body = to_device(_blob_tensor(np.frombuffer(data, np.uint8, end - p, p)),
                     device).view(_I32)
    base = (body[:nbase].view(NSB, K, C, sbc) if K else
            torch.zeros((NSB, 1, C, sbc), dtype=_I32, device=device))
    resid = expand_wire(body[nbase:], _wire_table(cnt, rband, band_start, C),
                        C, rows)
    return base, crl, resid, end


def deserialize_prepared(data: bytes, offset: int = 0, device="cpu",
                         static_cap: bool = False):
    """Parse an exception-free BFP5 blob into tensors for decode_core_zz.
    Returns (base, crl, resid2d, (n, K, E, sb, C), consumed). static_cap
    expands the residual words into the static-cap layout."""
    geom, rl, p = _parse(data, offset)
    if geom["cnt"]:
        raise ValueError(
            "prepared-payload decode requires an exception-free blob")
    if geom["n"] == 0:
        raise ValueError("empty prepared-payload blob")
    base, crl, rbuf, p = _body(data, p, geom, rl, device, static_cap)
    return (base, crl, rbuf,
            tuple(geom[k] for k in ("n", "K", "E", "sb", "C")), p - offset)


# ----------------------------------------------------------------------
# Parameter selection (sticky per stream size)
# ----------------------------------------------------------------------
# K (and the exception bucket) per stream key, chosen once from the first
# stream's width histogram: later streams of the same size reuse it.
_K_CACHE: dict = {}


def choose_K(hist_cw: np.ndarray, E: int, C: int = CHUNK) -> int:
    """Pick the base plane count minimizing expected words/block:
    cost(K) = K + E_cw[clip(cw-K,0,E)] + P_cw(cw>K+E) * (1 + 32C)/C."""
    totc = int(hist_cw.sum())
    if totc == 0:
        return 0
    w = np.arange(33)
    best_k, best_c = 0, 1e18
    for K in range(0, 33 - E):
        rlv = np.clip(w - K, 0, E)
        p_exc = hist_cw[K + E + 1 :].sum() / totc
        c = K + float((hist_cw * rlv).sum()) / totc + p_exc * (1 + C * BS) / C
        if c < best_c:
            best_k, best_c = K, c
    return best_k


def _width_hist(sym, C: int = CHUNK) -> np.ndarray:
    """Chunk-max width histogram (33,)."""
    cw = _chunk_widths(_zigzag(sym.reshape(-1, C * BS)))
    return to_host(torch.bincount(cw, minlength=33))


def _choose_sb(n: int, device) -> int:
    """The large superblock on the kernel path (CUDA), the small one
    elsewhere: the CPU picks what the JAX package picks on the CPU."""
    return (SB_BLOCKS if n >= SB_BLOCKS * BS and device.type == "cuda"
            else SB_BLOCKS_SMALL)


def _pad_to(n: int, sb: int) -> int:
    q = sb * BS
    return (n + q - 1) // q * q


def _exc_bucket(count: int, NB: int) -> int:
    cap = max(256, 1 << max(int(count) - 1, 1).bit_length())
    return min(cap, NB)


def encode_device(symbols, config=None):
    """Device phase: launch the pack and return opaque state for
    serialize_device_parts(). K is sticky per (padded size, E, C)."""
    n = int(symbols.shape[0])
    if n == 0:
        return ("empty",)
    dev = symbols.device
    sb = int(getattr(config, "bfp_sb_blocks", 0) or 0) or _choose_sb(n, dev)
    if sb % LANES or sb < LANES:
        raise ValueError(f"bfp_sb_blocks must be a multiple of {LANES}, "
                         f"got {sb}")
    if n < sb * BS:
        sb = _choose_sb(n, dev)  # stream smaller than one tuned superblock
    npad = _pad_to(n, sb)
    sym = symbols.to(_I32).reshape(-1)
    if npad != n:
        sym = torch.cat([sym, torch.zeros(npad - n, dtype=_I32, device=dev)])
    NB = npad // BS
    E = int(getattr(config, "bfp_resid_planes", 0) or E_DEFAULT)
    if not 1 <= E <= 15:
        # residual lengths are 4-bit nibbles on the wire
        raise ValueError(f"bfp_resid_planes must be in [1, 15], got {E}")
    C = int(getattr(config, "bfp_chunk", 0) or CHUNK)
    if C < 1 or C > 255 or (sb % C):
        raise ValueError(f"bfp_chunk must divide sb, got {C}")
    # bands need whole 128-word rows: halve C until sb % (C*128) == 0
    while C > 1 and sb % (C * LANES):
        C //= 2
    K = int(getattr(config, "bfp_base_planes", 0) or 0)
    key = (npad, E, C)
    if not K:
        if key in _K_CACHE:
            K = _K_CACHE[key][0]
            count("bfp.k_cache.hit")
        else:
            with span("codec.choose_K"):
                hcw = _width_hist(sym, C)
                K = choose_K(hcw, E, C)
            _K_CACHE[key] = (K, _exc_bucket(int(hcw[K + E + 1 :].sum()),
                                            NB // C))
            count("bfp.k_cache.miss")
    exc_cap = _K_CACHE.get(key, (K, max(256, (NB // C) >> 8)))[1]
    out = encode_core(sym, K, E, sb, exc_cap, C)
    return ("bfp", n, K, E, sb, exc_cap, sym, out, C)


def serialize_device_parts(state) -> list:
    if state[0] == "empty":
        return [struct.pack(_HDR, _MAGIC, 0, 0, 0, 0, SB_BLOCKS_SMALL, CHUNK,
                            0)]
    _, n, K, E, sb, exc_cap, sym, out, C = state
    base, rl, resid2d, exc_ids, exc_blocks, exc_count = out
    cnt = int(to_host(exc_count))
    NB = _pad_to(n, sb) // BS
    if cnt > exc_cap:
        # re-run once at the exact count's bucket
        exc_cap = _exc_bucket(cnt, NB // C)
        _K_CACHE[(_pad_to(n, sb), E, C)] = (K, exc_cap)
        out = encode_core(sym, K, E, sb, exc_cap, C)
        base, rl, resid2d, exc_ids, exc_blocks, exc_count = out
        cnt = int(to_host(exc_count))
    ids_h = to_host(exc_ids[:cnt]).astype("<u4")
    blk_h = to_host(exc_blocks[:cnt]).astype("<i4")
    return (_blob_parts(n, K, E, sb, C, rl, base, resid2d, cnt)
            + [ids_h, blk_h])


def encode(symbols, config=None) -> bytes:
    from ..utils.bytesink import join

    return join(serialize_device_parts(encode_device(symbols, config)))


def decode(data: bytes, offset: int = 0, device="cpu"):
    """BFP5 blob -> ((n,) int32 symbols on device, bytes consumed)."""
    geom, rl, p = _parse(data, offset)
    n, K, E, sb, C, cnt = (geom[k] for k in ("n", "K", "E", "sb", "C", "cnt"))
    if n == 0:
        return torch.zeros(0, dtype=_I32, device=device), p - offset
    NB = _pad_to(n, sb) // BS
    NC = NB // C
    base, crl, rbuf, p = _body(data, p, geom, rl, device)
    ids = np.frombuffer(data, "<u4", cnt, p).astype(np.int32)
    p += 4 * cnt
    blocks = np.frombuffer(data, "<i4", cnt * C * BS, p).reshape(cnt, C * BS)
    p += 4 * cnt * C * BS
    if cnt and (ids.min() < 0 or ids.max() >= NC):
        raise ValueError("BFP exception id out of range")
    sym = decode_core(
        base, crl, rbuf, to_device(ids, device),
        to_device(blocks.copy(), device), K, E, sb, NB, C)
    return sym[:n], p - offset
