"""BFX — block fixed-width bitplane codec, blob format "BFX2" (port of
``mgard_tpu/lossless/bfx.py``; the two packages write identical bytes for
identical symbols and geometry).

Symbols are zigzag-coded and cut into blocks of 32. A block of width w
(the bit length of its largest code, 32 for codes >= 2^31) stores w plane
words: bit k of plane word j is bit j of symbol k. Within a superblock of
sb blocks the blocks appear in bit-reversed index order, each block's
words consecutive; each superblock starts at an ``align``-word offset and
the gap words are zero. The bit-reversed order is what the JAX package's
log-depth merge tree produces, and is part of the format.

  header: <4sQQII magic, n, total_words, sb_blocks, align_words>
  widths: NB bytes (one per 32-symbol block, natural block order)
  words:  total_words * u32 little-endian

Two CUDA kernels do the packing on the GPU: ``encode_core`` (K5,
csrc/bfx.cu) and ``decode_core`` (K6). Their plain versions beside them
are the JAX package's merge and split trees (rolls and per-row selects,
batched over superblocks); each wrapper takes the plain version for a CPU
tensor and launches its kernel for a CUDA tensor.

Geometry follows the JAX rule with "on the TPU" read as "on CUDA": a CUDA
stream of at least SB_BLOCKS*32 symbols is written with sb=4096 and
align=1024, every other stream with sb=256 and align=1, and an explicit
``Config.bfx_sb_blocks`` wins. Decode reads any (sb, align) on either
device.

Packed words are int32 bit patterns: torch lacks shifts on uint32, so
logical right shifts mask the sign bits.
"""

from __future__ import annotations

import struct
import warnings

import numpy as np
import torch

from .. import kernels
from ..ops.hybrid import bit_length
from ..utils.bytesink import device_fill, join
from ..utils.trace import to_device, to_host

BS = 32  # symbols per block
SB_BLOCKS = 4096  # blocks per superblock on the kernel path (CUDA)
SB_BLOCKS_SMALL = 256  # superblock everywhere else (smaller padding)
ALIGN = 1024  # word alignment of superblock offsets on the kernel path

_MAGIC = b"BFX2"
_HDR = "<4sQQII"

_I32 = torch.int32
_BF_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_BF_SHIFTS = (16, 8, 4, 2, 1)


def _zigzag(d):
    """int32 symbols -> int32 bit patterns of the u32 zigzag code."""
    d = d.to(_I32)
    return (d << 1) ^ (d >> 31)


def _unzigzag(z):
    """int32 bit patterns of u32 zigzag codes -> int32 symbols. The halving
    shift is logical (mask off the sign-extended bit)."""
    z = z.to(_I32)
    return ((z >> 1) & 0x7FFFFFFF) ^ -(z & 1)


def _bit_transpose32(zt):
    """32x32 bit-matrix transpose along axis 0 of int32 zt (32, ...): row k
    holds symbol k of every block; on return row j holds plane j (bit k of
    output row j == bit j of input row k). Self-inverse 5-step butterfly;
    each mask clears the bits an arithmetic shift drags in."""
    for s, m in zip(_BF_SHIFTS, _BF_MASKS):
        g = 32 // (2 * s)
        x = zt.reshape((g, 2, s) + tuple(zt.shape[1:]))
        a = x[:, 0]
        b = x[:, 1]
        t = ((a >> s) ^ b) & m
        a = a ^ (t << s)
        b = b ^ t
        zt = torch.stack([a, b], dim=1).reshape(zt.shape)
    return zt


def _widths_from_zt(zt):
    """Per-block bit widths (...,) int32 from zigzag rows zt (32, ...): the
    bit length of the u32 max (a negative int32 has bit 31 set: 32)."""
    w = bit_length(zt.amax(0))
    return torch.where(zt.amin(0) < 0, torch.full_like(w, 32), w)


# ----------------------------------------------------------------------
# Merge / split trees, batched over superblocks. Streams-as-rows: x (B, S,
# cap) int32, lens (B, S, 1) int32; stream i pairs with stream i + S/2.
# ----------------------------------------------------------------------
def _merge_level(x, lens):
    """One merge level: (B, S, cap) -> (B, S/2, 2*cap). The right stream
    moves past the left one by a bit-decomposed sequence of rolls with a
    per-row select; what wraps around is its own zero padding."""
    half = x.shape[1] // 2
    llen, rlen = lens[:, :half], lens[:, half:]
    left = torch.cat([x[:, :half], torch.zeros_like(x[:, :half])], dim=2)
    right = torch.cat([x[:, half:], torch.zeros_like(x[:, half:])], dim=2)
    for b in range(right.shape[2].bit_length() - 1):
        sh = 1 << b
        right = torch.where((llen & sh) > 0, torch.roll(right, sh, 2), right)
    return left | right, llen + rlen


def _split_level(x, llen, rlen):
    """Inverse of _merge_level: (B, S, cap) -> (B, 2S, cap/2)."""
    caph = x.shape[2] // 2
    right = x
    for b in range(x.shape[2].bit_length() - 1):
        sh = 1 << b
        right = torch.where((llen & sh) > 0, torch.roll(right, -sh, 2), right)
    col = torch.arange(caph, device=x.device)
    left = torch.where(col < llen, x[:, :, :caph], 0)
    right = torch.where(col < rlen, right[:, :, :caph], 0)
    return torch.cat([left, right], dim=1)


def _lens_chain(w_rows):
    """Per-level stream lengths for the split tree, bottom-up: w_rows (B,
    S, 1) -> [(B, S, 1), (B, S/2, 1), ..., (B, 1, 1)], halves pairing."""
    chain = [w_rows]
    while chain[-1].shape[1] > 1:
        cur = chain[-1]
        half = cur.shape[1] // 2
        chain.append(cur[:, :half] + cur[:, half:])
    return chain


def _pack_superblock(zt, w):
    """zt (32, B, S) zigzag rows + widths (B, S) -> condensed streams (B,
    S*32): the blocks' plane words in merge order, zero past the length."""
    x = _bit_transpose32(zt).permute(1, 2, 0)  # stream b = planes of block b
    lens = w.unsqueeze(2)
    while x.shape[1] > 1:
        x, lens = _merge_level(x, lens)
    return x[:, 0]


def _unpack_superblock(streams, w):
    """Inverse of _pack_superblock: streams (B, S*32) -> zt (32, B, S).
    The words above each block's width read as zero: the split levels mask
    them, and at S = 1 (no split level) the last mask does. (The JAX
    package's split tree lacks that mask, so at sb=1 it decodes a narrow
    block with the next superblock's words as its high planes.)"""
    chain = _lens_chain(w.unsqueeze(2))
    x = streams.unsqueeze(1)
    for level in range(len(chain) - 2, -1, -1):
        lens = chain[level]
        S = x.shape[1]
        x = _split_level(x, lens[:, :S], lens[:, S:])
    x = torch.where(torch.arange(BS, device=x.device) < w.unsqueeze(2), x, 0)
    return _bit_transpose32(x.permute(2, 0, 1).contiguous())


def _sb_offsets(w2, align: int):
    """Superblock lengths (NSB,) and aligned word offsets (NSB+1,) (the
    last entry is the total), int32, from widths w2 (NSB, sb)."""
    lens = torch.sum(w2, 1, dtype=_I32)
    alens = (lens + (align - 1)) // align * align
    offs = torch.zeros(w2.shape[0] + 1, dtype=_I32, device=w2.device)
    offs[1:] = torch.cumsum(alens, 0, dtype=_I32)
    return lens, offs


def _out_words(NSB: int, sb: int, align: int) -> int:
    """Word capacity that holds any stream of NSB superblocks."""
    return NSB * ((sb * BS + align - 1) // align * align)


# ----------------------------------------------------------------------
# K5 / K6: plain versions and kernel wrappers
# ----------------------------------------------------------------------
def encode_core_plain(sym, sb: int, align: int):
    """Plain version of K5: padded int32 symbols (N,) -> (words (cap,)
    int32 [the stream in its first ``total`` words, the rest zero], widths
    (NB,) uint8, total 0-dim int32)."""
    N = sym.shape[0]
    NB = N // BS
    NSB = NB // sb
    cap = sb * BS
    zt = _zigzag(sym).reshape(NSB, sb, BS).permute(2, 0, 1)  # (32, NSB, sb)
    w = _widths_from_zt(zt)  # (NSB, sb)
    streams = _pack_superblock(zt, w)  # (NSB, cap)
    lens, offs = _sb_offsets(w, align)
    col = torch.arange(cap, device=sym.device)
    keep = col < lens[:, None]
    idx = offs[:-1, None].long() + col
    out = torch.zeros(_out_words(NSB, sb, align), dtype=_I32, device=sym.device)
    out[idx[keep]] = streams[keep]
    return out, w.reshape(NB).to(torch.uint8), offs[-1]


def decode_core_plain(words, widths, sb: int, align: int):
    """Plain version of K6: the stream's words + widths (NB,) uint8 ->
    symbols (NB*32,) int32. The split tree reads a whole superblock's
    capacity past each offset, so the words are padded by one capacity."""
    NB = widths.shape[0]
    NSB = NB // sb
    cap = sb * BS
    w = widths.to(_I32).reshape(NSB, sb)
    _lens, offs = _sb_offsets(w, align)
    flat = torch.cat([words, torch.zeros(cap, dtype=_I32, device=words.device)])
    idx = offs[:-1, None].long() + torch.arange(cap, device=words.device)
    zt = _unpack_superblock(flat[idx], w)  # (32, NSB, sb)
    return _unzigzag(zt.permute(1, 2, 0).reshape(NB * BS))


def _check_geometry(N: int, sb: int, align: int) -> None:
    if sb < 1 or sb & (sb - 1):
        raise ValueError(f"BFX superblock must be a power of two, got {sb}")
    if align < 1 or N % (sb * BS):
        raise ValueError(f"BFX geometry: {N} symbols, sb={sb}, align={align}")
    if _out_words(N // (sb * BS), sb, align) >= 1 << 31:
        raise ValueError(f"BFX stream of {N} symbols exceeds int32 offsets")


def _scratch(NSB: int, dev):
    """K5's and K6's scratch (the entry point zeroes it): the ticket
    counter, then one look-back status word a superblock."""
    return torch.empty(NSB + 1, dtype=torch.int64, device=dev)


def encode_core(sym, sb: int, align: int):
    """K5 wrapper (replaces mgard_tpu/lossless/bfx.py _encode_pallas and
    the widths/offsets glue of its encode_core): same outputs as
    encode_core_plain, except that on CUDA the words past ``total`` are
    left unwritten. On CUDA ``sym`` must be 16-byte aligned (a misaligned
    view raises)."""
    dev = sym.device
    N = sym.shape[0]
    _check_geometry(N, sb, align)
    kernels.check_tensor("sym", sym, _I32, (N,), dev)
    if dev.type == "cpu":
        return encode_core_plain(sym, sb, align)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    NB = N // BS
    NSB = NB // sb
    widths = torch.empty(NB, dtype=torch.uint8, device=dev)
    offs = torch.empty(NSB + 1, dtype=_I32, device=dev)
    out = torch.empty(_out_words(NSB, sb, align), dtype=_I32, device=dev)
    kernels.launch("bfx_encode", sym.data_ptr(), widths.data_ptr(),
                   _scratch(NSB, dev).data_ptr(), offs.data_ptr(),
                   out.data_ptr(), NB, sb, align, kernels.stream(dev))
    return out, widths, offs[-1]


def decode_core(words, widths, sb: int, align: int):
    """K6 wrapper (replaces mgard_tpu/lossless/bfx.py _decode_pallas): the
    stream's words + widths (NB,) uint8 -> (NB*32,) int32 symbols. Same
    output as decode_core_plain. The caller guarantees what ``decode``
    checks: every width is at most 32 and ``words`` holds the total the
    widths imply (the kernel reads nothing past it). On CUDA ``words``
    must be 16-byte aligned (a misaligned view raises)."""
    dev = widths.device
    NB = widths.shape[0]
    _check_geometry(NB * BS, sb, align)
    kernels.check_tensor("widths", widths, torch.uint8, (NB,), dev)
    kernels.check_tensor("words", words, _I32, (words.shape[0],), dev)
    if dev.type == "cpu":
        return decode_core_plain(words, widths, sb, align)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    sym = torch.empty(NB * BS, dtype=_I32, device=dev)
    kernels.launch("bfx_decode", words.data_ptr(), widths.data_ptr(),
                   _scratch(NB // sb, dev).data_ptr(), sym.data_ptr(), NB,
                   sb, align, kernels.stream(dev))
    return sym


# ----------------------------------------------------------------------
# Bytes-level API (registry backend)
# ----------------------------------------------------------------------
def _choose_sb(n: int, device, override=None) -> int:
    if override and n >= override * BS:
        return int(override)
    return (SB_BLOCKS if n >= SB_BLOCKS * BS and device.type == "cuda"
            else SB_BLOCKS_SMALL)


def _pad_to(n: int, sb: int) -> int:
    q = sb * BS
    return (n + q - 1) // q * q


def encode_device(symbols, sb_blocks=None):
    """Device phase of encode(): launch the pack with no host
    synchronization; returns an opaque state for serialize_device_parts()."""
    n = int(symbols.shape[0])
    if n == 0:
        return ("empty", n)
    dev = symbols.device
    sb = _choose_sb(n, dev, sb_blocks)
    npad = _pad_to(n, sb)
    sym = symbols.to(_I32).reshape(-1)
    if npad != n:
        sym = torch.cat([sym, torch.zeros(npad - n, dtype=_I32, device=dev)])
    elif dev.type == "cuda" and sym.data_ptr() % 16:  # K5: 16-byte aligned
        sym = sym.clone()
    # small streams keep tight (unaligned) superblock offsets: the 1024-word
    # alignment would dominate their size
    align = ALIGN if dev.type == "cuda" and sb >= SB_BLOCKS else 1
    words, widths, total = encode_core(sym.contiguous(), sb, align)
    return ("bfx", n, sb, align, words, widths, total)


def serialize_device_parts(state) -> list:
    """Host phase of encode(): the blob as bytesink parts. Copies only the
    NB width bytes and the ``total`` wire words to the host, the words
    straight into the blob (no staging array)."""
    if state[0] == "empty":
        return [struct.pack(_HDR, _MAGIC, 0, 0, SB_BLOCKS_SMALL, 0)]
    _, n, sb, align, words, widths, total = state
    total_i = int(to_host(total))
    head = struct.pack(_HDR, _MAGIC, n, total_i, sb, align)

    return [head, to_host(widths), device_fill(words[:total_i])]


def encode(symbols, config=None) -> bytes:
    sb = getattr(config, "bfx_sb_blocks", None) if config is not None else None
    return join(serialize_device_parts(encode_device(symbols, sb)))


def _blob_tensor(arr):
    """A tensor over a read-only view of the blob, without a copy: decode
    only reads it (a CUDA decode copies it to the card, the plain split
    tree into new tensors)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(arr)


def decode(data: bytes, offset: int = 0, device="cpu"):
    """BFX2 blob -> ((n,) int32 symbols on device, bytes consumed)."""
    magic, n, total, sb, align = struct.unpack_from(_HDR, data, offset)
    p = offset + struct.calcsize(_HDR)
    if magic != _MAGIC:
        raise ValueError("bad BFX blob")
    if n == 0:
        return torch.zeros(0, dtype=_I32, device=device), p - offset
    if sb < 1 or sb & (sb - 1) or align < 1:
        raise ValueError(f"BFX blob geometry sb={sb} align={align}")
    nb = _pad_to(n, sb) // BS
    widths = np.frombuffer(data, np.uint8, nb, p)
    p += nb
    words = np.frombuffer(data, "<u4", total, p)
    p += 4 * total
    lens = widths.reshape(-1, sb).sum(1, dtype=np.int64)
    if widths.max() > 32 or int(((lens + align - 1) // align * align).sum()) \
            != total:
        raise ValueError("BFX widths disagree with the word count")
    sym = decode_core(to_device(_blob_tensor(words.view(np.int32)), device),
                       to_device(_blob_tensor(widths), device), sb, align)
    return sym[:n], p - offset
