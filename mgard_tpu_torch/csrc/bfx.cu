// K5 bfx_encode and K6 bfx_decode: the BFX2 block bitplane packer and
// unpacker.
//
// Replaces the TPU kernels mgard_tpu/lossless/bfx.py::_encode_pallas (body
// _encode_kernel) and ::_decode_pallas (body _decode_kernel), together with
// the width and offset glue of encode_core/decode_core. Plain versions:
// encode_core_plain and decode_core_plain in
// mgard_tpu_torch/lossless/bfx.py (the JAX package's merge and split
// trees), which the kernels match word for word.
//
// The format fixes where every word goes: a block of width w (bit length of
// its largest zigzag code) stores w plane words, bit k of plane word j being
// bit j of symbol k; within a superblock of sb blocks the blocks follow in
// bit-reversed index order (what the TPU's log-depth merge tree produces),
// each block's words consecutive; superblock s starts at offs[s], its
// length rounded up to `align` words, and the gap words are zero.
//
// What bounds them on the H100: memory. K5 reads the int32 symbols twice
// (widths, then planes) and writes w/32 of a word per symbol; K6 the
// reverse. The merge tree's log-depth shifting is replaced by its closed
// form: an exclusive scan of the widths in bit-reversed order gives every
// block's word offset, after which each block is independent.
//
// Design: (1) one warp per block ORs its 32 zigzag codes (bit length of the
// OR = bit length of the max) into a width byte; (2) one thread block per
// superblock scans the widths in bit-reversed order into per-block offsets
// and the superblock length; (3) one thread block scans the aligned
// superblock lengths into offsets; (4) one warp per block writes plane j as
// __ballot_sync of bit j (the reference's BPEncoderRegisterBallot idea), and
// the last block of each superblock zeroes the alignment gap. Every output
// word is written exactly once, so the TPU kernel's in-order overwrite of
// the previous superblock's padding (which needs a sequential grid) is
// gone. K6 runs (2) and (3) on the stored widths, then each warp loads its
// block's w words and rebuilds lane k's symbol with w __shfl_sync.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps per block
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int bitrev(int k, int bits) {
  return bits ? (int)(__brev((unsigned)k) >> (32 - bits)) : 0;
}

// Exclusive prefix of v over the thread block (NT threads, all of which
// call it); *total receives the block's sum. warp_tot: NT/32 ints of shared
// memory, reusable after the call.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
  for (int q = 0; q < NT / 32; ++q) {
    const int t = warp_tot[q];
    if (q < warp) before += t;
    tot += t;
  }
  __syncthreads();
  *total = tot;
  return before + x - v;
}

__global__ void __launch_bounds__(NT)
bfx_widths_kernel(const int* __restrict__ sym, uint8_t* __restrict__ widths,
                  long long NB) {
  const long long blk = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  if (blk >= NB) return;  // whole warps: NB blocks of 32 lanes
  const int s = sym[blk * 32 + (threadIdx.x & 31)];
  const unsigned zz = ((unsigned)s << 1) ^ (unsigned)(s >> 31);
  const unsigned all = __reduce_or_sync(FULL, zz);
  if ((threadIdx.x & 31) == 0) widths[blk] = (uint8_t)(32 - __clz((int)all));
}

// One thread block per superblock: boff[b] = words of the blocks emitted
// before block b (bit-reversed order); slen[s] = the superblock's words.
__global__ void __launch_bounds__(NT)
bfx_sb_scan_kernel(const uint8_t* __restrict__ widths, int* __restrict__ boff,
                   int* __restrict__ slen, int sb, int bits) {
  __shared__ int warp_tot[NT / 32];
  const long long base = (long long)blockIdx.x * sb;
  int carry = 0;
  for (int k0 = 0; k0 < sb; k0 += NT) {
    const int k = k0 + threadIdx.x;  // emission position
    const int i = k < sb ? bitrev(k, bits) : 0;
    const int w = k < sb ? (int)widths[base + i] : 0;
    int tot;
    const int ex = block_exclusive_scan(w, warp_tot, &tot);
    if (k < sb) boff[base + i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) slen[blockIdx.x] = carry;
}

// One thread block: offs[0] = 0, offs[s+1] = offs[s] + slen[s] rounded up
// to align (offs[NSB] is the stream's word count).
__global__ void __launch_bounds__(NT)
bfx_offsets_kernel(const int* __restrict__ slen, int* __restrict__ offs,
                   int NSB, int align) {
  __shared__ int warp_tot[NT / 32];
  int carry = 0;
  for (int s0 = 0; s0 < NSB; s0 += NT) {
    const int s = s0 + threadIdx.x;
    const int a = s < NSB ? (slen[s] + align - 1) / align * align : 0;
    int tot;
    const int ex = block_exclusive_scan(a, warp_tot, &tot);
    if (s < NSB) offs[s + 1] = carry + ex + a;
    carry += tot;
  }
  if (threadIdx.x == 0) offs[0] = 0;
}

__global__ void __launch_bounds__(NT)
bfx_pack_kernel(const int* __restrict__ sym,
                const uint8_t* __restrict__ widths,
                const int* __restrict__ boff, const int* __restrict__ slen,
                const int* __restrict__ offs, unsigned* __restrict__ out,
                long long NB, int sb) {
  const long long blk = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= NB) return;
  const long long s = blk / sb;
  const int w = widths[blk];  // warp-uniform
  const int x = sym[blk * 32 + lane];
  const unsigned zz = ((unsigned)x << 1) ^ (unsigned)(x >> 31);
  unsigned mine = 0u;
  for (int j = 0; j < w; ++j) {
    const unsigned word = __ballot_sync(FULL, (zz >> j) & 1u);
    if (lane == j) mine = word;
  }
  if (lane < w) out[(long long)offs[s] + boff[blk] + lane] = mine;
  if (blk % sb == sb - 1) {  // the alignment gap after this superblock
    for (long long o = (long long)offs[s] + slen[s] + lane; o < offs[s + 1];
         o += 32)
      out[o] = 0u;
  }
}

__global__ void __launch_bounds__(NT)
bfx_unpack_kernel(const unsigned* __restrict__ words,
                  const uint8_t* __restrict__ widths,
                  const int* __restrict__ boff, const int* __restrict__ offs,
                  int* __restrict__ sym, long long NB, int sb) {
  const long long blk = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= NB) return;
  const int w = widths[blk];  // warp-uniform, <= 32 (checked by the caller)
  const unsigned mine =
      lane < w ? words[(long long)offs[blk / sb] + boff[blk] + lane] : 0u;
  unsigned zz = 0u;
  for (int j = 0; j < w; ++j) {
    const unsigned word = __shfl_sync(FULL, mine, j);
    zz |= ((word >> lane) & 1u) << j;
  }
  sym[blk * 32 + lane] = (int)(zz >> 1) ^ -(int)(zz & 1u);
}

inline dim3 warp_grid(long long NB) {
  return dim3((unsigned)((NB * 32 + NT - 1) / NT));
}

inline int log2_exact(int sb) {
  int bits = 0;
  while ((1 << bits) < sb) ++bits;
  return (1 << bits) == sb ? bits : -1;
}

// (2) and (3), shared by both directions.
int scan_offsets(const void* widths, void* boff, void* slen, void* offs,
                 int NSB, int sb, int bits, int align, cudaStream_t st) {
  bfx_sb_scan_kernel<<<NSB, NT, 0, st>>>((const uint8_t*)widths, (int*)boff,
                                         (int*)slen, sb, bits);
  if (int rc = mgard_launch_status()) return rc;
  bfx_offsets_kernel<<<1, NT, 0, st>>>((const int*)slen, (int*)offs, NSB,
                                       align);
  return mgard_launch_status();
}

}  // namespace

// sym: (NB*32,) int32; widths: (NB,) u8 out; boff: (NB,) int32 scratch;
// slen: (NSB,) int32 scratch; offs: (NSB+1,) int32 out (offs[NSB] = total
// words); out: the word buffer (at least offs[NSB] words). sb a power of
// two dividing NB; align >= 1. Words past offs[NSB] are left as they were.
MGARD_EXPORT int bfx_encode(const void* sym, void* widths, void* boff,
                            void* slen, void* offs, void* out, long long NB,
                            int sb, int align, void* stream) {
  const int bits = log2_exact(sb);
  if (bits < 0 || NB <= 0 || NB % sb || align < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int NSB = (int)(NB / sb);
  bfx_widths_kernel<<<warp_grid(NB), NT, 0, st>>>((const int*)sym,
                                                  (uint8_t*)widths, NB);
  if (int rc = mgard_launch_status()) return rc;
  if (int rc = scan_offsets(widths, boff, slen, offs, NSB, sb, bits, align, st))
    return rc;
  bfx_pack_kernel<<<warp_grid(NB), NT, 0, st>>>(
      (const int*)sym, (const uint8_t*)widths, (const int*)boff,
      (const int*)slen, (const int*)offs, (unsigned*)out, NB, sb);
  return mgard_launch_status();
}

// words: the stream's offs[NSB] words (no slack); widths: (NB,) u8, each
// <= 32; boff, slen, offs: scratch as for bfx_encode; sym: (NB*32,) int32.
MGARD_EXPORT int bfx_decode(const void* words, const void* widths, void* boff,
                            void* slen, void* offs, void* sym, long long NB,
                            int sb, int align, void* stream) {
  const int bits = log2_exact(sb);
  if (bits < 0 || NB <= 0 || NB % sb || align < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int NSB = (int)(NB / sb);
  if (int rc = scan_offsets(widths, boff, slen, offs, NSB, sb, bits, align, st))
    return rc;
  bfx_unpack_kernel<<<warp_grid(NB), NT, 0, st>>>(
      (const unsigned*)words, (const uint8_t*)widths, (const int*)boff,
      (const int*)offs, (int*)sym, NB, sb);
  return mgard_launch_status();
}
