// P1-P3: the Hopper counterparts of the three TPU layout probes.
//
// Each TPU probe asked one layout question before a BFP kernel was written
// (scripts/probe_dynwin.py, scripts/probe_strided_dma.py,
// scripts/probe_u16.py). None is on a path of the package. These kernels
// compute what the probes compute and put the same three questions to the
// card, each in the variants the answer chooses between. Plain versions:
// dynwin_place_plain, relayout_plain and u16_planes_plain in
// mgard_tpu_torch/probes.py, which every variant matches bit for bit.
//
// What bounds them on the H100: memory, all three. They move and permute
// words and bits; P3's butterfly is ~100 lane operations per 128 bytes.
//
// P1 probe_dynwin (replaces the pallas_call of scripts/probe_dynwin.py):
//   planes (NSB, E, W, 128) u32 with rows past each plane's row count zero;
//   out rows sb_off[i] + woff[i][j] + w = planes[i][j][w]. The TPU kernel
//   ORs W-row windows into VMEM and DMAs a whole capacity, later grid steps
//   overwriting the spill; blocks on this card run in no order, so both
//   variants write exactly tot[i] rows of superblock i, in tiles of TILE
//   rows, one block per (superblock, tile):
//     variant 0 "or":    zero a shared tile, OR in every window that meets
//                        it, plane after plane, then store the tile;
//     variant 1 "owner": output row r copies the one plane that owns it
//                        (the last j with woff[j] <= r): no shared memory,
//                        no read-modify-write.
// P2 probe_relayout (scripts/probe_strided_dma.py, both pallas_calls):
//   (sbc, 128) -> (4 sbc, 32), out = mul * x. In linear memory the two
//   shapes are one layout (the TPU needed four strided DMAs because VMEM is
//   tiled), so the question left is the staging:
//     variant 0 "direct":  a streaming copy: each thread issues U = 4
//                          independent 16-byte loads (NT int4 apart, so
//                          each is a 512-byte warp row) before any store,
//                          a block for every NT * U int4, the ragged end
//                          masked (see the note on P2 below);
//     variant 1 "cpasync": 16-byte cp.async into shared memory, then one
//                          warp per 32-word row (conflict-free);
//     variant 2 "row32":   cp.async, then one THREAD per row at a pitch of
//                          32 words (every lane on one bank);
//     variant 3 "row33":   the same at a pitch of 33 words (4-byte
//                          cp.async, conflict-free).
//   The forward probe doubles (mul = 2), the reverse copies (mul = 1).
//   The direct copy is bound by bytes: 268 MB moved at the production
//   shape (2^18 rows of 128 words), 0.0801 ms at 3.35 TB/s. On one NVIDIA
//   H100 80GB HBM3 at 700.00 W (scripts/h100_relayout_direct.py, medians
//   of single launches, alternating) it takes 0.0941 ms each way, as do
//   PyTorch's reshape * 2 (0.0940) and reshape.clone (0.0938), about 85%
//   of the bytes' rate; one int4 a thread took 0.0937. Streaming hints
//   (__ldcs/__stcs) measured 0.0942-0.0952, one wave of blocks striding
//   over the rows 0.0992: the copy is at the card's rate either way, and
//   a full grid lets the block scheduler even out the end.
// P3 probe_u16_planes (scripts/probe_u16.py): (S, 32) u16 -> (16, S) plane
//   words, bit k of word (j, b) = bit j of symbol k of block b:
//     variant 0 "ballot":    one warp per block, 16 __ballot_sync, as K2
//                            does with 32-bit codes; words staged in shared
//                            memory so the stores coalesce;
//     variant 1 "butterfly": one thread per block, 16 registers each
//                            holding symbol k (low half) and k + 16 (high
//                            half), the probe's 4-step butterfly with the
//                            masks doubled: register j ends as word j.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int LANES = 128;  // words per row of P1
constexpr int TILE = 32;    // rows per tile of P1

// ---------------------------------------------------------------- P1
__global__ void __launch_bounds__(NT)
dynwin_or_kernel(const unsigned* __restrict__ planes,
                 const int* __restrict__ woff, const int* __restrict__ sb_off,
                 const int* __restrict__ tot, unsigned* __restrict__ out,
                 int E, int W) {
  __shared__ unsigned tile[TILE * LANES];
  const int i = blockIdx.x;
  const int r0 = blockIdx.y * TILE;
  const int rows = min(TILE, tot[i] - r0);
  if (rows <= 0) return;
  for (int t = threadIdx.x; t < TILE * LANES; t += NT) tile[t] = 0u;
  __syncthreads();
  for (int j = 0; j < E; ++j) {
    // window j covers superblock rows [o, o + W); its part inside the tile
    const int o = woff[i * E + j];
    const int lo = max(o, r0), hi = min(o + W, r0 + TILE);
    const unsigned* src = planes + ((long long)(i * E + j) * W) * LANES;
    for (int t = threadIdx.x; t < (hi - lo) * LANES; t += NT) {
      const int r = lo + t / LANES, l = t % LANES;
      tile[(r - r0) * LANES + l] |= src[(r - o) * LANES + l];
    }
    __syncthreads();  // the next window may touch the same rows
  }
  unsigned* dst = out + ((long long)sb_off[i] + r0) * LANES;
  for (int t = threadIdx.x; t < rows * LANES; t += NT) dst[t] = tile[t];
}

__global__ void __launch_bounds__(NT)
dynwin_owner_kernel(const unsigned* __restrict__ planes,
                    const int* __restrict__ woff,
                    const int* __restrict__ sb_off,
                    const int* __restrict__ tot, unsigned* __restrict__ out,
                    int E, int W) {
  const int i = blockIdx.x;
  const int r0 = blockIdx.y * TILE;
  const int rows = min(TILE, tot[i] - r0);
  if (rows <= 0) return;
  const uint4* src = reinterpret_cast<const uint4*>(planes);
  uint4* dst = reinterpret_cast<uint4*>(out);
  // one warp per row: 32 lanes x 16 bytes = the row's 128 words
  const int lane = threadIdx.x & 31;
  for (int r = r0 + (threadIdx.x >> 5); r < r0 + rows; r += NT / 32) {
    int j = 0;
    for (int k = 1; k < E; ++k)
      if (woff[i * E + k] <= r) j = k;
    const long long from =
        ((long long)(i * E + j) * W + (r - woff[i * E + j])) * (LANES / 4);
    dst[((long long)sb_off[i] + r) * (LANES / 4) + lane] = src[from + lane];
  }
}

// ---------------------------------------------------------------- P2
constexpr int U = 4;  // int4 a thread keeps in flight (direct variant)

__global__ void __launch_bounds__(NT)
relayout_direct_kernel(const int4* __restrict__ x, int4* __restrict__ out,
                       long long n4, int mul) {
  const long long t0 = (long long)blockIdx.x * NT * U + threadIdx.x;
  int4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (t0 + u * NT < n4) v[u] = x[t0 + u * NT];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (t0 + u * NT < n4) {
      v[u].x *= mul; v[u].y *= mul; v[u].z *= mul; v[u].w *= mul;
      out[t0 + u * NT] = v[u];
    }
  }
}

// A block stages NT rows of 32 words (NT * 128 bytes) in shared memory.
template <int PITCH, bool PER_THREAD>
__global__ void __launch_bounds__(NT)
relayout_staged_kernel(const int* __restrict__ x, int* __restrict__ out,
                       long long nrows, int mul) {
  __shared__ __align__(16) int tile[NT * PITCH];
  const long long row0 = (long long)blockIdx.x * NT;
  const int rows = (int)min((long long)NT, nrows - row0);
  const int* src = x + row0 * 32;
  if (PITCH == 32) {
    for (int t = threadIdx.x; t < rows * 8; t += NT)
      __pipeline_memcpy_async(&tile[t * 4], src + t * 4, 16);
  } else {
    for (int t = threadIdx.x; t < rows * 32; t += NT)
      __pipeline_memcpy_async(&tile[(t >> 5) * PITCH + (t & 31)], src + t, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  int* dst = out + row0 * 32;
  if (!PER_THREAD) {
    // one warp per row: lane l reads word l of the row, no bank conflict
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += NT / 32)
      dst[r * 32 + lane] = tile[r * PITCH + lane] * mul;
    return;
  }
  // one thread per row: at PITCH 32 the 32 lanes of a warp read one bank
  if ((int)threadIdx.x < rows)
    for (int k = 0; k < 32; ++k) tile[threadIdx.x * PITCH + k] *= mul;
  __syncthreads();
  for (int t = threadIdx.x; t < rows * 32; t += NT)
    dst[t] = tile[(t >> 5) * PITCH + (t & 31)];
}

// ---------------------------------------------------------------- P3
__global__ void __launch_bounds__(NT)
u16_ballot_kernel(const uint16_t* __restrict__ zz, unsigned* __restrict__ out,
                  long long S) {
  // a block packs 32 consecutive 32-symbol blocks; warp w takes w, w+8, ...
  __shared__ unsigned words[16][33];  // 33: lanes 0-15 on 16 banks
  const long long b0 = (long long)blockIdx.x * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < 32; b += NT / 32) {
    const unsigned v = b0 + b < S ? zz[(b0 + b) * 32 + lane] : 0u;
    unsigned mine = 0u;
    for (int j = 0; j < 16; ++j) {
      const unsigned word = __ballot_sync(0xFFFFFFFFu, (v >> j) & 1u);
      if (lane == j) mine = word;
    }
    if (lane < 16) words[lane][b] = mine;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 16 * 32; t += NT) {
    const int j = t >> 5, b = t & 31;
    if (b0 + b < S) out[j * S + b0 + b] = words[j][b];
  }
}

__global__ void __launch_bounds__(NT)
u16_butterfly_kernel(const uint4* __restrict__ zz, unsigned* __restrict__ out,
                     long long S) {
  const long long b = (long long)blockIdx.x * NT + threadIdx.x;
  if (b >= S) return;
  // 64 bytes: words 0-7 hold symbols 0-15, words 8-15 symbols 16-31
  unsigned w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = zz[b * 4 + q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  // r[k] = symbol k | symbol k+16 << 16
  unsigned r[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const unsigned lo = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
    const unsigned hi = (w[8 + (k >> 1)] >> (16 * (k & 1))) & 0xFFFFu;
    r[k] = lo | (hi << 16);
  }
  // the 16x16 bit-matrix transpose of both halves at once
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int s = 8 >> step;
    const unsigned m = step == 0 ? 0x00FF00FFu : step == 1 ? 0x0F0F0F0Fu
                     : step == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k & s) continue;  // k is the "a" row, k + s the "b" row
      const unsigned t = ((r[k] >> s) ^ r[k + s]) & m;
      r[k] ^= t << s;
      r[k + s] ^= t;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j * S + b] = r[j];
}

}  // namespace

// planes: (NSB, E, W, 128) u32; woff: (NSB, E); sb_off, tot: (NSB,); out:
// (sum(tot) + E*W, 128), of which rows [sb_off[i], sb_off[i] + tot[i]) are
// written here. variant 0 = or, 1 = owner.
MGARD_EXPORT int probe_dynwin(const void* planes, const void* woff,
                              const void* sb_off, const void* tot, void* out,
                              int NSB, int E, int W, int variant,
                              void* stream) {
  if (NSB <= 0 || E <= 0 || W <= 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)NSB, (unsigned)((E * W + TILE - 1) / TILE));
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0)
    dynwin_or_kernel<<<grid, NT, 0, st>>>(
        (const unsigned*)planes, (const int*)woff, (const int*)sb_off,
        (const int*)tot, (unsigned*)out, E, W);
  else
    dynwin_owner_kernel<<<grid, NT, 0, st>>>(
        (const unsigned*)planes, (const int*)woff, (const int*)sb_off,
        (const int*)tot, (unsigned*)out, E, W);
  return mgard_launch_status();
}

// x, out: nrows rows of 32 int32 words in linear memory (the (sbc, 128)
// and the (4 sbc, 32) view are the same bytes); out = mul * x. variant 0 =
// direct, 1 = cpasync, 2 = row32, 3 = row33.
MGARD_EXPORT int probe_relayout(const void* x, void* out, long long nrows,
                                int mul, int variant, void* stream) {
  if (nrows <= 0 || variant < 0 || variant > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((nrows + NT - 1) / NT);
  const int* xi = (const int*)x;
  int* oi = (int*)out;
  if (variant == 0) {
    const long long n4 = nrows * 8;
    relayout_direct_kernel<<<(unsigned)((n4 + NT * U - 1) / (NT * U)), NT, 0,
                             st>>>((const int4*)x, (int4*)out, n4, mul);
  } else if (variant == 1) {
    relayout_staged_kernel<32, false><<<tiles, NT, 0, st>>>(xi, oi, nrows,
                                                            mul);
  } else if (variant == 2) {
    relayout_staged_kernel<32, true><<<tiles, NT, 0, st>>>(xi, oi, nrows,
                                                           mul);
  } else {
    relayout_staged_kernel<33, true><<<tiles, NT, 0, st>>>(xi, oi, nrows,
                                                           mul);
  }
  return mgard_launch_status();
}

// zz: (S, 32) u16; out: (16, S) u32. variant 0 = ballot, 1 = butterfly.
MGARD_EXPORT int probe_u16_planes(const void* zz, void* out, long long S,
                                  int variant, void* stream) {
  if (S <= 0 || variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0)
    u16_ballot_kernel<<<(unsigned)((S + 31) / 32), NT, 0, st>>>(
        (const uint16_t*)zz, (unsigned*)out, S);
  else
    u16_butterfly_kernel<<<(unsigned)((S + NT - 1) / NT), NT, 0, st>>>(
        (const uint4*)zz, (unsigned*)out, S);
  return mgard_launch_status();
}
