// K2 bfp_encode and K3 bfp_decode: the banded BFP5 bit packer and unpacker.
//
// Replaces the TPU kernels mgard_tpu/lossless/bfp.py::_encode_pallas (body
// _enc_kernel) and ::_decode_pallas (body _dec_kernel). Plain versions:
// encode_bands_plain and decode_bands_plain in
// mgard_tpu_torch/lossless/bfp.py, which the kernels match word for word.
//
// What bounds them on the H100: memory. K2 reads 2 or 4 bytes per symbol and
// writes (K+E)/32 of a word; K3 the reverse. There is no arithmetic to speak
// of: one __ballot_sync per bit plane (K2) and one __shfl_sync per plane
// (K3) do the 32x32 bit transpose of a block inside one warp.
//
// Design: one warp per 32-symbol block (slot b of chunk c). Lane k holds
// symbol k, so plane j is __ballot_sync(~0, bit j of the symbol) and lane j
// keeps it. The chunk's sorted column c' = rank[c] (a permutation within
// its superblock) places every plane word: base plane j < K at
// base[sb, j, b, c'], residual plane K+j at word c' of band
// (sb_off + woff[sb, j] + b*rband[sb, j]) * 128. The TPU kernel OR-merged
// full-band windows that spill into the next band and the next superblock,
// which is deterministic only on its in-order grid; CUDA blocks run
// concurrently. By the sorted-prefix invariant every word past cnt_j is
// zero, so each band word c' < rband*128 is written exactly once, by exactly
// one warp, with no OR and no spill. The width sort is this permutation of
// destinations (both streams take rank), and decode emits natural order, so
// neither side needs a row gather.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps per block
constexpr int LANES = 128;

template <typename T>
__global__ void __launch_bounds__(NT)
bfp_encode_kernel(const T* __restrict__ rows, const int* __restrict__ rank,
                  const int* __restrict__ woff, const int* __restrict__ rband,
                  const int* __restrict__ sb_off, unsigned* __restrict__ base,
                  unsigned* __restrict__ resid, long long NB, int C, int sbc,
                  int K, int E) {
  const long long blk = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= NB) return;  // whole warps: NB blocks of 32 lanes
  const long long c = blk / C;
  const int b = (int)(blk % C);
  const long long s = c / sbc;
  const int cs = rank[c];
  const unsigned zz = (unsigned)rows[c * 32 * C + b * 32 + lane];
  unsigned mine = 0u;
  for (int j = 0; j < K + E; ++j) {
    const unsigned word = __ballot_sync(0xFFFFFFFFu, (zz >> j) & 1u);
    if (lane == j) mine = word;
  }
  const int Kp = K > 0 ? K : 1;
  if (lane < K) {
    base[((s * Kp + lane) * C + b) * sbc + cs] = mine;
  } else if (lane < K + E) {
    const int j = lane - K;
    const int rb = rband[s * E + j];
    if (cs < rb * LANES)
      resid[((long long)sb_off[s] + woff[s * E + j] + (long long)b * rb) *
                LANES + cs] = mine;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
bfp_decode_kernel(const unsigned* __restrict__ base,
                  const unsigned* __restrict__ resid,
                  const int* __restrict__ rank, const int* __restrict__ woff,
                  const int* __restrict__ rband,
                  const int* __restrict__ sb_off, const int* __restrict__ cnt,
                  T* __restrict__ out, long long NB, int C, int sbc, int K,
                  int E) {
  const long long blk = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= NB) return;
  const long long c = blk / C;
  const int b = (int)(blk % C);
  const long long s = c / sbc;
  const int cs = rank[c];
  const int Kp = K > 0 ? K : 1;
  unsigned mine = 0u;
  if (lane < K) {
    mine = base[((s * Kp + lane) * C + b) * sbc + cs];
  } else if (lane < K + E) {
    const int j = lane - K;
    // columns at or past cnt_j hold no plane-j word of this superblock
    if (cs < cnt[s * E + j])
      mine = resid[((long long)sb_off[s] + woff[s * E + j] +
                    (long long)b * rband[s * E + j]) * LANES + cs];
  }
  unsigned sym = 0u;
  for (int j = 0; j < K + E; ++j) {
    const unsigned word = __shfl_sync(0xFFFFFFFFu, mine, j);
    sym |= ((word >> lane) & 1u) << j;
  }
  out[c * 32 * C + b * 32 + lane] = (T)sym;
}

inline dim3 grid_for(long long NB) {
  return dim3((unsigned)((NB * 32 + NT - 1) / NT));
}

}  // namespace

// rows: (NB/C, 32*C) zigzag symbols in natural chunk order, u16 (wide = 0)
// or u32 (wide = 1); rank: (NB/C,) sorted column of each chunk within its
// superblock; woff, rband: (NSB, E); sb_off: (NSB,); base: (NSB, max(K,1),
// C, sbc); resid: the zero-filled band buffer. K + E <= 32.
MGARD_EXPORT int bfp_encode(const void* rows, int wide, const void* rank,
                            const void* woff, const void* rband,
                            const void* sb_off, void* base, void* resid,
                            long long NB, int C, int sbc, int K, int E,
                            void* stream) {
  if (K + E > 32 || NB <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    bfp_encode_kernel<uint32_t><<<grid_for(NB), NT, 0, st>>>(
        (const uint32_t*)rows, (const int*)rank, (const int*)woff,
        (const int*)rband, (const int*)sb_off, (unsigned*)base,
        (unsigned*)resid, NB, C, sbc, K, E);
  else
    bfp_encode_kernel<uint16_t><<<grid_for(NB), NT, 0, st>>>(
        (const uint16_t*)rows, (const int*)rank, (const int*)woff,
        (const int*)rband, (const int*)sb_off, (unsigned*)base,
        (unsigned*)resid, NB, C, sbc, K, E);
  return mgard_launch_status();
}

// The mirror of bfp_encode; cnt: (NSB, E) valid words per plane. Writes
// natural-order zigzag rows, u16 (wide = 0) or u32 (wide = 1).
MGARD_EXPORT int bfp_decode(const void* base, const void* resid,
                            const void* rank, const void* woff,
                            const void* rband, const void* sb_off,
                            const void* cnt, void* out, int wide, long long NB,
                            int C, int sbc, int K, int E, void* stream) {
  if (K + E > 32 || NB <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    bfp_decode_kernel<uint32_t><<<grid_for(NB), NT, 0, st>>>(
        (const unsigned*)base, (const unsigned*)resid, (const int*)rank,
        (const int*)woff, (const int*)rband, (const int*)sb_off,
        (const int*)cnt, (uint32_t*)out, NB, C, sbc, K, E);
  else
    bfp_decode_kernel<uint16_t><<<grid_for(NB), NT, 0, st>>>(
        (const unsigned*)base, (const unsigned*)resid, (const int*)rank,
        (const int*)woff, (const int*)rband, (const int*)sb_off,
        (const int*)cnt, (uint16_t*)out, NB, C, sbc, K, E);
  return mgard_launch_status();
}
