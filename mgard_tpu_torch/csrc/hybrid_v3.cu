// K10 hybrid_pack_v3 and K11 hybrid_unpack_v3: the fused transform+pack
// front end of hybrid flag-2 ("v3") streams.
//
// Replaces the TPU kernels mgard_tpu/ops/hybrid.py::local_transform_pack_v3
// (body _fwd_kernel_v3_body, plan _v3_plan_kernel) and ::unpack_inverse_v3
// (body _inv_kernel_v3_body). Plain versions: transform_pack_v3 and
// unpack_inverse_v3_plain in mgard_tpu_torch/ops/hybrid.py, which the
// kernels match bit for bit (float operations as in tile8.cuh; the library
// is built with -fmad=false).
//
// The scheme: each (8, 128, Z) tile of the field is one BFP superblock of
// 1024 chunks, a chunk being one (x, y) row of Z z-grouped zigzag codes
// (C = Z/32 blocks of 32), chunks in tile-major order. Chunks are stably
// sorted by residual length crl = clip(cw - K, 0, E), descending; block b of
// the chunk with sorted column c' stores base plane j at base[s, j, b, c']
// and residual plane K+j at resid[s, j, b, c'] (the static-cap layout: no
// offset depends on the data, so no scan across superblocks is needed).
//
// What bounds them on the H100: memory. K10 must read 4 bytes per element
// and write (K+E)/8; K11 the reverse. The stencil is ~20 flops per element.
//
// Design of K10: the TPU kernel holds a whole tile (2-4 MB) in VMEM; a
// thread block has 227 KB. A chunk's sorted column depends on the widths of
// all 1024 chunks of its tile, and a width on the chunk's whole transformed
// row, so one entry point runs a chain of three kernels:
//   1. widths: the K1 tile walk (tile8.cuh), one block per 8x8 (x, y)
//      column; writes the remainder, the u16 codes into a tile-major
//      scratch, and one raw width per chunk, 32 where a code left 16 bits;
//   2. rank: one block per superblock; a raw 32 anywhere poisons all 1024
//      widths to 32 (the caller falls back), then the counting sort of crl
//      in shared memory, bit-identical to lossless/bfp.py _sort_plan;
//   3. pack: one warp per (chunk, block); plane j of the 32x32 bit
//      transpose is __ballot_sync of bit j, stored at column rank[chunk].
// The u16 scratch is written and reread (2 bytes per element each way)
// instead of running the transform twice (4 more bytes read per element):
// the same bytes, half the stencil work. Every base and residual word is
// stored exactly once, also above a chunk's width, where the planes are
// zero by construction; nothing is zero-filled and no block touches
// another's words. The TPU body's bf16 0/1 matmuls (the z permutation, the
// sort, the prefix count) are index arithmetic, a scatter and warp votes
// here.
//
// Design of K11: one kernel. A block owns an 8x8 (x, y) column: it
// recomputes its superblock's rank from the 1024 crl values in shared
// memory, gathers and bit-merges its 64 chunks into a u16 row buffer in
// dynamic shared memory (64 * Z * 2 bytes, 128 KB at Z = 1024), then walks
// the z tiles as K4 does, reading codes from that buffer. The buffer leaves
// room for two blocks on an SM at Z = 512 (K4 has five), so a block has 512
// threads, twice K4's, to keep the scattered word gathers and the
// barrier-heavy stencil fed.
#include "common.cuh"
#include "tile8.cuh"

namespace {

constexpr int UNT = 512;     // threads per block of K11
constexpr int SBC = 1024;    // chunks per superblock (an (8, 128) tile)
constexpr int MAX_B = 16;    // residual-length buckets: E + 1 <= 16

struct RankScratch {
  int wtot[MAX_B][32];  // per bucket, per group of 32 chunks: count, then
                        // exclusive prefix over the groups
  int tot[MAX_B];       // per bucket: count over the superblock
};

// Stable descending counting sort of crl[0..1024) (values in [0, E]):
// rank[i] = #(crl > crl[i]) + #(j < i with crl[j] == crl[i]). blockDim.x is
// a multiple of 32; the caller synchronizes before (crl filled) and after.
__device__ void sb_rank(const int* crl, int E, int* rank, RankScratch& rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int g = warp; g < SBC / 32; g += nw) {
    const int r = crl[g * 32 + lane];
    for (int k = 0; k <= E; ++k) {
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, r == k);
      if (lane == 0) rs.wtot[k][g] = __popc(bal);
    }
  }
  __syncthreads();
  for (int k = warp; k <= E; k += nw) {
    const int x = rs.wtot[k][lane];
    int incl = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    rs.wtot[k][lane] = incl - x;
    if (lane == 31) rs.tot[k] = incl;
  }
  __syncthreads();
  for (int g = warp; g < SBC / 32; g += nw) {
    const int r = crl[g * 32 + lane];
    const unsigned same = __match_any_sync(0xFFFFFFFFu, r);
    int before = rs.wtot[r][g] + __popc(same & ((1u << lane) - 1u));
    for (int k = r + 1; k <= E; ++k) before += rs.tot[k];
    rank[g * 32 + lane] = before;
  }
}

__device__ __forceinline__ int clip_crl(int w, int K, int E) {
  return min(max(w - K, 0), E);
}

// Superblock (tile) of the 8x8 column at (x0, y0) and the tile-major chunk
// of its row (xi, yi).
__device__ __forceinline__ int tile_of(int x0, int y0, int Y) {
  return (x0 >> 3) * (Y >> 7) + (y0 >> 7);
}
__device__ __forceinline__ int chunk_of(int y0, int xi, int yi) {
  return xi * 128 + (y0 & 127) + yi;
}

// K10 pass 1.
__global__ void __launch_bounds__(NT)
v3_widths_kernel(const float* __restrict__ v, float inv_q,
                 uint16_t* __restrict__ pay, int* __restrict__ cw,
                 float* __restrict__ rem, int X, int Y, int Z, int nl) {
  __shared__ float vs[TILE];
  __shared__ float ws[TILE];
  __shared__ unsigned wmax[64];
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8;
  const int k = __popc(chain_mask(nl));
  const int RY = Y / 8 * k, RZ = Z / 8 * k;
  const size_t row0 = (size_t)tile_of(x0, y0, Y) * SBC;
  if (threadIdx.x < 64) wmax[threadIdx.x] = 0u;

  for (int z0 = 0; z0 < Z; z0 += ZT) {
    __syncthreads();
    for (int e = threadIdx.x; e < TILE; e += NT) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, zi = e % ZT;
      vs[e] = v[((size_t)(x0 + xi) * Y + (y0 + yi)) * Z + z0 + zi];
    }
    __syncthreads();
    decompose_tile(vs, ws, nl);
    for (int o = threadIdx.x; o < TILE; o += NT) {
      int xi, yi, c, jj;
      payload_slot(o, xi, yi, c, jj);
      const float val = vs[(xi * 8 + yi) * ZT + 8 * jj + c];
      const int jz = (z0 >> 3) + jj;
      unsigned zz = 0u;
      if (in_chain(nl, xi) && in_chain(nl, yi) && in_chain(nl, c)) {
        rem[rem_index(nl, k, RY, RZ, x0, y0, xi, yi, jz, c)] = val;
      } else {
        zz = quantize_zigzag(val, inv_q);
      }
      pay[(row0 + chunk_of(y0, xi, yi)) * Z + c * g + jz] =
          (uint16_t)(zz & 0xFFFFu);
      // a code over 16 bits marks its chunk with the raw width 32
      const unsigned w =
          zz > 0xFFFFu ? 32u : zz ? 32u - (unsigned)__clz((int)zz) : 0u;
      unsigned* slot = &wmax[xi * 8 + yi];
      if (w > *slot) atomicMax(slot, w);
    }
  }
  __syncthreads();
  if (threadIdx.x < 64)
    cw[row0 + chunk_of(y0, threadIdx.x >> 3, threadIdx.x & 7)] =
        (int)wmax[threadIdx.x];
}

// K10 pass 2: raw widths -> widths (overflow poisons the tile) and rank.
__global__ void __launch_bounds__(NT)
v3_rank_kernel(int* __restrict__ cw, int* __restrict__ rank, int K, int E) {
  __shared__ int crl[SBC];
  __shared__ RankScratch rs;
  int* cw_s = cw + (size_t)blockIdx.x * SBC;
  int over = 0;
  for (int i = threadIdx.x; i < SBC; i += NT) {
    crl[i] = cw_s[i];
    over |= crl[i] > 16;
  }
  over = __syncthreads_or(over);
  for (int i = threadIdx.x; i < SBC; i += NT) {
    const int w = over ? 32 : crl[i];
    cw_s[i] = w;
    crl[i] = clip_crl(w, K, E);
  }
  __syncthreads();
  sb_rank(crl, E, rank + (size_t)blockIdx.x * SBC, rs);
}

// K10 pass 3: one warp per 32-symbol block (slot b of chunk c).
__global__ void __launch_bounds__(NT)
v3_pack_kernel(const uint16_t* __restrict__ pay, const int* __restrict__ rank,
               unsigned* __restrict__ base, unsigned* __restrict__ resid,
               long long NB, int C, int K, int E) {
  const long long blk = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= NB) return;  // whole warps: NB blocks of 32 lanes
  const long long c = blk / C;
  const int b = (int)(blk % C);
  const long long s = c / SBC;
  const int cs = rank[c];
  const unsigned zz = pay[c * 32 * C + b * 32 + lane];
  unsigned mine = 0u;
  for (int j = 0; j < K + E; ++j) {
    const unsigned word = __ballot_sync(0xFFFFFFFFu, (zz >> j) & 1u);
    if (lane == j) mine = word;
  }
  if (lane < K)
    base[((s * K + lane) * C + b) * SBC + cs] = mine;
  else if (lane < K + E)
    resid[((s * E + (lane - K)) * C + b) * SBC + cs] = mine;
}

// K11.
__global__ void __launch_bounds__(UNT)
v3_unpack_kernel(const unsigned* __restrict__ base,
                 const int* __restrict__ crl_g,
                 const unsigned* __restrict__ resid,
                 const float* __restrict__ rem, float q,
                 float* __restrict__ out, int X, int Y, int Z, int nl, int K,
                 int E) {
  extern __shared__ uint16_t pay_s[];  // [64][Z] grouped zigzag codes
  __shared__ float xs[TILE];
  __shared__ float ys[TILE];
  __shared__ int crl[SBC];
  __shared__ int rank[SBC];
  __shared__ RankScratch rs;
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8, C = Z / 32;
  const int k = __popc(chain_mask(nl));
  const int RY = Y / 8 * k, RZ = Z / 8 * k;
  const size_t s = (size_t)tile_of(x0, y0, Y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Kp = K > 0 ? K : 1;

  for (int i = threadIdx.x; i < SBC; i += UNT) crl[i] = crl_g[s * SBC + i];
  __syncthreads();
  sb_rank(crl, E, rank, rs);
  __syncthreads();
  for (int p = warp; p < 64 * C; p += UNT / 32) {
    const int row = p / C, b = p % C;
    const int c = chunk_of(y0, row >> 3, row & 7);
    const int cs = rank[c];
    unsigned mine = 0u;
    if (lane < K)
      mine = base[((s * Kp + lane) * C + b) * SBC + cs];
    else if (lane < K + E && crl[c] > lane - K)
      // plane K+j holds a word of this chunk only where crl > j
      mine = resid[((s * E + (lane - K)) * C + b) * SBC + cs];
    unsigned sym = 0u;
    for (int j = 0; j < K + E; ++j) {
      const unsigned word = __shfl_sync(0xFFFFFFFFu, mine, j);
      sym |= ((word >> lane) & 1u) << j;
    }
    pay_s[row * Z + b * 32 + lane] = (uint16_t)sym;
  }

  for (int z0 = 0; z0 < Z; z0 += ZT) {
    __syncthreads();
    for (int o = threadIdx.x; o < TILE; o += UNT) {
      int xi, yi, c, jj;
      payload_slot(o, xi, yi, c, jj);
      const int jz = (z0 >> 3) + jj;
      float val;
      if (in_chain(nl, xi) && in_chain(nl, yi) && in_chain(nl, c))
        val = rem[rem_index(nl, k, RY, RZ, x0, y0, xi, yi, jz, c)];
      else
        val = unzigzag_dequantize(pay_s[(xi * 8 + yi) * Z + c * g + jz], q);
      xs[(xi * 8 + yi) * ZT + 8 * jj + c] = val;
    }
    __syncthreads();
    recompose_tile<UNT>(xs, ys, nl);
    for (int e = threadIdx.x; e < TILE; e += UNT) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, zi = e % ZT;
      out[((size_t)(x0 + xi) * Y + (y0 + yi)) * Z + z0 + zi] = xs[e];
    }
  }
}

}  // namespace

// Shapes are checked by the Python wrapper: X a multiple of 8, Y of 128, Z a
// multiple of 128 in [128, 1024], nl in 1..3, 1 <= K, 1 <= E <= 15,
// K + E <= 16. pay ((X*Y, Z) u16) and rank ((X*Y,) i32) are scratch; base
// (NSB, K, C, 1024), resid (NSB, E, C, 1024), cw (NSB, 1024), rem: outputs.
MGARD_EXPORT int hybrid_pack_v3(const void* v, float inv_q, void* pay,
                                void* rank, void* base, void* resid, void* cw,
                                void* rem, int X, int Y, int Z, int nl, int K,
                                int E, void* stream) {
  if (K < 1 || E < 1 || E + 1 > MAX_B || K + E > 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int NSB = (X / 8) * (Y / 128), C = Z / 32;
  const long long NB = (long long)NSB * SBC * C;
  v3_widths_kernel<<<dim3(Y / 8, X / 8), NT, 0, st>>>(
      (const float*)v, inv_q, (uint16_t*)pay, (int*)cw, (float*)rem, X, Y, Z,
      nl);
  int rc = mgard_launch_status();
  if (rc) return rc;
  v3_rank_kernel<<<NSB, NT, 0, st>>>((int*)cw, (int*)rank, K, E);
  rc = mgard_launch_status();
  if (rc) return rc;
  v3_pack_kernel<<<(unsigned)((NB * 32 + NT - 1) / NT), NT, 0, st>>>(
      (const uint16_t*)pay, (const int*)rank, (unsigned*)base,
      (unsigned*)resid, NB, C, K, E);
  return mgard_launch_status();
}

// The mirror: base (NSB, max(K,1), C, 1024), crl (NSB, 1024), resid (NSB, E,
// C, 1024), rem -> out (X, Y, Z) float32. K >= 0.
MGARD_EXPORT int hybrid_unpack_v3(const void* base, const void* crl,
                                  const void* resid, const void* rem, float q,
                                  void* out, int X, int Y, int Z, int nl,
                                  int K, int E, void* stream) {
  if (K < 0 || E < 1 || E + 1 > MAX_B || K + E > 16)
    return (int)cudaErrorInvalidValue;
  const int smem = 64 * Z * (int)sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      v3_unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  v3_unpack_kernel<<<dim3(Y / 8, X / 8), UNT, smem, (cudaStream_t)stream>>>(
      (const unsigned*)base, (const int*)crl, (const unsigned*)resid,
      (const float*)rem, q, (float*)out, X, Y, Z, nl, K, E);
  return mgard_launch_status();
}
