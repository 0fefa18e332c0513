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
//   out rows sb_off[i] + woff[i][j] + w = planes[i][j][w], then E*W zero
//   capacity rows. The TPU kernel ORs W-row windows into VMEM and DMAs a
//   whole capacity, later grid steps overwriting the spill; blocks on this
//   card run in no order, so every variant writes each output row once. A
//   superblock's row count tot[i] is sb_off[i+1] - sb_off[i], the last
//   one's total_rows - sb_off[NSB-1]; each variant derives it and zeroes the
//   tail itself, so a call is one launch. Four variants:
//     variant 0 "or":    one block per (superblock, tile of TILE rows):
//                        zero a shared tile, OR in every window that meets
//                        it, plane after plane, then store the tile;
//     variant 1 "owner": the same tiles; output row r copies the one plane
//                        that owns it (the last j with woff[j] <= r), a
//                        warp a row, found by a search through woff;
//     variant 2 "run":   plane (i, j) holds n = woff[i][j+1] - woff[i][j]
//                        content rows (the last plane tot[i] - woff), one
//                        contiguous run at both ends, so P1 is NSB*E
//                        independent copies of 512 B to W*512 B: one block
//                        a run, each thread keeping U = 4 independent
//                        16-byte loads in flight before its stores (as P2's
//                        direct copy); no search, no shared memory. The E
//                        blocks of one more grid row zero W tail rows each;
//     variant 3 "bulk":  the same runs by the Tensor Memory Accelerator:
//                        one thread a block copies its run global -> shared
//                        in pieces of at most PIECE bytes (cp.async.bulk,
//                        completed on an mbarrier, two pieces in flight)
//                        and shared -> global (cp.async.bulk bulk_group),
//                        2 * PIECE bytes of dynamic shared memory.
//   Bound by bytes: at the production shape (256, 8, 128), seed 0, the
//   content rows are read once and written once and the tail written, about
//   139 MB, 0.0415 ms at 3.35 TB/s. On one NVIDIA H100 80GB HBM3 at
//   700.00 W (scripts/h100_dynwin.py, CUDA-graph replays, medians) bulk
//   takes 0.0497-0.0504 ms, run 0.0508-0.0518, owner 0.0515-0.0517 (about
//   82% of the byte rate), or 0.1006-0.1010, and a clone of the content
//   bytes 0.0586-0.0592; the parent design's owner kernel alone took
//   0.0517, so its 0.15 ms readings were mostly the wrapper's host work
//   (a host-to-device copy, torch.diff and the tail fill), which is now
//   gone. bulk is the wrapper's default; run with eight int4 a thread in
//   flight matched it (0.0499), with four it stays as written.
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
constexpr int TILE = 32;    // rows per tile of P1 (or, owner)
constexpr int U = 4;        // int4 a thread keeps in flight (run, P2 direct)
constexpr int NT_BULK = 128;
constexpr int PIECE = 32 * 1024;  // bytes a bulk copy moves at a time

// ---------------------------------------------------------------- P1
// rows of superblock i: up to the next superblock's offset, the last one up
// to total_rows
__device__ __forceinline__ int sb_rows(const int* sb_off, int i, int NSB,
                                       int total_rows) {
  return (i + 1 < NSB ? sb_off[i + 1] : total_rows) - sb_off[i];
}

// zero n4 int4 from dst on, the block's nt threads striding
__device__ __forceinline__ void zero_rows(uint4* dst, long long n4, int nt) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (long long t = threadIdx.x; t < n4; t += nt) dst[t] = z;
}

// or/owner: grid (NSB + 1, tiles); row NSB zeroes tile blockIdx.y of the
// E*W tail rows, returns true for those blocks
__device__ __forceinline__ bool tail_tile(unsigned* out, int NSB, int E,
                                          int W, int total_rows) {
  if ((int)blockIdx.x != NSB) return false;
  const int r0 = blockIdx.y * TILE;
  const int rows = min(TILE, E * W - r0);
  zero_rows(reinterpret_cast<uint4*>(out + ((long long)total_rows + r0) *
                                               LANES),
            (long long)rows * (LANES / 4), NT);
  return true;
}

__global__ void __launch_bounds__(NT)
dynwin_or_kernel(const unsigned* __restrict__ planes,
                 const int* __restrict__ woff, const int* __restrict__ sb_off,
                 unsigned* __restrict__ out, int NSB, int E, int W,
                 int total_rows) {
  __shared__ unsigned tile[TILE * LANES];
  if (tail_tile(out, NSB, E, W, total_rows)) return;
  const int i = blockIdx.x;
  const int r0 = blockIdx.y * TILE;
  const int rows = min(TILE, sb_rows(sb_off, i, NSB, total_rows) - r0);
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
                    const int* __restrict__ sb_off, unsigned* __restrict__ out,
                    int NSB, int E, int W, int total_rows) {
  if (tail_tile(out, NSB, E, W, total_rows)) return;
  const int i = blockIdx.x;
  const int r0 = blockIdx.y * TILE;
  const int rows = min(TILE, sb_rows(sb_off, i, NSB, total_rows) - r0);
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

// run/bulk: grid (E, NSB + 1). Block (j, i < NSB) owns plane (i, j): its
// source, destination and int4 count; block (j, NSB) the tail rows
// [total_rows + j*W, total_rows + (j+1)*W), src null.
struct Run {
  const uint4* src;
  uint4* dst;
  long long n4;
};

__device__ __forceinline__ Run plane_run(const uint4* planes, const int* woff,
                                         const int* sb_off, uint4* out,
                                         int NSB, int E, int W,
                                         int total_rows) {
  const int j = blockIdx.x, i = blockIdx.y;
  const long long w4 = (long long)W * (LANES / 4);
  if (i == NSB)
    return {nullptr, out + ((long long)total_rows + (long long)j * W) *
                               (LANES / 4), w4};
  const int o = woff[i * E + j];
  const int end = j + 1 < E ? woff[i * E + j + 1]
                            : sb_rows(sb_off, i, NSB, total_rows);
  return {planes + (long long)(i * E + j) * w4,
          out + ((long long)sb_off[i] + o) * (LANES / 4),
          (long long)(end - o) * (LANES / 4)};
}

__global__ void __launch_bounds__(NT)
dynwin_run_kernel(const uint4* __restrict__ planes,
                  const int* __restrict__ woff, const int* __restrict__ sb_off,
                  uint4* __restrict__ out, int NSB, int E, int W,
                  int total_rows) {
  const Run r = plane_run(planes, woff, sb_off, out, NSB, E, W, total_rows);
  if (r.src == nullptr) {
    zero_rows(r.dst, r.n4, NT);
    return;
  }
  for (long long t0 = threadIdx.x; t0 < r.n4; t0 += NT * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t0 + u * NT < r.n4) v[u] = r.src[t0 + u * NT];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t0 + u * NT < r.n4) r.dst[t0 + u * NT] = v[u];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(NT_BULK)
dynwin_bulk_kernel(const uint4* __restrict__ planes,
                   const int* __restrict__ woff,
                   const int* __restrict__ sb_off, uint4* __restrict__ out,
                   int NSB, int E, int W, int total_rows) {
  extern __shared__ __align__(128) unsigned char buf[];  // 2 * PIECE
  __shared__ __align__(8) unsigned long long bars[2];
  const Run r = plane_run(planes, woff, sb_off, out, NSB, E, W, total_rows);
  if (r.src == nullptr) {
    zero_rows(r.dst, r.n4, NT_BULK);
    return;
  }
  if (threadIdx.x != 0 || r.n4 <= 0) return;
  const long long bytes = r.n4 * 16;
  const int pieces = (int)((bytes + PIECE - 1) / PIECE);
  const unsigned b0 = smem_addr(buf), bar0 = smem_addr(bars);
  for (int k = 0; k < 2; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar0 + 8 * k) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const char* src = reinterpret_cast<const char*>(r.src);
  char* dst = reinterpret_cast<char*>(r.dst);
  auto len = [&](int p) {
    return (unsigned)min((long long)PIECE, bytes - (long long)p * PIECE);
  };
  for (int p = 0; p < 2 && p < pieces; ++p)
    bulk_load(b0 + p * PIECE, src + (long long)p * PIECE, len(p),
              bar0 + 8 * p);
  for (int p = 0; p < pieces; ++p) {
    const int k = p & 1;
    bar_wait(bar0 + 8 * k, (p >> 1) & 1);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(dst + (long long)p * PIECE), "r"(b0 + k * PIECE), "r"(len(p))
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (p + 2 < pieces) {
      // buffer k is free once the store just issued has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bulk_load(b0 + k * PIECE, src + (long long)(p + 2) * PIECE,
                len(p + 2), bar0 + 8 * k);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- P2

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

// planes: (NSB, E, W, 128) u32; woff: (NSB, E); sb_off: (NSB,); out:
// (total_rows + E*W, 128), every row written here (the last E*W zero).
// variant 0 = or, 1 = owner, 2 = run, 3 = bulk. One launch.
MGARD_EXPORT int probe_dynwin(const void* planes, const void* woff,
                              const void* sb_off, void* out, int NSB, int E,
                              int W, int total_rows, int variant,
                              void* stream) {
  if (NSB <= 0 || E <= 0 || W <= 0 || total_rows < 0 || variant < 0 ||
      variant > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned* pl = (const unsigned*)planes;
  const int* wo = (const int*)woff;
  const int* so = (const int*)sb_off;
  if (variant <= 1) {
    const dim3 grid((unsigned)NSB + 1, (unsigned)((E * W + TILE - 1) / TILE));
    if (variant == 0)
      dynwin_or_kernel<<<grid, NT, 0, st>>>(pl, wo, so, (unsigned*)out, NSB,
                                            E, W, total_rows);
    else
      dynwin_owner_kernel<<<grid, NT, 0, st>>>(pl, wo, so, (unsigned*)out,
                                               NSB, E, W, total_rows);
    return mgard_launch_status();
  }
  if (!mgard_aligned16(planes) || !mgard_aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((unsigned)E, (unsigned)NSB + 1);
  const uint4* p4 = (const uint4*)planes;
  if (variant == 2) {
    dynwin_run_kernel<<<grid, NT, 0, st>>>(p4, wo, so, (uint4*)out, NSB, E, W,
                                           total_rows);
    return mgard_launch_status();
  }
  struct BulkTag {};
  const cudaError_t e = mgard_set_attributes<BulkTag>(
      {(const void*)dynwin_bulk_kernel}, 2 * PIECE, false);
  if (e != cudaSuccess) return mgard_launch_status(e);
  dynwin_bulk_kernel<<<grid, NT_BULK, 2 * PIECE, st>>>(p4, wo, so, (uint4*)out,
                                                       NSB, E, W, total_rows);
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
