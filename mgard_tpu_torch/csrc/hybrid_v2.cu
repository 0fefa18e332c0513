// K1 hybrid_fwd_v2 and K4 hybrid_inv_v2: the hybrid flag-1 ("v2") front end.
//
// Replaces the TPU kernels mgard_tpu/ops/hybrid.py::local_transform_fused_v2
// (body _fwd_kernel_v2_body) and ::local_inverse_fused_v2 (body
// _inv_kernel_v2_body). Plain versions: local_transform_v2 and
// local_inverse_v2 in mgard_tpu_torch/ops/hybrid.py, which the kernels match
// bit for bit (every float operation below is one rounded IEEE f32 operation
// in the plain version's order; the library is built with -fmad=false).
//
// What bounds them on the H100: the work is bytes. K1 reads 4 bytes and
// writes 2 (+ 1/16 of a float for the remainder) per element; K4 the
// reverse; the 3-level stencil is ~20 flops per element. The first design
// (a shared 8 x 8 x 64 tile, every pass a loop over all 4096 elements with
// index division, 17 barriers a tile) was bound by instruction issue and
// barriers, at 9-11x the byte bound. This one keeps the stencil in
// registers (line8.cuh): a warp owns one 8^3 block, each lane two whole z
// lines, x and y exchanged by shuffles, z along the line, only the level's
// chain points computed; it runs at about 2x the byte bound, where
// PyTorch's own f32 <-> f16 casts of the same byte counts run at 1.1-1.7x.
//
// Layout: a thread block of 32*NB threads owns an 8x8 (x, y) column of
// 8-blocks over the whole z axis and walks it in tiles of NB whole 8^3
// blocks (warp w takes z-block w of the tile); the next tile's loads are in
// flight while the current one is computed. K1 takes NB = 16, which makes
// every payload run it writes a full 32-byte sector (at NB = 8 its 16-byte
// runs are half sectors, and K1 ran 2.7x slower on the H100); K4 takes
// NB = 8, which ran faster for it than 16. The u16 payload is grouped
// (pay[..., c*g + jz] holds z = 8*jz + c): the warps leave their codes in a
// shared stage [jz][line][c], and after the tile's barrier each thread
// moves whole runs of NB codes of one (line, c). K1 loads each lane's lines
// as float4s (32 contiguous bytes each); K4 stages its output tile in
// shared memory so that a warp stores whole rows. K1's per-chunk widths
// span tiles (at 512^3 one chunk is a whole (x, y) row): each lane ORs its
// lines' codes in registers while their chunk stays the same, then maxes
// the width into a shared slot (no global atomics), stored once at the
// end. The remainder's corner values go straight from registers to rem
// (K4: from rem to registers, loaded a tile ahead).
#include "common.cuh"
#include "line8.cuh"

namespace {

constexpr int MAX_H = 32;   // chunk rows per (x, y) row (Z <= 1024)
constexpr int LINES = 64;   // z lines of an 8^3 block
constexpr int RUNS = 512;   // (line, c) payload runs of a tile
constexpr int FWD_NB = 16;  // z-blocks a tile of K1
constexpr int INV_NB = 8;   // z-blocks a tile of K4

// The low halves of two codes as one word (a in bits 0-15).
__device__ __forceinline__ unsigned pack2(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5410);
}

// Max of the code widths of one line into wrow[h], one shared atomic per
// chunk the line's classes fall in (at most one where the slot already
// holds as much); hv holds the chunk of each class c in byte c (the same
// for every line of the tile).
__device__ __forceinline__ void line_widths(const unsigned (&zz)[8], uint2 hv,
                                            unsigned* wrow) {
  unsigned acc = 0u;
  unsigned h = hv.x & 0xFFu;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned hc = ((c < 4 ? hv.x : hv.y) >> (8 * (c & 3))) & 0xFFu;
    if (hc != h) {
      const unsigned w = 32u - (unsigned)__clz((int)acc);
      if (w > wrow[h]) atomicMax(&wrow[h], w);
      acc = 0u;
      h = hc;
    }
    acc |= zz[c];
  }
  const unsigned w = 32u - (unsigned)__clz((int)acc);
  if (w > wrow[h]) atomicMax(&wrow[h], w);
}

// The compiler must fit two blocks of 512 threads an SM (64 registers a
// thread), so that 32 warps hide the latency of the shuffle chains.
__global__ void __launch_bounds__(32 * FWD_NB, 2)
hybrid_fwd_v2_kernel(const float* __restrict__ v, float inv_q,
                     uint16_t* __restrict__ pay, int* __restrict__ cw,
                     float* __restrict__ rem, int X, int Y, int Z, int CL,
                     int H, int nl) {
  constexpr int NB = FWD_NB, NT = 32 * NB;
  __shared__ __align__(16) uint16_t stage[2][NB * RUNS];
  __shared__ unsigned wmax[LINES * MAX_H];
  __shared__ __align__(8) unsigned char hof[1024 / 8];  // [tile][c] chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xi = lane >> 2, j = lane & 3;
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8, T = g / NB;
  const unsigned cmask = chain_mask(nl);
  const int k = __popc(cmask), RY = Y / 8 * k, RZ = Z / 8 * k;
  for (int i = threadIdx.x; i < LINES * H; i += NT) wmax[i] = 0u;
  for (int i = threadIdx.x; i < T * 8; i += NT)
    hof[i] = (unsigned char)(((i & 7) * g + (i >> 3) * NB) / CL);
  __syncthreads();

  const bool xin = in_chain(nl, xi);
  const bool ca = xin && in_chain(nl, 2 * j), cb = xin && in_chain(nl, 2 * j + 1);
  const float* ra = v + row_of(x0, y0, Y, Z, 2 * lane) + 8 * warp;
  const float* rb = ra + Z;
  Lines nx;
  load_line(ra, nx.a);
  load_line(rb, nx.b);
  for (int t = 0; t < T; ++t) {
    Lines l = nx;
    if (t + 1 < T) {
      load_line(ra + 8 * NB * (t + 1), nx.a);
      load_line(rb + 8 * NB * (t + 1), nx.b);
    }
    decompose_lines(l, xi, j, nl);

    const int jz = t * NB + warp;
    unsigned za[8], zb[8];
    line_codes(l.a, ca, cmask, inv_q,
               rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j, jz, 0), za);
    line_codes(l.b, cb, cmask, inv_q,
               rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j + 1, jz, 0),
               zb);
    const uint2 hv = *reinterpret_cast<const uint2*>(&hof[8 * t]);
    line_widths(za, hv, &wmax[(2 * lane) * H]);
    line_widths(zb, hv, &wmax[(2 * lane + 1) * H]);
    uint16_t* st = stage[t & 1];
    uint4* sl = reinterpret_cast<uint4*>(&st[warp * RUNS + lane * 16]);
    sl[0] = make_uint4(pack2(za[0], za[1]), pack2(za[2], za[3]),
                       pack2(za[4], za[5]), pack2(za[6], za[7]));
    sl[1] = make_uint4(pack2(zb[0], zb[1]), pack2(zb[2], zb[3]),
                       pack2(zb[4], zb[5]), pack2(zb[6], zb[7]));
    // One barrier a tile: the stage is double-buffered, and its other half
    // (tile t - 1) is not written again before the next barrier.
    __syncthreads();
#pragma unroll
    for (int r = threadIdx.x; r < RUNS; r += NT) {
      const int c = r & 7;
      unsigned w[NB / 2];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i)
        w[i] = (unsigned)st[2 * i * RUNS + r] |
               ((unsigned)st[(2 * i + 1) * RUNS + r] << 16);
      uint4* dst = reinterpret_cast<uint4*>(
          pay + row_of(x0, y0, Y, Z, r >> 3) + c * g + t * NB);
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
        dst[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < LINES * H; i += NT) {
    const int col = i / H, h = i % H;
    cw[((size_t)(x0 + col / 8) * Y + (y0 + col % 8)) * H + h] = (int)wmax[i];
  }
}

__global__ void __launch_bounds__(32 * INV_NB)
hybrid_inv_v2_kernel(const uint16_t* __restrict__ pay,
                     const float* __restrict__ rem, float q,
                     float* __restrict__ out, int X, int Y, int Z, int nl) {
  constexpr int NB = INV_NB, NT = 32 * NB, RPT = RUNS / NT;
  // The payload stage (two halves of NB*RUNS codes) and the output tile (64
  // lines of 2*NB float4s): 32 KB.
  __shared__ __align__(16) uint16_t stage[2][NB * RUNS];
  __shared__ float4 ob[LINES * 2 * NB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xi = lane >> 2, j = lane & 3;
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8, T = g / NB;
  const unsigned cmask = chain_mask(nl);
  const int k = __popc(cmask), RY = Y / 8 * k, RZ = Z / 8 * k;
  const bool xin = in_chain(nl, xi);
  const bool ca = xin && in_chain(nl, 2 * j), cb = xin && in_chain(nl, 2 * j + 1);

  // Payload runs (line, c) of this thread and the lane's corner values, a
  // tile ahead.
  uint4 run[RPT][NB / 8];
  float cra[8], crb[8];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = threadIdx.x + i * NT;
      const uint4* src = reinterpret_cast<const uint4*>(
          pay + row_of(x0, y0, Y, Z, r >> 3) + (r & 7) * g + t * NB);
#pragma unroll
      for (int q8 = 0; q8 < NB / 8; ++q8) run[i][q8] = __ldg(src + q8);
    }
    const int jz = t * NB + warp;
    line_corners(rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j, jz, 0), ca,
                 cmask, cra);
    line_corners(
        rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j + 1, jz, 0), cb,
        cmask, crb);
  };
  fetch(0);
  for (int t = 0; t < T; ++t) {
    uint16_t* st = stage[t & 1];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = threadIdx.x + i * NT;
#pragma unroll
      for (int q8 = 0; q8 < NB / 8; ++q8) {
        const unsigned w[4] = {run[i][q8].x, run[i][q8].y, run[i][q8].z,
                               run[i][q8].w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          st[(8 * q8 + e) * RUNS + r] = (uint16_t)(w[e >> 1] >> (16 * (e & 1)));
      }
    }
    Lines l;
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      l.a[z] = cra[z];
      l.b[z] = crb[z];
    }
    // Two barriers a tile: here (the stage is double-buffered, and every
    // warp read tile t - 1's output tile before it got here) and before the
    // rows are stored.
    __syncthreads();
    if (t + 1 < T) fetch(t + 1);
    const uint4* sl = reinterpret_cast<const uint4*>(&st[warp * RUNS + lane * 16]);
    const uint4 pa = sl[0], pb = sl[1];
    const unsigned wa[4] = {pa.x, pa.y, pa.z, pa.w};
    const unsigned wb[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      const bool on = (cmask >> z) & 1u;
      const unsigned sh = 16 * (z & 1);
      if (!(ca && on)) l.a[z] = unzigzag_dequantize((wa[z >> 1] >> sh) & 0xFFFFu, q);
      if (!(cb && on)) l.b[z] = unzigzag_dequantize((wb[z >> 1] >> sh) & 0xFFFFu, q);
    }
    recompose_lines(l, xi, j, nl);
    stage_tile<NB>(ob, l, warp, lane);
    __syncthreads();
    store_tile<NB>(ob, out + row_of(x0, y0, Y, Z, 0) + 8 * NB * t, Y, Z);
  }
}

}  // namespace

MGARD_EXPORT const char* mgard_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Shapes are checked by the Python wrapper: X, Y multiples of 8, Z a
// multiple of 128 and at most 1024, C*32 divides Z, nl in 1..3. The field
// and the payload must be 16-byte aligned (vector loads and stores).
MGARD_EXPORT int hybrid_fwd_v2(const void* v, float inv_q, void* pay, void* cw,
                               void* rem, int X, int Y, int Z, int C, int nl,
                               void* stream) {
  const int CL = C * 32, H = Z / CL;
  if (H > MAX_H) return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(v) || !mgard_aligned16(pay))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid(Y / 8, X / 8);
  hybrid_fwd_v2_kernel<<<grid, 32 * FWD_NB, 0, (cudaStream_t)stream>>>(
      (const float*)v, inv_q, (uint16_t*)pay, (int*)cw, (float*)rem, X, Y, Z,
      CL, H, nl);
  return mgard_launch_status();
}

MGARD_EXPORT int hybrid_inv_v2(const void* pay, const void* rem, float q,
                               void* out, int X, int Y, int Z, int nl,
                               void* stream) {
  if (!mgard_aligned16(pay) || !mgard_aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid(Y / 8, X / 8);
  hybrid_inv_v2_kernel<<<grid, 32 * INV_NB, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)pay, (const float*)rem, q, (float*)out, X, Y, Z, nl);
  return mgard_launch_status();
}
