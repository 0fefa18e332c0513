// K7 hybrid_fwd and K8 hybrid_inv: the hybrid flag-0 front end, 2D and 3D.
//
// Replaces the TPU kernels mgard_tpu/ops/hybrid.py::local_transform_fused
// (body _fwd_kernel_body) and ::local_inverse_fused (body _inv_kernel_body).
// Plain versions: local_transform and local_inverse in
// mgard_tpu_torch/ops/hybrid.py, which the kernels match bit for bit (every
// float operation is one rounded IEEE f32 operation in the plain version's
// order; the library is built with -fmad=false). K7 stores int32 symbols in
// natural order (0 at the corner positions) and the compact corner
// remainder (X/8*k, Y/8*k, Z/8*k), or (Y/8*k, Z/8*k) in 2D; K8 is its
// mirror. Every 2D/3D float32 shape with every axis a multiple of 8 takes
// them, at nl 1-3 (the TPU kernel's lane-axis limits do not apply).
//
// What bounds them on the H100: the work is bytes. Each moves 4 bytes in
// and 4 out per element (+ the corner floats); the 3-level stencil is ~35
// lane operations per element. The first design (a 256-thread block over a
// shared tile of 4096 elements, every level-axis pass a loop over the whole
// tile, ~13 barriers a tile) was bound by instruction issue and barriers,
// at 7-9x the byte bound. This one is K1/K4's register-line stencil
// (line8.cuh): a warp owns one 8^3 block, each lane two whole z lines
// (16-byte vector loads), x and y exchanged by shuffles, z along the line,
// only the level's chain points computed. The output tile leaves through
// shared memory as K4's does (stage_tile), so that a warp stores whole rows
// of 8*NB values: two 16-byte stores a line straight from registers ran
// both kernels 1.6-1.7x slower on the H100 (scripts/h100_flag0_variants.py).
// K7's corner values are staged the same way, as rows of NB*k floats of the
// remainder (scalar stores from registers: K7 1.4x slower at nl = 1, 125
// corners a block). Two blocks an SM leave the compiler 128 registers; at
// 64 both kernels spilled and ran 1.3x slower.
//
// Layout: a thread block of NB warps owns an 8x8 (x, y) column of 8-blocks
// and walks its z-blocks in tiles of NB, warp w taking z-block w of each
// tile, the next tile's lines loaded while the current one computes; one
// barrier a tile (the stages are double-buffered). A 2D (Y, Z) field has
// the memory layout of a (Y/8, 8, Z) one: a block owns a group of eight
// y-blocks, lane 4*b + j the lines 2j and 2j + 1 of y-block b, and the x
// pass drops out (line8.cuh, XP = false); lanes of y-blocks past the
// field's end (Y/8 not a multiple of 8), and warps past it in a last tile
// (Z/8 not a multiple of NB), load and store nothing but take part in the
// shuffles and barriers. Where the columns are too few to fill the card
// (8192^2 has 128 groups, an (8, 8, Z) field one column), the z walk is
// split into segments of whole tiles, a thread block each, so that the grid
// holds at least WAVES waves of resident blocks; which warp owns a z-block
// does not change. The grid is flat (segments within a column). Each kernel
// is instantiated per nl, so the corner masks are constants.
#include "common.cuh"
#include "line8.cuh"

namespace {

// z-blocks a tile (a warp each) and the blocks an SM must hold (which sets
// the register budget) of K7 and of K8
constexpr int FWD_NB = 8, FWD_BPS = 2;
constexpr int INV_NB = 8, INV_BPS = 2;
constexpr int WAVES = 2;  // resident-block waves a grid holds at least

// Corner positions per axis of chain nl.
__host__ __device__ constexpr int corners(int nl) {
  return nl == 1 ? 5 : nl == 2 ? 3 : 2;
}

// The field as (Xl, Yl, Z): 3D (X, Y, Z), 2D (Y/8, 8, Z); and the z walk.
struct Geom {
  int Xl, Yl, Z;
  int nyc;         // 8x8 columns along y (1 in 2D)
  int nseg, segt;  // segments a column; tiles a segment
};

// What one thread walks: the block's column (x0, y0), and the lane's lines
// a (y = 2j) and b (y = 2j + 1) of x-block xi (in 2D: of y-block xi of the
// group) in z-block t*NB + warp of each tile t of the segment.
template <bool D2, int NL, int NB>
struct Walk {
  static constexpr int K = corners(NL);
  int warp, xi, j;
  bool live;          // the lane's 8-block lies in the field
  bool ca, cb;        // line a / b holds corners
  int ra, rb;         // their rows among the column's corner rows
  int x0, y0;
  size_t col, row;    // element offsets at z = 0 of line 0 and of line a
  int nlines;         // lines of the column in the field
  int g, t0, t1;      // z-blocks of the field; the segment's tiles

  __device__ __forceinline__ explicit Walk(const Geom& G) {
    warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    xi = lane >> 2;
    j = lane & 3;
    const int c = blockIdx.x / G.nseg, seg = blockIdx.x % G.nseg;
    x0 = c / G.nyc * 8;
    y0 = c % G.nyc * 8;
    live = !D2 || x0 + xi < G.Xl;
    const int px = D2 ? 0 : xi;
    ca = in_chain(NL, px) && in_chain(NL, 2 * j);
    cb = in_chain(NL, px) && in_chain(NL, 2 * j + 1);
    const int rx = (D2 ? xi : rem_col(NL, xi)) * K;
    ra = rx + rem_col(NL, 2 * j);
    rb = rx + rem_col(NL, 2 * j + 1);
    col = ((size_t)x0 * G.Yl + y0) * G.Z;
    row = col + ((size_t)xi * G.Yl + 2 * j) * G.Z;
    nlines = D2 ? min(64, 8 * (G.Xl - x0)) : 64;
    g = G.Z / 8;
    t0 = seg * G.segt;
    t1 = min((g + NB - 1) / NB, t0 + G.segt);
  }

  // Does the lane hold a block in tile t?
  __device__ __forceinline__ bool has(int t) const {
    return live && t * NB + warp < g;
  }

  // Row of the remainder (of g*K floats) that corner row r of the column
  // is: (xi, y) corner columns (r / K, r % K) in 3D, y-block r / K in 2D.
  __device__ __forceinline__ size_t rem_row(const Geom& G, int r) const {
    return D2 ? (size_t)x0 * K + r
              : ((size_t)(x0 / 8) * K + r / K) * (G.Yl / 8 * K) +
                    (size_t)(y0 / 8) * K + r % K;
  }
};

__device__ __forceinline__ void load_syms(const int* p, int (&s)[8]) {
  const int4 u = __ldg(reinterpret_cast<const int4*>(p));
  const int4 v = __ldg(reinterpret_cast<const int4*>(p) + 1);
  s[0] = u.x; s[1] = u.y; s[2] = u.z; s[3] = u.w;
  s[4] = v.x; s[5] = v.y; s[6] = v.z; s[7] = v.w;
}

// line8.cuh's store_tile for a column that may lie partly outside the
// field: only its first nlines lines and the first nch 16-byte chunks of
// each (the tile's z-blocks in the field).
template <int NB>
__device__ __forceinline__ void store_rows(const float4* ob, float* out,
                                           int Yl, int Z, int nlines,
                                           int nch) {
  constexpr int CH = 2 * NB, NT = 32 * NB;
#pragma unroll
  for (int i = 0; i < 64 * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT, L = e / CH, c = e % CH;
    if (L < nlines && c < nch)
      __stcs(reinterpret_cast<float4*>(
                 out + ((size_t)(L >> 3) * Yl + (L & 7)) * Z) + c,
             ob[L * CH + (c ^ ((L >> 1) & 7))]);
  }
}

template <bool D2, int NL>
__global__ void __launch_bounds__(32 * FWD_NB, FWD_BPS)
flag0_fwd_kernel(const float* __restrict__ v, float inv_q,
                 int* __restrict__ sym, float* __restrict__ rem, Geom G) {
  constexpr int NB = FWD_NB, NT = 32 * NB, K = corners(NL);
  // corner rows of a column, and their floats a tile
  constexpr int R = (D2 ? 8 : K) * K, RW = NB * K;
  __shared__ float4 ob[2][64 * 2 * NB];
  __shared__ float rs[2][R * RW];
  const Walk<D2, NL, NB> w(G);
  const unsigned cmask = chain_mask(NL);
  const float* va = v + w.row;
  const float* vb = va + G.Z;
  Lines nx = {};
  auto load = [&](int t) {
    if (!w.has(t)) return;
    load_line(va + 8 * (size_t)(t * NB + w.warp), nx.a);
    load_line(vb + 8 * (size_t)(t * NB + w.warp), nx.b);
  };
  load(w.t0);
  for (int t = w.t0; t < w.t1; ++t) {
    Lines l = nx;
    if (t + 1 < w.t1) load(t + 1);
    decompose_lines<!D2>(l, w.xi, w.j, NL);
    const bool on = w.has(t);
    float* rt = rs[t & 1] + w.warp * K;
    int sa[8], sb[8];
    line_syms(l.a, on && w.ca, cmask, inv_q, rt + w.ra * RW, sa);
    line_syms(l.b, on && w.cb, cmask, inv_q, rt + w.rb * RW, sb);
    Lines s;  // the symbols' bit patterns
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      s.a[z] = __int_as_float(sa[z]);
      s.b[z] = __int_as_float(sb[z]);
    }
    stage_tile<NB>(ob[t & 1], s, w.warp, threadIdx.x & 31);
    // One barrier a tile: the stages are double-buffered, and their other
    // halves (tile t - 1) are not written again before the next barrier.
    __syncthreads();
    const int nz = min(NB, w.g - t * NB);
    store_rows<NB>(ob[t & 1],
                   reinterpret_cast<float*>(sym) + w.col + 8 * (size_t)t * NB,
                   G.Yl, G.Z, w.nlines, 2 * nz);
    const size_t RZ = (size_t)w.g * K;
    for (int e = threadIdx.x; e < R * RW; e += NT) {
      const int r = e / RW, c = e % RW;
      if (c < nz * K && (!D2 || w.x0 + r / K < G.Xl))
        rem[w.rem_row(G, r) * RZ + (size_t)t * RW + c] = rs[t & 1][e];
    }
  }
}

template <bool D2, int NL>
__global__ void __launch_bounds__(32 * INV_NB, INV_BPS)
flag0_inv_kernel(const int* __restrict__ sym, const float* __restrict__ rem,
                 float q, float* __restrict__ out, Geom G) {
  constexpr int NB = INV_NB, K = corners(NL);
  __shared__ float4 ob[2][64 * 2 * NB];
  const Walk<D2, NL, NB> w(G);
  const unsigned cmask = chain_mask(NL);
  const size_t RZ = (size_t)w.g * K;
  const int* sa_at = sym + w.row;
  const int* sb_at = sa_at + G.Z;
  const float* ra_at = rem + w.rem_row(G, w.ra) * RZ + w.warp * K;
  const float* rb_at = rem + w.rem_row(G, w.rb) * RZ + w.warp * K;
  // the lines' symbols and corner values, a tile ahead
  int sa[8] = {}, sb[8] = {};
  float cra[8], crb[8];
  auto fetch = [&](int t) {
    const bool on = w.has(t);
    if (on) {
      load_syms(sa_at + 8 * (size_t)(t * NB + w.warp), sa);
      load_syms(sb_at + 8 * (size_t)(t * NB + w.warp), sb);
    }
    line_corners(ra_at + (size_t)t * NB * K, on && w.ca, cmask, cra);
    line_corners(rb_at + (size_t)t * NB * K, on && w.cb, cmask, crb);
  };
  fetch(w.t0);
  for (int t = w.t0; t < w.t1; ++t) {
    Lines l;
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      const bool c = (cmask >> z) & 1u;
      l.a[z] = w.ca && c ? cra[z] : __fmul_rn(__int2float_rn(sa[z]), q);
      l.b[z] = w.cb && c ? crb[z] : __fmul_rn(__int2float_rn(sb[z]), q);
    }
    if (t + 1 < w.t1) fetch(t + 1);
    recompose_lines<!D2>(l, w.xi, w.j, NL);
    stage_tile<NB>(ob[t & 1], l, w.warp, threadIdx.x & 31);
    __syncthreads();  // as K7's: one a tile, the stage double-buffered
    store_rows<NB>(ob[t & 1], out + w.col + 8 * (size_t)t * NB, G.Yl, G.Z,
                   w.nlines, 2 * min(NB, w.g - t * NB));
  }
}

using FwdKernel = void (*)(const float*, float, int*, float*, Geom);
using InvKernel = void (*)(const int*, const float*, float, float*, Geom);
// [2D][nl - 1]
const FwdKernel FWD[2][3] = {
    {flag0_fwd_kernel<false, 1>, flag0_fwd_kernel<false, 2>,
     flag0_fwd_kernel<false, 3>},
    {flag0_fwd_kernel<true, 1>, flag0_fwd_kernel<true, 2>,
     flag0_fwd_kernel<true, 3>}};
const InvKernel INV[2][3] = {
    {flag0_inv_kernel<false, 1>, flag0_inv_kernel<false, 2>,
     flag0_inv_kernel<false, 3>},
    {flag0_inv_kernel<true, 1>, flag0_inv_kernel<true, 2>,
     flag0_inv_kernel<true, 3>}};

// The geometry and grid of an (X, Y, Z) field (X = 1: a 2D (Y, Z) field)
// walked in tiles of nb z-blocks, bps blocks resident an SM; false if an
// axis is not a multiple of 8, nl is not in 1..3, or the grid would not fit.
bool plan(int X, int Y, int Z, int nl, int nb, int bps, Geom& G,
          unsigned& blocks) {
  if (X < 1 || Y < 8 || Z < 8 || Y % 8 || Z % 8 || nl < 1 || nl > 3)
    return false;
  if (X != 1 && X % 8) return false;
  const bool d2 = X == 1;
  G.Xl = d2 ? Y / 8 : X;
  G.Yl = d2 ? 8 : Y;
  G.Z = Z;
  G.nyc = G.Yl / 8;
  const long long cols = (long long)((G.Xl + 7) / 8) * G.nyc;
  const int tiles = (Z / 8 + nb - 1) / nb;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (long long)WAVES * sms * bps;
  const long long split = cols >= want ? 1 : (want + cols - 1) / cols;
  // at least min(split, tiles) segments of whole tiles
  G.segt = tiles / (split < tiles ? (int)split : tiles);
  G.nseg = (tiles + G.segt - 1) / G.segt;
  const long long nbk = cols * G.nseg;
  if (nbk > 0x7FFFFFFFLL) return false;
  blocks = (unsigned)nbk;
  return true;
}

}  // namespace

// v: (X, Y, Z) float32, or (Y, Z) with X = 1; sym: int32 of v's shape;
// rem: float32 (X/8*k, Y/8*k, Z/8*k) (without the first axis for X = 1),
// k = corners per axis of chain nl. Every axis a multiple of 8, nl in 1..3;
// v and sym 16-byte aligned (vector loads and stores).
MGARD_EXPORT int hybrid_fwd(const void* v, float inv_q, void* sym, void* rem,
                            int X, int Y, int Z, int nl, void* stream) {
  Geom G;
  unsigned blocks;
  if (!plan(X, Y, Z, nl, FWD_NB, FWD_BPS, G, blocks))
    return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(v) || !mgard_aligned16(sym))
    return (int)cudaErrorMisalignedAddress;
  FWD[X == 1][nl - 1]<<<blocks, 32 * FWD_NB, 0, (cudaStream_t)stream>>>(
      (const float*)v, inv_q, (int*)sym, (float*)rem, G);
  return mgard_launch_status();
}

// The mirror of hybrid_fwd: sym + rem -> out (float32 of sym's shape); sym
// and out 16-byte aligned.
MGARD_EXPORT int hybrid_inv(const void* sym, const void* rem, float q,
                            void* out, int X, int Y, int Z, int nl,
                            void* stream) {
  Geom G;
  unsigned blocks;
  if (!plan(X, Y, Z, nl, INV_NB, INV_BPS, G, blocks))
    return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(sym) || !mgard_aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  INV[X == 1][nl - 1]<<<blocks, 32 * INV_NB, 0, (cudaStream_t)stream>>>(
      (const int*)sym, (const float*)rem, q, (float*)out, G);
  return mgard_launch_status();
}
