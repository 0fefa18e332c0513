// K7 hybrid_fwd and K8 hybrid_inv: the hybrid flag-0 front end, 2D and 3D.
//
// Replaces the TPU kernels mgard_tpu/ops/hybrid.py::local_transform_fused
// (body _fwd_kernel_body) and ::local_inverse_fused (body _inv_kernel_body).
// Plain versions: local_transform and local_inverse in
// mgard_tpu_torch/ops/hybrid.py, which the kernels match bit for bit (every
// float operation below is one rounded IEEE f32 operation in the plain
// version's order; the library is built with -fmad=false).
//
// K7 is K1 (hybrid_v2.cu) without the zigzag, the z-class grouping and the
// chunk widths: it stores int32 symbols in natural order (0 at the corner
// positions) and the compact corner remainder. K8 is K4 without the
// ungrouping and the un-zigzag.
//
// What bounds them on the H100: memory. Each moves 4 bytes in and 4 bytes
// out per element (+ a corner share of floats); the 3-level stencil is ~20
// flops per element, far below the card's ratio of flops to bytes.
//
// Design: one thread block owns one tile of whole 8-blocks, TX x 8 x TZ
// elements (TX = 8 in 3D; a 2D (Y, Z) field runs as X = 1, TX = 1), with TZ
// the largest power of two up to 4096 / (8 TX) that divides Z. So any shape
// with every axis a multiple of 8 tiles exactly, the stencil never needs a
// halo, and a tile index splits by shifts (integer division by a runtime TZ
// in every pass made both kernels ~1.4x slower at 512^3). Position 0 is
// coarse at every level, so the 3D rules give the 2D ones for x = 0 and the
// x passes drop out. The TPU kernel's lane-axis limits (minor axis a
// multiple of 128, a VMEM budget) do not apply: every 2D/3D shape takes the
// kernel.
#include "common.cuh"
#include "local8.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAX_TILE = 4096;   // elements per tile

struct TileGeom {
  int TX, TZ, tzs, n;            // tile extents on x and z (TZ = 1 << tzs);
                                 // elements
  int x0, y0, z0;                // tile origin
};

__device__ __forceinline__ TileGeom tile_geom(int Y, int Z, int TX, int TZ) {
  TileGeom g;
  g.TX = TX;
  g.TZ = TZ;
  g.tzs = __ffs(TZ) - 1;
  g.n = TX * 8 * TZ;
  const int nz = Z / TZ, ny = Y / 8;
  const long long b = blockIdx.x;
  g.z0 = (int)(b % nz) * TZ;
  g.y0 = (int)((b / nz) % ny) * 8;
  g.x0 = (int)(b / ((long long)nz * ny)) * TX;
  return g;
}

__device__ __forceinline__ void tile_pos(const TileGeom& g, int e, int& xi,
                                         int& yi, int& zi) {
  xi = e >> (g.tzs + 3);
  yi = (e >> g.tzs) & 7;
  zi = e & (g.TZ - 1);
}

__device__ __forceinline__ size_t field_index(const TileGeom& g, int Y, int Z,
                                              int xi, int yi, int zi) {
  return ((size_t)(g.x0 + xi) * Y + (g.y0 + yi)) * Z + g.z0 + zi;
}

// Index in the compact remainder (X/8*k, Y/8*k, Z/8*k) of a corner element;
// for a 2D field (X = 1, x = 0) the leading term is 0.
__device__ __forceinline__ size_t rem_index(const TileGeom& g, int Y, int Z,
                                            int nl, int xi, int yi, int zi) {
  const int k = __popc(chain_mask(nl));
  const size_t RY = (size_t)(Y / 8) * k, RZ = (size_t)(Z / 8) * k;
  const int z = g.z0 + zi;
  return (((size_t)(g.x0 >> 3) * k + rem_col(nl, xi)) * RY +
          (size_t)(g.y0 >> 3) * k + rem_col(nl, yi)) * RZ +
         (size_t)(z >> 3) * k + rem_col(nl, z & 7);
}

__device__ __forceinline__ bool is_corner(int nl, int xi, int yi, int pz) {
  return in_chain(nl, xi) && in_chain(nl, yi) && in_chain(nl, pz);
}

// One level-axis interpolation pass over the tile, in place: it writes only
// the level's coefficient positions along `axis` and reads only coarse
// ones, so no element is read after it is written within the pass.
__device__ void interp_pass(float* w, const TileGeom& g, int axis, int lvl) {
  const int stride = axis == 0 ? 8 * g.TZ : axis == 1 ? g.TZ : 1;
  for (int e = threadIdx.x; e < g.n; e += NT) {
    int xi, yi, zi;
    tile_pos(g, e, xi, yi, zi);
    const int p = axis == 0 ? xi : axis == 1 ? yi : zi & 7;
    if (!is_fine(lvl, p)) continue;
    int lp, rp;
    float wl, wr;
    lerp_rule(lvl, p, lp, rp, wl, wr);
    const float a = __fmul_rn(wl, w[e - (p - lp) * stride]);
    const float b = __fmul_rn(wr, w[e + (rp - p) * stride]);
    w[e] = __fadd_rn(a, b);
  }
}

// The level's passes along every axis of the field (x only in 3D).
__device__ void interp_level(float* w, const TileGeom& g, int lvl) {
  for (int axis = g.TX == 1 ? 1 : 0; axis < 3; ++axis) {
    interp_pass(w, g, axis, lvl);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
hybrid_fwd_kernel(const float* __restrict__ v, float inv_q,
                  int* __restrict__ sym, float* __restrict__ rem, int Y,
                  int Z, int TX, int TZ, int nl) {
  __shared__ float vs[MAX_TILE];
  __shared__ float ws[MAX_TILE];
  const TileGeom g = tile_geom(Y, Z, TX, TZ);
  for (int e = threadIdx.x; e < g.n; e += NT) {
    int xi, yi, zi;
    tile_pos(g, e, xi, yi, zi);
    vs[e] = v[field_index(g, Y, Z, xi, yi, zi)];
  }
  __syncthreads();
  for (int lvl = 0; lvl < nl; ++lvl) {
    for (int e = threadIdx.x; e < g.n; e += NT) ws[e] = vs[e];
    __syncthreads();
    interp_level(ws, g, lvl);
    for (int e = threadIdx.x; e < g.n; e += NT) {
      int xi, yi, zi;
      tile_pos(g, e, xi, yi, zi);
      if (coeff3(lvl, xi, yi, zi & 7)) vs[e] = __fsub_rn(vs[e], ws[e]);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < g.n; e += NT) {
    int xi, yi, zi;
    tile_pos(g, e, xi, yi, zi);
    const float val = vs[e];
    int s = 0;
    if (is_corner(nl, xi, yi, zi & 7)) {
      rem[rem_index(g, Y, Z, nl, xi, yi, zi)] = val;
    } else {
      const float t = __fmul_rn(val, inv_q);
      const float h = t < 0.f ? __fsub_rn(t, 0.5f) : __fadd_rn(t, 0.5f);
      s = __float2int_rz(h);
    }
    sym[field_index(g, Y, Z, xi, yi, zi)] = s;
  }
}

__global__ void __launch_bounds__(NT)
hybrid_inv_kernel(const int* __restrict__ sym, const float* __restrict__ rem,
                  float q, float* __restrict__ out, int Y, int Z, int TX,
                  int TZ, int nl) {
  __shared__ float xs[MAX_TILE];
  __shared__ float ys[MAX_TILE];
  const TileGeom g = tile_geom(Y, Z, TX, TZ);
  for (int e = threadIdx.x; e < g.n; e += NT) {
    int xi, yi, zi;
    tile_pos(g, e, xi, yi, zi);
    xs[e] = is_corner(nl, xi, yi, zi & 7)
                ? rem[rem_index(g, Y, Z, nl, xi, yi, zi)]
                : __fmul_rn(__int2float_rn(sym[field_index(g, Y, Z, xi, yi,
                                                           zi)]), q);
  }
  __syncthreads();
  for (int lvl = nl - 1; lvl >= 0; --lvl) {
    for (int e = threadIdx.x; e < g.n; e += NT) {
      int xi, yi, zi;
      tile_pos(g, e, xi, yi, zi);
      ys[e] = coeff3(lvl, xi, yi, zi & 7) ? 0.f : xs[e];
    }
    __syncthreads();
    interp_level(ys, g, lvl);
    for (int e = threadIdx.x; e < g.n; e += NT) {
      int xi, yi, zi;
      tile_pos(g, e, xi, yi, zi);
      if (coeff3(lvl, xi, yi, zi & 7)) xs[e] = __fadd_rn(xs[e], ys[e]);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < g.n; e += NT) {
    int xi, yi, zi;
    tile_pos(g, e, xi, yi, zi);
    out[field_index(g, Y, Z, xi, yi, zi)] = xs[e];
  }
}

// Tile extents and block count of an (X, Y, Z) field; false if it does not
// tile (an axis not a multiple of 8, or more blocks than a grid holds).
bool plan(int X, int Y, int Z, int nl, int& TX, int& TZ, unsigned& blocks) {
  if (X < 1 || Y < 8 || Z < 8 || Y % 8 || Z % 8 || nl < 1 || nl > 3)
    return false;
  if (X != 1 && X % 8) return false;
  TX = X == 1 ? 1 : 8;
  TZ = MAX_TILE / (TX * 8);
  while (Z % TZ) TZ >>= 1;
  const long long nb = (long long)(X / TX) * (Y / 8) * (Z / TZ);
  if (nb > 0x7FFFFFFFLL) return false;
  blocks = (unsigned)nb;
  return true;
}

}  // namespace

// v: (X, Y, Z) float32, or (Y, Z) with X = 1; sym: int32 of v's shape;
// rem: float32 (X/8*k, Y/8*k, Z/8*k) (without the first axis for X = 1),
// k = corners per axis of chain nl. Every axis a multiple of 8, nl in 1..3.
MGARD_EXPORT int hybrid_fwd(const void* v, float inv_q, void* sym, void* rem,
                            int X, int Y, int Z, int nl, void* stream) {
  int TX, TZ;
  unsigned blocks;
  if (!plan(X, Y, Z, nl, TX, TZ, blocks)) return (int)cudaErrorInvalidValue;
  hybrid_fwd_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      (const float*)v, inv_q, (int*)sym, (float*)rem, Y, Z, TX, TZ, nl);
  return mgard_launch_status();
}

// The mirror of hybrid_fwd: sym + rem -> out (float32 of sym's shape).
MGARD_EXPORT int hybrid_inv(const void* sym, const void* rem, float q,
                            void* out, int X, int Y, int Z, int nl,
                            void* stream) {
  int TX, TZ;
  unsigned blocks;
  if (!plan(X, Y, Z, nl, TX, TZ, blocks)) return (int)cudaErrorInvalidValue;
  hybrid_inv_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int*)sym, (const float*)rem, q, (float*)out, Y, Z, TX, TZ, nl);
  return mgard_launch_status();
}
