// The 8 x 8 x 64 shared-memory tile of the z-grouped hybrid front ends,
// shared by K1/K4 (hybrid_v2.cu) and K10/K11 (hybrid_v3.cu): one thread
// block owns an 8x8 (x, y) column of 8-blocks and walks the z axis in tiles
// of 8 whole 8^3 blocks, so the 3-level stencil never needs a halo. Every
// float operation is one rounded IEEE f32 operation in the order of the
// plain versions in mgard_tpu_torch/ops/hybrid.py (local_decompose,
// local_recompose, quantize).
#pragma once

#include "local8.cuh"

namespace {

constexpr int ZT = 64;              // z extent of a tile: 8 whole 8-blocks
constexpr int TILE = 8 * 8 * ZT;    // elements per tile
constexpr int NT = 256;             // threads per block (the default)

// One level-axis interpolation pass over the tile, in place: it writes only
// the level's coefficient positions along `axis` and reads only coarse
// ones, so no element is read after it is written within the pass.
template <int NT_ = NT>
__device__ void interp_pass(float* w, int axis, int lvl) {
  const int stride = axis == 0 ? 8 * ZT : axis == 1 ? ZT : 1;
  for (int e = threadIdx.x; e < TILE; e += NT_) {
    const int p = axis == 0 ? e / (8 * ZT) : axis == 1 ? (e / ZT) & 7 : e & 7;
    if (!is_fine(lvl, p)) continue;
    int lp, rp;
    float wl, wr;
    lerp_rule(lvl, p, lp, rp, wl, wr);
    const float a = __fmul_rn(wl, w[e - (p - lp) * stride]);
    const float b = __fmul_rn(wr, w[e + (rp - p) * stride]);
    w[e] = __fadd_rn(a, b);
  }
}

// Tile element (xi, yi, zi) for the o-th slot of the payload order, in which
// consecutive slots run along the grouped z axis: slot oz = c*8 + jj holds
// natural z = 8*jj + c of the tile.
__device__ __forceinline__ void payload_slot(int o, int& xi, int& yi, int& c,
                                             int& jj) {
  xi = o / (8 * ZT);
  yi = (o / ZT) & 7;
  const int oz = o % ZT;
  c = oz / (ZT / 8);
  jj = oz % (ZT / 8);
}

// Local decompose of the tile in vs (ws is scratch), nl levels. The caller
// synchronizes before (vs loaded) and gets a synchronized block back.
template <int NT_ = NT>
__device__ void decompose_tile(float* vs, float* ws, int nl) {
  for (int lvl = 0; lvl < nl; ++lvl) {
    for (int e = threadIdx.x; e < TILE; e += NT_) ws[e] = vs[e];
    __syncthreads();
    for (int axis = 0; axis < 3; ++axis) {
      interp_pass<NT_>(ws, axis, lvl);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < TILE; e += NT_) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, pz = e & 7;
      if (coeff3(lvl, xi, yi, pz)) vs[e] = __fsub_rn(vs[e], ws[e]);
    }
    __syncthreads();
  }
}

// Local recompose of the tile in xs (ys is scratch), coarsest level first.
template <int NT_ = NT>
__device__ void recompose_tile(float* xs, float* ys, int nl) {
  for (int lvl = nl - 1; lvl >= 0; --lvl) {
    for (int e = threadIdx.x; e < TILE; e += NT_) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, pz = e & 7;
      ys[e] = coeff3(lvl, xi, yi, pz) ? 0.f : xs[e];
    }
    __syncthreads();
    for (int axis = 0; axis < 3; ++axis) {
      interp_pass<NT_>(ys, axis, lvl);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < TILE; e += NT_) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, pz = e & 7;
      if (coeff3(lvl, xi, yi, pz)) xs[e] = __fadd_rn(xs[e], ys[e]);
    }
    __syncthreads();
  }
}

// Round half away from zero of val*inv_q, then zigzag (u32 bit pattern).
__device__ __forceinline__ unsigned quantize_zigzag(float val, float inv_q) {
  const float t = __fmul_rn(val, inv_q);
  const float h = t < 0.f ? __fsub_rn(t, 0.5f) : __fadd_rn(t, 0.5f);
  const int sym = __float2int_rz(h);
  return ((unsigned)sym << 1) ^ (unsigned)(sym >> 31);
}

// Dequantized value of a zigzag code.
__device__ __forceinline__ float unzigzag_dequantize(unsigned zz, float q) {
  const int sym = (int)(zz >> 1) ^ -(int)(zz & 1u);
  return __fmul_rn(__int2float_rn(sym), q);
}

// Flat index of corner (xi, yi, c) of z-block jz in the compact remainder.
__device__ __forceinline__ size_t rem_index(int nl, int k, int RY, int RZ,
                                            int x0, int y0, int xi, int yi,
                                            int jz, int c) {
  return ((size_t)((x0 >> 3) * k + rem_col(nl, xi)) * RY + (y0 >> 3) * k +
          rem_col(nl, yi)) * RZ + jz * k + rem_col(nl, c);
}

}  // namespace
