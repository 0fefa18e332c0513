// The 8^3 local stencil of the hybrid front end on z lines held in
// registers (K1/K4, hybrid_v2.cu). One warp holds one 8^3 block: lane
// 4*xi + j holds the two z lines (xi, y = 2j) ("a") and (xi, y = 2j + 1)
// ("b"), eight values each. Every level-axis interpolation pass of the
// plain version (ops/hybrid.py::_interp_pass) becomes
//   x: two shuffles per value, from lanes 4*lx + j and 4*rx + j;
//   y: at most two shuffles, from the lanes holding the neighbour lines;
//   z: register arithmetic along the line.
// Only the level's chain points are computed (z on the chain; 512, 125 and
// 27 points of a block at levels 0, 1 and 2 are live): a pass along one
// axis keeps the other coordinates, so a value off the chain only ever
// feeds values off the chain, and the level's coefficients (coeff3) lie on
// it. Every float operation is one rounded IEEE f32 operation in the plain
// version's order: axes x, y, z within a level, x reading the level's copy
// and y reading x's output.
#pragma once

#include "local8.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

struct Lines {
  float a[8];  // z line (xi, 2j)
  float b[8];  // z line (xi, 2j + 1)
};

__device__ __forceinline__ float lerp2(float wl, float l, float wr, float r) {
  return __fadd_rn(__fmul_rn(wl, l), __fmul_rn(wr, r));
}

// x pass of level LVL, in place on w: fine x positions read coarse ones.
template <int LVL>
__device__ __forceinline__ void xpass(Lines& w, int xi, int j) {
  const bool fine = is_fine(LVL, xi);
  int lp = xi, rp = xi;
  float wl = 0.f, wr = 0.f;
  if (fine) lerp_rule(LVL, xi, lp, rp, wl, wr);
  const int sl = 4 * lp + j, sr = 4 * rp + j;
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (!in_chain(LVL, z)) continue;
    const float al = __shfl_sync(FULL_MASK, w.a[z], sl);
    const float ar = __shfl_sync(FULL_MASK, w.a[z], sr);
    const float bl = __shfl_sync(FULL_MASK, w.b[z], sl);
    const float br = __shfl_sync(FULL_MASK, w.b[z], sr);
    if (fine) {
      w.a[z] = lerp2(wl, al, wr, ar);
      w.b[z] = lerp2(wl, bl, wr, br);
    }
  }
}

// y pass of level LVL, in place on w. The fine y positions are odd at level
// 0 (the lanes' "b" lines) and even above ("a" lines), so a lane has at
// most one fine line. Its left neighbour is always an "a" line: y = 2j, the
// lane's own, at level 0; y = 0 or 4 of another lane above. Its right
// neighbour is the "a" line 2j + 2 of the next lane at level 0; at level 1
// the "a" line 4 of another lane, or for y = 6 the lane's own "b" line 7;
// at level 2 the "b" line 7 of another lane.
template <int LVL>
__device__ __forceinline__ void ypass(Lines& w, int xi, int j) {
  const int y = 2 * j + (LVL == 0 ? 1 : 0);
  const bool fine = is_fine(LVL, y);
  int lp = y, rp = y;
  float wl = 0.f, wr = 0.f;
  if (fine) lerp_rule(LVL, y, lp, rp, wl, wr);
  const int sl = 4 * xi + (lp >> 1), sr = 4 * xi + (rp >> 1);
  const bool r_own = (rp >> 1) == j;
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (!in_chain(LVL, z)) continue;
    const float l = LVL == 0 ? w.a[z] : __shfl_sync(FULL_MASK, w.a[z], sl);
    float r = __shfl_sync(FULL_MASK, LVL == 2 ? w.b[z] : w.a[z], sr);
    if (r_own) r = (rp & 1) ? w.b[z] : w.a[z];
    if (fine) {
      if (LVL == 0) w.b[z] = lerp2(wl, l, wr, r);
      else w.a[z] = lerp2(wl, l, wr, r);
    }
  }
}

// z pass of level LVL along one line.
template <int LVL>
__device__ __forceinline__ void zpass(float (&w)[8]) {
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (!is_fine(LVL, z)) continue;
    int lp, rp;
    float wl, wr;
    lerp_rule(LVL, z, lp, rp, wl, wr);
    w[z] = lerp2(wl, w[lp], wr, w[rp]);
  }
}

template <int LVL>
__device__ __forceinline__ void interp_level(Lines& w, int xi, int j) {
  xpass<LVL>(w, xi, j);
  ypass<LVL>(w, xi, j);
  zpass<LVL>(w.a);
  zpass<LVL>(w.b);
}

// Is (xi, y, z) a level-LVL coefficient? `in_xy` and `fine_xy`: xi and y
// both on the level's chain, and one of them fine.
template <int LVL>
__device__ __forceinline__ bool coeff_at(bool in_xy, bool fine_xy, int z) {
  return in_xy && in_chain(LVL, z) && (fine_xy || is_fine(LVL, z));
}

// Level LVL of the local decompose: v -= interpolant at the coefficients.
template <int LVL>
__device__ __forceinline__ void decompose_level(Lines& v, int xi, int j) {
  Lines w = v;
  interp_level<LVL>(w, xi, j);
  const bool ia = in_chain(LVL, xi) && in_chain(LVL, 2 * j);
  const bool ib = in_chain(LVL, xi) && in_chain(LVL, 2 * j + 1);
  const bool fa = is_fine(LVL, xi) || is_fine(LVL, 2 * j);
  const bool fb = is_fine(LVL, xi) || is_fine(LVL, 2 * j + 1);
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (coeff_at<LVL>(ia, fa, z)) v.a[z] = __fsub_rn(v.a[z], w.a[z]);
    if (coeff_at<LVL>(ib, fb, z)) v.b[z] = __fsub_rn(v.b[z], w.b[z]);
  }
}

// Level LVL of the local recompose: the interpolant of the level's coarse
// values (coefficients zeroed) is added back at the coefficients.
template <int LVL>
__device__ __forceinline__ void recompose_level(Lines& x, int xi, int j) {
  const bool ia = in_chain(LVL, xi) && in_chain(LVL, 2 * j);
  const bool ib = in_chain(LVL, xi) && in_chain(LVL, 2 * j + 1);
  const bool fa = is_fine(LVL, xi) || is_fine(LVL, 2 * j);
  const bool fb = is_fine(LVL, xi) || is_fine(LVL, 2 * j + 1);
  Lines y;
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    y.a[z] = coeff_at<LVL>(ia, fa, z) ? 0.f : x.a[z];
    y.b[z] = coeff_at<LVL>(ib, fb, z) ? 0.f : x.b[z];
  }
  interp_level<LVL>(y, xi, j);
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (coeff_at<LVL>(ia, fa, z)) x.a[z] = __fadd_rn(x.a[z], y.a[z]);
    if (coeff_at<LVL>(ib, fb, z)) x.b[z] = __fadd_rn(x.b[z], y.b[z]);
  }
}

// nl levels (1..3), finest first. Warp-uniform: every lane of the warp
// takes part (the passes shuffle).
__device__ __forceinline__ void decompose_lines(Lines& v, int xi, int j,
                                                int nl) {
  decompose_level<0>(v, xi, j);
  if (nl > 1) decompose_level<1>(v, xi, j);
  if (nl > 2) decompose_level<2>(v, xi, j);
}

__device__ __forceinline__ void recompose_lines(Lines& x, int xi, int j,
                                                int nl) {
  if (nl > 2) recompose_level<2>(x, xi, j);
  if (nl > 1) recompose_level<1>(x, xi, j);
  recompose_level<0>(x, xi, j);
}

}  // namespace
