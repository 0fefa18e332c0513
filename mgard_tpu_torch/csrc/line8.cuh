// The 8^3 local stencil of the hybrid front end on z lines held in
// registers (K1/K4, hybrid_v2.cu; K10/K11, hybrid_v3.cu; K7/K8,
// hybrid.cu). One warp holds one 8^3 block: lane 4*xi + j holds the two z
// lines (xi, y = 2j) ("a") and (xi, y = 2j + 1) ("b"), eight values each.
// Without the x pass (XP = false: K7/K8 on a 2D field) the warp holds
// eight 8x8 (y, z) blocks instead, lane 4*b + j the lines 2j and 2j + 1 of
// block b: the rules read position 0 on the missing axis, which is coarse
// at every level, and the y pass shuffles only within the lanes 4*b..4*b+3
// of the lane's own block. Every level-axis interpolation pass of the plain
// version (ops/hybrid.py::_interp_pass) becomes
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

template <int LVL, bool XP>
__device__ __forceinline__ void interp_level(Lines& w, int xi, int j) {
  if (XP) xpass<LVL>(w, xi, j);
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
// The rules read x position px: the lane's xi, or 0 without the x pass.
template <int LVL, bool XP>
__device__ __forceinline__ void decompose_level(Lines& v, int xi, int j) {
  Lines w = v;
  interp_level<LVL, XP>(w, xi, j);
  const int px = XP ? xi : 0;
  const bool ia = in_chain(LVL, px) && in_chain(LVL, 2 * j);
  const bool ib = in_chain(LVL, px) && in_chain(LVL, 2 * j + 1);
  const bool fa = is_fine(LVL, px) || is_fine(LVL, 2 * j);
  const bool fb = is_fine(LVL, px) || is_fine(LVL, 2 * j + 1);
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (coeff_at<LVL>(ia, fa, z)) v.a[z] = __fsub_rn(v.a[z], w.a[z]);
    if (coeff_at<LVL>(ib, fb, z)) v.b[z] = __fsub_rn(v.b[z], w.b[z]);
  }
}

// Level LVL of the local recompose: the interpolant of the level's coarse
// values (coefficients zeroed) is added back at the coefficients.
template <int LVL, bool XP>
__device__ __forceinline__ void recompose_level(Lines& x, int xi, int j) {
  const int px = XP ? xi : 0;
  const bool ia = in_chain(LVL, px) && in_chain(LVL, 2 * j);
  const bool ib = in_chain(LVL, px) && in_chain(LVL, 2 * j + 1);
  const bool fa = is_fine(LVL, px) || is_fine(LVL, 2 * j);
  const bool fb = is_fine(LVL, px) || is_fine(LVL, 2 * j + 1);
  Lines y;
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    y.a[z] = coeff_at<LVL>(ia, fa, z) ? 0.f : x.a[z];
    y.b[z] = coeff_at<LVL>(ib, fb, z) ? 0.f : x.b[z];
  }
  interp_level<LVL, XP>(y, xi, j);
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    if (coeff_at<LVL>(ia, fa, z)) x.a[z] = __fadd_rn(x.a[z], y.a[z]);
    if (coeff_at<LVL>(ib, fb, z)) x.b[z] = __fadd_rn(x.b[z], y.b[z]);
  }
}

// nl levels (1..3), finest first. Warp-uniform: every lane of the warp
// takes part (the passes shuffle).
template <bool XP = true>
__device__ __forceinline__ void decompose_lines(Lines& v, int xi, int j,
                                                int nl) {
  decompose_level<0, XP>(v, xi, j);
  if (nl > 1) decompose_level<1, XP>(v, xi, j);
  if (nl > 2) decompose_level<2, XP>(v, xi, j);
}

template <bool XP = true>
__device__ __forceinline__ void recompose_lines(Lines& x, int xi, int j,
                                                int nl) {
  if (nl > 2) recompose_level<2, XP>(x, xi, j);
  if (nl > 1) recompose_level<1, XP>(x, xi, j);
  recompose_level<0, XP>(x, xi, j);
}

// Loads and stores around the line walk. A thread block owns the 8x8 (x,
// y) column of 8-blocks at (x0, y0); its tile line 8*xi + y is the field
// row (x0 + xi, y0 + y), whose element base row_of gives.
__device__ __forceinline__ size_t row_of(int x0, int y0, int Y, int Z,
                                         int line) {
  return ((size_t)(x0 + (line >> 3)) * Y + y0 + (line & 7)) * Z;
}

// The 8 floats (32 bytes, 16-byte aligned) of one line of one 8^3 block.
__device__ __forceinline__ void load_line(const float* p, float (&l)[8]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + 1);
  l[0] = u.x; l[1] = u.y; l[2] = u.z; l[3] = u.w;
  l[4] = v.x; l[5] = v.y; l[6] = v.z; l[7] = v.w;
}

// Forward epilogue of one line (K1, K10): its corners (if `corner`, at the
// chain positions in cmask) to rem_at[0..k), every other value quantized
// and zigzagged into zz (a corner's code is 0, as in the plain version).
__device__ __forceinline__ void line_codes(const float (&l)[8], bool corner,
                                           unsigned cmask, float inv_q,
                                           float* rem_at, unsigned (&zz)[8]) {
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    const bool c = corner && ((cmask >> z) & 1u);
    zz[z] = c ? 0u : quantize_zigzag(l[z], inv_q);
    if (c) rem_at[__popc(cmask & ((1u << z) - 1u))] = l[z];
  }
}

// Forward epilogue of one flag-0 line (K7): as line_codes, with the plain
// symbols in natural order (a corner's symbol is 0).
__device__ __forceinline__ void line_syms(const float (&l)[8], bool corner,
                                          unsigned cmask, float inv_q,
                                          float* rem_at, int (&s)[8]) {
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    const bool c = corner && ((cmask >> z) & 1u);
    s[z] = c ? 0 : quantize_sym(l[z], inv_q);
    if (c) rem_at[__popc(cmask & ((1u << z) - 1u))] = l[z];
  }
}

// Inverse prologue of one line (K4, K11, K8): its corner values from
// rem_at[0..k) (if `corner`), 0 elsewhere.
__device__ __forceinline__ void line_corners(const float* rem_at, bool corner,
                                             unsigned cmask, float (&cr)[8]) {
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    const bool on = corner && ((cmask >> z) & 1u);
    cr[z] = on ? __ldg(rem_at + __popc(cmask & ((1u << z) - 1u))) : 0.f;
  }
}

// An output tile (K4, K11, K7, K8: NB z-blocks, warp w holding z-block
// w) leaves through shared memory ob (64 lines of 2*NB float4s) so that a
// warp stores whole rows of 8*NB floats: 16-byte chunk q of line L sits at
// q ^ (L/2 mod 8), which spreads a warp's writes (lines 2*lane, chunks
// 2*warp and 2*warp + 1) over all banks. The caller synchronizes between
// stage_tile and store_tile, and before ob is staged again.
template <int NB>
__device__ __forceinline__ void stage_tile(float4* ob, const Lines& l,
                                           int warp, int lane) {
  constexpr int CH = 2 * NB;
  const int sw = lane & 7;
  float4* oa = ob + (2 * lane) * CH;
  oa[(2 * warp) ^ sw] = make_float4(l.a[0], l.a[1], l.a[2], l.a[3]);
  oa[(2 * warp + 1) ^ sw] = make_float4(l.a[4], l.a[5], l.a[6], l.a[7]);
  oa[CH + ((2 * warp) ^ sw)] = make_float4(l.b[0], l.b[1], l.b[2], l.b[3]);
  oa[CH + ((2 * warp + 1) ^ sw)] = make_float4(l.b[4], l.b[5], l.b[6], l.b[7]);
}

// The staged tile to out, which points at line 0's first element of the
// tile; streaming stores (the field is not read again).
template <int NB>
__device__ __forceinline__ void store_tile(const float4* ob, float* out,
                                           int Y, int Z) {
  constexpr int CH = 2 * NB, NT = 32 * NB;
#pragma unroll
  for (int i = 0; i < 64 * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT, L = e / CH, c = e % CH;
    __stcs(reinterpret_cast<float4*>(
               out + ((size_t)(L >> 3) * Y + (L & 7)) * Z) + c,
           ob[L * CH + (c ^ ((L >> 1) & 7))]);
  }
}

}  // namespace
