// The in-block 8-point chains of the hybrid front end, shared by K1/K4
// (hybrid_v2.cu), K10/K11 (hybrid_v3.cu) and K7/K8 (hybrid.cu): per axis
// 8 -> 5 -> 3 -> 2 over in-block positions {0..7} -> {0,2,4,6,7} -> {0,4,7}
// -> {0,7}; the quantizer (plain for K7, zigzagged for K1 and K10) and
// the remainder index of the z-grouped front ends (K1/K4, K10/K11). Every
// float operation is one rounded IEEE f32 operation in the order of the
// plain versions in ops/hybrid.py.
#pragma once

namespace {

// In-block position chains as bit masks over {0..7}: {0..7}, {0,2,4,6,7},
// {0,4,7}, {0,7}.
__device__ __forceinline__ unsigned chain_mask(int l) {
  return l == 0 ? 0xFFu : l == 1 ? 0xD5u : l == 2 ? 0x91u : 0x81u;
}

__device__ __forceinline__ bool in_chain(int l, int p) {
  return (chain_mask(l) >> p) & 1u;
}

// Level-lvl coefficient positions: fine on the level's chain, not coarse.
__device__ __forceinline__ bool is_fine(int lvl, int p) {
  return ((chain_mask(lvl) & ~chain_mask(lvl + 1)) >> p) & 1u;
}

// The lerp rule of a level-lvl coefficient position p: coarse neighbours
// (lp, rp) and float32 weights rounded from double exactly as the plain
// version rounds them (t = (p - lp) / (rp - lp)).
__device__ __forceinline__ void lerp_rule(int lvl, int p, int& lp, int& rp,
                                          float& wl, float& wr) {
  if (lvl == 0) {  // p in {1, 3, 5}
    lp = p - 1; rp = p + 1; wl = 0.5f; wr = 0.5f;
  } else if (lvl == 1) {
    if (p == 2) { lp = 0; rp = 4; wl = 0.5f; wr = 0.5f; }
    else { lp = 4; rp = 7; wl = (float)(1.0 - 2.0 / 3.0); wr = (float)(2.0 / 3.0); }
  } else {  // p == 4
    lp = 0; rp = 7; wl = (float)(1.0 - 4.0 / 7.0); wr = (float)(4.0 / 7.0);
  }
}

// Level-lvl 3D coefficient: in the level grid on every axis, fine on one.
// Position 0 is coarse at every level, so a 2D block seen as px = 0
// gives the 2D rule.
__device__ __forceinline__ bool coeff3(int lvl, int px, int py, int pz) {
  return in_chain(lvl, px) && in_chain(lvl, py) && in_chain(lvl, pz) &&
         (is_fine(lvl, px) || is_fine(lvl, py) || is_fine(lvl, pz));
}

// Index of corner position p among the remainder columns of chain nl.
__device__ __forceinline__ int rem_col(int nl, int p) {
  return __popc(chain_mask(nl) & ((1u << p) - 1u));
}

// Round half away from zero of val*inv_q (the flag-0 symbol, K7).
__device__ __forceinline__ int quantize_sym(float val, float inv_q) {
  const float t = __fmul_rn(val, inv_q);
  const float h = t < 0.f ? __fsub_rn(t, 0.5f) : __fadd_rn(t, 0.5f);
  return __float2int_rz(h);
}

// The symbol zigzagged (u32 bit pattern; K1, K10).
__device__ __forceinline__ unsigned quantize_zigzag(float val, float inv_q) {
  const int sym = quantize_sym(val, inv_q);
  return ((unsigned)sym << 1) ^ (unsigned)(sym >> 31);
}

// Dequantized value of a zigzag code.
__device__ __forceinline__ float unzigzag_dequantize(unsigned zz, float q) {
  const int sym = (int)(zz >> 1) ^ -(int)(zz & 1u);
  return __fmul_rn(__int2float_rn(sym), q);
}

// Flat index of corner (xi, yi, c) of z-block jz of the 8x8 (x, y) column
// at (x0, y0) in the compact remainder (RY, RZ: its two minor extents).
__device__ __forceinline__ size_t rem_index(int nl, int k, int RY, int RZ,
                                            int x0, int y0, int xi, int yi,
                                            int jz, int c) {
  return ((size_t)((x0 >> 3) * k + rem_col(nl, xi)) * RY + (y0 >> 3) * k +
          rem_col(nl, yi)) * RZ + jz * k + rem_col(nl, c);
}

}  // namespace
