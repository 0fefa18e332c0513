// Register bit-matrix transposes of the packers: K2/K3 (bfp.cu) and K9
// (bitplane.cu).
#pragma once

// Self-inverse bit-matrix transpose of z by a log2(N)-step butterfly.
// N = 32: bit k of output word t == bit t of input word k. N = 16: the
// 16x16 transpose of both 16-bit halves at once (each mask repeats per
// half, so no shift crosses them): with z[k] = a_k | b_k << 16, bit k of
// the low half of output word t is bit t of a_k, and of the high half bit
// t of b_k. The butterfly of lossless/bfx.py _bit_transpose32.
template <int N>
__device__ __forceinline__ void bit_transpose(unsigned (&z)[N]) {
  static_assert(N == 16 || N == 32, "N is 16 (paired halves) or 32");
#pragma unroll
  for (int st = 0; st < (N == 32 ? 5 : 4); ++st) {
    const int s = (N / 2) >> st;
    const unsigned mk = s == 16  ? 0x0000FFFFu
                        : s == 8 ? 0x00FF00FFu
                        : s == 4 ? 0x0F0F0F0Fu
                        : s == 2 ? 0x33333333u
                                 : 0x55555555u;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i & s) == 0) {
        const unsigned t = ((z[i] >> s) ^ z[i + s]) & mk;
        z[i] ^= t << s;
        z[i + s] ^= t;
      }
    }
  }
}
