// K9 bitplane_encode: the MDR sign-magnitude bitplane encoder of one
// float32 level, with its error-table partials.
//
// Replaces the TPU kernel mgard_tpu/mdr/bitplane.py::_encode_pallas_f32
// (body _enc_kernel_body). Plain version: encode_core_plain in
// mgard_tpu_torch/mdr/bitplane.py, whose planes and max partials it matches
// bit for bit and whose square-sum partials it matches up to float32
// summation order.
//
// The level is viewed as (32, m): element k*m + j sits in row k, column j.
// One thread owns column j. It loads its 32 values (coalesced across the
// warp for every k), quantizes each integer-exactly from the IEEE-754 bits
// (magnitude, residue remi * 2^-kc, sign), ORs the sign in at bit
// min(B, 31), and runs the 5-stage 32x32 register butterfly: word t of the
// result holds bit t of its 32 values, i.e. plane word j of bit t. It stores
// the words straight into plane order [sign, MSB..LSB]. Then for every
// b = 0..B it forms the residual d_b of its 32 values (the error of keeping
// b magnitude planes, in fixed-point units), keeps max |d_b| and the
// float32 sum of d_b^2 over them, and the warp reduces both with shuffles:
// one (B+1)-entry partial per warp, no atomics, so the tables come out the
// same on every run. The float32 square sums are a 32-term stage per column
// and a 32-term stage per warp, inside what _F32_SLACK_SQ covers; the
// caller finishes with a max and a float64 sum.
//
// What bounds it on the H100: at B = 32 it reads 4 bytes and writes 33/8
// bytes per element, and does about 6 float32 operations per element and
// table entry (33 entries), so operations and bytes take about the same
// time (chip_smoke.py states both). Integer work runs on uint32 (a signed
// shift that overflows is undefined); every shift count stays in [0, 31].
// nvcc runs with -fmad=false: d_b is one int-to-float conversion and one
// add, d_b^2 one multiply, as in the plain version.
#include "bits.cuh"
#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps per block
constexpr unsigned FULL = 0xFFFFFFFFu;

// _int_quantize_f32 + _residue_f32 for one value: p = |v| 2^(fb - exp) ->
// mag = round-half-away(p) clamped to lim, r = p - mag as float32. All
// integer steps modulo 2^32, as the int32 arithmetic they replace.
__device__ __forceinline__ void quantize(float v, int exp, int fb,
                                         unsigned lim, unsigned& mag,
                                         float& r, unsigned& sign) {
  const unsigned bits = __float_as_uint(v);
  sign = bits >> 31;
  const int ebits = (int)((bits >> 23) & 0xFFu);
  const unsigned mant = bits & 0x7FFFFFu;
  const unsigned mant24 = ebits == 0 ? mant : (mant | 0x800000u);
  const int e = ebits == 0 ? -126 : ebits - 127;
  const int sh = e - 23 + (fb - exp);
  const int shl = sh >= 0 ? min(sh, 31) : 0;
  const int kc = sh >= 0 ? 0 : min(-sh, 31);
  const unsigned half = (1u << kc) >> 1;
  const unsigned up = mant24 << shl;
  const unsigned f = sh >= 0 ? up : (mant24 + half) >> kc;
  mag = f > lim ? lim : f;
  const int remi = (int)(up - (mag << kc));
  r = __fmul_rn(__int2float_rn(remi), __int_as_float((127 - kc) << 23));
}

__global__ void __launch_bounds__(NT)
bitplane_encode_kernel(const float* __restrict__ v, const int* __restrict__ exp_p,
                       unsigned* __restrict__ planes, float* __restrict__ emax,
                       float* __restrict__ esq, long long m, int B) {
  const long long j = (long long)blockIdx.x * NT + threadIdx.x;
  if (j >= m) return;  // m % 32 == 0: whole warps only
  const int lane = threadIdx.x & 31;
  const int exp = *exp_p;
  const int sbit = B < 31 ? B : 31;
  const unsigned lim = (1u << (B - 1)) - 1u;
  unsigned z[32];
  unsigned fx[32];
  float r[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    unsigned sign;
    quantize(v[k * m + j], exp, B - 1, lim, fx[k], r[k], sign);
    z[k] = fx[k] | (sign << sbit);
  }
  bit_transpose<32>(z);
  // plane rows: row 0 = bit sbit (signs); row B - t = bit t below B; at
  // B = 32 row 1 (bit 31 of the magnitude) is identically zero
  if (B == 32) planes[m + j] = 0u;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (t == sbit)
      planes[j] = z[t];
    else if (t < B)
      planes[(long long)(B - t) * m + j] = z[t];
  }
  const long long w = j >> 5;
  for (int b = 0; b <= B; ++b) {
    const unsigned lowmask = b == 0 ? FULL : (1u << (B - b)) - 1u;
    const int halfv = (b >= 1 && b < B) ? 1 << (B - b - 1) : 0;
    float mx = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      float d;
      if (b == 0) {
        d = __fadd_rn(__int2float_rn((int)fx[k]), r[k]);
      } else {
        const unsigned low = fx[k] & lowmask;
        const int hb = fx[k] - low > 0u ? halfv : 0;
        d = __fadd_rn(__int2float_rn((int)low - hb), r[k]);
      }
      mx = fmaxf(mx, fabsf(d));
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      sq = __fadd_rn(sq, __shfl_xor_sync(FULL, sq, o));
    }
    if (lane == 0) {
      emax[w * (B + 1) + b] = mx;
      esq[w * (B + 1) + b] = sq;
    }
  }
}

}  // namespace

// v: (32*m,) float32, the level as its (32, m) view; exp: one int32 on the
// device (the level's exponent, so dispatch needs no host sync); planes:
// (B+1, m) u32 out; emax, esq: (m/32, B+1) float32 per-warp partials out.
// 1 <= B <= 32, m > 0 and a multiple of 32.
MGARD_EXPORT int bitplane_encode(const void* v, const void* exp, void* planes,
                                 void* emax, void* esq, long long m, int B,
                                 void* stream) {
  if (B < 1 || B > 32 || m <= 0 || m % 32) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((m + NT - 1) / NT);
  bitplane_encode_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const int*)exp, (unsigned*)planes, (float*)emax,
      (float*)esq, m, B);
  return mgard_launch_status();
}
