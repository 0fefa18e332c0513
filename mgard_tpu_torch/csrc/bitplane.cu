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
// A block of NW = 4 warps owns the 32 columns [32*blk, 32*blk + 32), which
// are one partial of the tables (the plain version's group of 32 columns);
// lane l works on column j = 32*blk + l throughout.
//
// Phase A: warp w loads rows [8w, 8w + 8) of the block (a 128-byte warp
// row each, all eight loads in flight before the first quantize),
// quantizes each value integer-exactly from its IEEE-754 bits (magnitude
// fx, residue r = remi * 2^-kc, sign) and writes one 16-byte slot
// data[k][l] = (fx, sm, r, float(fx)), with sm = 2^floor(log2 fx) - 1 (0 for
// fx = 0) the bits below fx's top bit, and one word zs[k][l] = fx | sign <<
// min(B, 31). One barrier. Warp 0 then reads its column's 32 words back,
// runs the 5-stage 32x32 register butterfly of bits.cuh (word t holds bit t
// of the column, plane word j of bit t) and stores the words into plane
// order [sign, MSB..LSB], whole warp rows, walking one row pointer.
//
// Phase B: warp w takes entry chunk (w + 1) % NW of the B+1 table entries
// for the block's 32 columns. Entry b keeps b magnitude planes; with
// s = B - b its residual is
//   d_b = float(low - hb) + r,  low = fx mod 2^s,
//   hb = 2^(s-1) if fx >= 2^s (some kept plane is set) else 0,
// (d_0 = float(fx) + r, and d_B = 0 + r). fx >= 2^s holds exactly when sm
// has bit s-1, so hb = sm & 2^(s-1): no compare and no select. For s <= 23
// (every entry below B = 24, entries b >= B - 23 above) low < 2^23, and
//   float(low - hb) = as_float(low | 0x4B000000) - as_float(hb | 0x4B000000)
// exactly (both lie in [2^23, 2^24), where the float32 grid is the
// integers, so the difference is exact): two LOP3 and one FADD in place of
// a subtract and a conversion. The other entries (s >= 24: b <= B - 24, at
// most 9, all in chunk 0) convert with __int2float_rn as the plain version
// does. An entry then costs six instructions per element (LOP3, LOP3,
// FADD, FADD, FMNMX, FFMA), seven with the conversion, where one thread a
// column took about eleven and a dozen branches and shuffles. The lane
// walks its column's 32 slots (one 16-byte shared load each, two slots a
// trip) and keeps max |d_b| and sum d_b^2 for the chunk's entries in
// registers; the square is one __fmaf_rn(d, d, sq), one rounding in place
// of two, so at least as exact as the plain version's multiply and add.
// Chunks: with G = max(0, B - 23) converted entries, chunk 0 is [0, G) and
// chunks 1-3 take 8 of the 24 others each; below B = 24 the four chunks
// split [0, B] evenly. No chunk holds more than 9 entries, and each is run
// by a template of its size and kind, so the entry masks are registers and
// no entry branches.
//
// Fold: every lane writes its chunk's column partials to its warp's rows of
// shared memory (pitch 33, free of bank conflicts), and lane i of the warp
// folds row i over the 32 columns in order (a max, or a float32 sum), then
// writes the partial (blk, b): one partial per 32 columns, each written
// once, no atomics, the same tables on every run. The float32 square sums
// are a 32-term stage per column and a 32-term stage per 32 columns, as
// _F32_SLACK_SQ covers; the caller finishes with a max and a float64 sum.
//
// What bounds it on the H100: instruction issue, not bytes. At B = 32 it
// reads 4 bytes and writes 33/8 bytes per element (0.120 ms of bytes at the
// 384^3 finest level, 49,479,680 elements, at 3.35 TB/s). Read off its SASS
// it issues 286 lane instructions per element there (219 in the entry
// loops, 42 to quantize, 25 in warp 0's butterfly and stores), an
// issue floor of 0.42 ms at one warp instruction a clock per SM
// sub-partition (33.5 T lane instructions/s at 1.98 GHz); the design it
// replaces issued 539 (a floor of 0.80 ms). Measured on one NVIDIA H100
// 80GB HBM3 at 700.00 W (CUDA-graph replays of the C entry point,
// scripts/h100_bitplane_variants.py): 0.57 ms at that level against 0.97
// for the one-thread-a-column design, and 0.0046-0.0048 ms at the 131,072-
// element coarsest level against 0.035 (four warps a column fill the card
// where one thread's 33-entry chain ran alone). Variants there, each
// slower than this design: every entry converting 9%, a multiply and add
// for the square 8%, the fold by warp shuffles 4%, the slot walk unrolled
// by 1 or 4 in place of 2 9% and 14%, warp 0 (which also stores the
// planes) given 6 entries and warps 1-2 9 each 7%, no register cap 1.5%.
// Integer work runs on uint32 (a signed shift that overflows is undefined);
// every shift count stays in [0, 31]. nvcc runs with -fmad=false: the only
// fused multiply-add is the explicit one.
#include "bits.cuh"
#include "common.cuh"

namespace {

constexpr int NW = 4;             // warps a block, entry chunks a column
constexpr int NT = NW * 32;       // threads a block
constexpr int MIN_BLOCKS = 7;     // blocks an SM (29,984 B of shared each)
constexpr int MAGIC_MAX_S = 23;   // entries with s <= 23 skip the conversion
constexpr int MAX_CHUNK = 9;      // entries a chunk holds at most
constexpr int PITCH = 33;         // words a fold row (conflict-free)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned MAGIC = 0x4B000000u;  // 2^23 as float32 bits

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

// The entries [b0, b0 + N) of one column: N maxima and square sums over
// its 32 slots (stride 32 uint4 in the block's data). GENERAL chunks start
// at b0 = 0 and convert with __int2float_rn; the others take the exact
// 2^23-offset difference (every s <= MAGIC_MAX_S).
template <bool GENERAL, int N>
__device__ __forceinline__ void chunk(const uint4* __restrict__ col, int b0,
                                      int B, float* mx, float* sq) {
  unsigned mask[N], half[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int b = b0 + i, s = B - b;
    mask[i] = b == 0 ? FULL : (1u << s) - 1u;
    half[i] = (b >= 1 && b < B) ? 1u << (s - 1) : 0u;
    mx[i] = 0.f;
    sq[i] = 0.f;
  }
#pragma unroll 2
  for (int k = 0; k < 32; ++k) {
    const uint4 e = col[k * 32];  // fx, sm, r, float(fx)
    const float r = __uint_as_float(e.z);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float d;
      if (GENERAL && i == 0) {
        d = __fadd_rn(__uint_as_float(e.w), r);  // b = 0
      } else if (GENERAL) {
        const int x = (int)((e.x & mask[i]) - (e.y & half[i]));
        d = __fadd_rn(__int2float_rn(x), r);
      } else {
        const float lo = __uint_as_float((e.x & mask[i]) | MAGIC);
        const float hb = __uint_as_float((e.y & half[i]) | MAGIC);
        d = __fadd_rn(__fsub_rn(lo, hb), r);
      }
      mx[i] = fmaxf(mx[i], fabsf(d));
      sq[i] = __fmaf_rn(d, d, sq[i]);
    }
  }
}

template <bool GENERAL>
__device__ __forceinline__ void run_chunk(const uint4* col, int b0, int n,
                                          int B, float* mx, float* sq) {
  switch (n) {
    case 1: chunk<GENERAL, 1>(col, b0, B, mx, sq); break;
    case 2: chunk<GENERAL, 2>(col, b0, B, mx, sq); break;
    case 3: chunk<GENERAL, 3>(col, b0, B, mx, sq); break;
    case 4: chunk<GENERAL, 4>(col, b0, B, mx, sq); break;
    case 5: chunk<GENERAL, 5>(col, b0, B, mx, sq); break;
    case 6: chunk<GENERAL, 6>(col, b0, B, mx, sq); break;
    case 7: chunk<GENERAL, 7>(col, b0, B, mx, sq); break;
    case 8: chunk<GENERAL, 8>(col, b0, B, mx, sq); break;
    case 9: chunk<GENERAL, 9>(col, b0, B, mx, sq); break;
    default: break;
  }
}

// Entry chunk c of NW for a given B: its first entry, its size, and whether
// it converts. Above B = MAGIC_MAX_S chunk 0 converts the G = B - 23
// entries with s >= 24 and chunks 1-3 take 8 of the 24 others each;
// below, the four chunks split [0, B] evenly.
__device__ __forceinline__ void chunk_of(int c, int B, int& b0, int& n,
                                         bool& general) {
  const int G = B > MAGIC_MAX_S ? B - MAGIC_MAX_S : 0;
  general = G > 0 && c == 0;
  if (general) {
    b0 = 0;
    n = G;
  } else if (G > 0) {
    b0 = G + (c - 1) * ((MAGIC_MAX_S + 1) / 3);
    n = (MAGIC_MAX_S + 1) / 3;
  } else {
    b0 = c * (B + 1) / NW;
    n = (c + 1) * (B + 1) / NW - b0;
  }
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
bitplane_encode_kernel(const float* __restrict__ v, const int* __restrict__ exp_p,
                       unsigned* __restrict__ planes, float* __restrict__ emax,
                       float* __restrict__ esq, long long m, int B) {
  __shared__ uint4 data[32 * 32];     // [k][lane]
  __shared__ unsigned zs[32 * 32];    // [k][lane]
  __shared__ float fold[NW][2 * MAX_CHUNK][PITCH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long blk = blockIdx.x;
  const long long j = blk * 32 + lane;
  const int sbit = B < 31 ? B : 31;
  {
    // warp w quantizes rows [8w, 8w + 8) of the block's columns, its
    // eight loads in flight before the first quantize
    const int exp = *exp_p;
    const unsigned lim = (1u << (B - 1)) - 1u;
    float x[32 / NW];
#pragma unroll
    for (int u = 0; u < 32 / NW; ++u)
      x[u] = v[(warp * (32 / NW) + u) * m + j];
#pragma unroll
    for (int u = 0; u < 32 / NW; ++u) {
      const int k = warp * (32 / NW) + u;
      unsigned fx, sign;
      float r;
      quantize(x[u], exp, B - 1, lim, fx, r, sign);
      const unsigned sm = __funnelshift_rc(0x7FFFFFFFu, 0u, __clz((int)fx));
      const float fxf = __int2float_rn((int)fx);
      data[k * 32 + lane] =
          make_uint4(fx, sm, __float_as_uint(r), __float_as_uint(fxf));
      zs[k * 32 + lane] = fx | (sign << sbit);
    }
  }
  __syncthreads();
  if (warp == 0) {
    unsigned z[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) z[k] = zs[k * 32 + lane];
    bit_transpose<32>(z);
    // plane rows: row 0 = bit sbit (signs); row B - t = bit t < min(B, 31),
    // walked upwards by one pointer; at B = 32 row 1 (bit 31 of the
    // magnitude) is identically zero
    unsigned* row = planes + (long long)B * m + j;
#pragma unroll
    for (int t = 0; t < 31; ++t) {
      if (t < B) {
        *row = z[t];
        row -= m;
      }
    }
    if (B == 32) *row = 0u;
#pragma unroll
    for (int t = 1; t < 32; ++t)
      if (t == sbit) planes[j] = z[t];
  }
  int b0, n;
  bool general;
  chunk_of((warp + 1) % NW, B, b0, n, general);
  if (n == 0) return;
  float mx[MAX_CHUNK], sq[MAX_CHUNK];
  if (general)
    run_chunk<true>(data + lane, b0, n, B, mx, sq);
  else
    run_chunk<false>(data + lane, b0, n, B, mx, sq);
  float(*rows)[PITCH] = fold[warp];
#pragma unroll
  for (int i = 0; i < MAX_CHUNK; ++i) {
    if (i < n) {
      rows[2 * i][lane] = mx[i];
      rows[2 * i + 1][lane] = sq[i];
    }
  }
  __syncwarp();
  if (lane < 2 * n) {
    float acc = 0.f;
    if (lane & 1) {
      for (int c = 0; c < 32; ++c) acc = __fadd_rn(acc, rows[lane][c]);
      esq[blk * (B + 1) + b0 + (lane >> 1)] = acc;
    } else {
      for (int c = 0; c < 32; ++c) acc = fmaxf(acc, rows[lane][c]);
      emax[blk * (B + 1) + b0 + (lane >> 1)] = acc;
    }
  }
}

}  // namespace

// v: (32*m,) float32, the level as its (32, m) view; exp: one int32 on the
// device (the level's exponent, so dispatch needs no host sync); planes:
// (B+1, m) u32 out; emax, esq: (m/32, B+1) float32 partials out, one per
// 32 columns. 1 <= B <= 32, m > 0 and a multiple of 32.
MGARD_EXPORT int bitplane_encode(const void* v, const void* exp, void* planes,
                                 void* emax, void* esq, long long m, int B,
                                 void* stream) {
  if (B < 1 || B > 32 || m <= 0 || m % 32) return (int)cudaErrorInvalidValue;
  bitplane_encode_kernel<<<(unsigned)(m / 32), NT, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const int*)exp, (unsigned*)planes, (float*)emax,
      (float*)esq, m, B);
  return mgard_launch_status();
}
