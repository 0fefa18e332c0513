// K2 bfp_encode and K3 bfp_decode: the banded BFP5 bit packer and unpacker.
//
// Replaces the TPU kernels mgard_tpu/lossless/bfp.py::_encode_pallas (body
// _enc_kernel) and ::_decode_pallas (body _dec_kernel). Plain versions:
// encode_bands_plain and decode_bands_plain in
// mgard_tpu_torch/lossless/bfp.py, which the kernels match word for word.
//
// What bounds them on the H100: memory. K2 reads 2 or 4 bytes per symbol and
// writes (K+E)/32 of a word; K3 the reverse. The bit transpose is ~250 lane
// operations per 32-symbol block (u16 rows; ~500 for u32), far under the
// bytes.
//
// Design: a thread per 32-symbol block, owning one (superblock s, sorted
// column cs, slot b). The 32 lanes of a warp hold 32 consecutive cs at the
// same (s, b), and the warps of a thread block walk b fastest, so a thread
// block reads whole chunk rows. For every plane the warp stores one
// contiguous 128-byte row: base plane j < K at base[s, j, b, cs..cs+31],
// residual plane K+j at words cs..cs+31 of band (sb_off[s] + woff[s, j] +
// b*rband[s, j]) * 128, only where cs < rband*128; that is a multiple of 32,
// so a whole warp stores or skips a band row together. Each thread needs its
// block of the chunk that sorts to column cs, inv[s, cs] (the inverse of
// rank, made by a first small kernel into the caller's scratch: one 4-byte
// read and write per chunk): 64 bytes (u16) or 128 (u32). Neighbouring
// lanes want different chunks, so the warp loads whole blocks, 4 or 8 lanes
// a block with 16-byte vector loads (every sector it touches is read whole),
// into a 2 or 4 KB staging area in shared memory, from which each thread
// takes its own. The transpose is a register butterfly (bits.cuh): for u16
// rows the 16x16 butterfly on registers holding symbols k | k+16 << 16 gives
// planes 0-15 (planes 16 and up of a u16 row are zero words); u32 rows take
// the full 32x32. K3 is the mirror: row loads of the K base and E residual
// words (a word at cs >= cnt[s, j] reads as 0), the same self-inverse
// butterfly, and the 32 symbols staged so that each store instruction
// writes whole blocks of chunk rows inv[cs], slot b, in natural order.
// Without staging, each lane's 16-byte stores at a chunk-row stride leave
// every sector they touch half written: on the H100 staging halves K3's
// time at the main path's shapes (PERF.md) and trims K2's by 5-10%.
//
// The TPU kernel OR-merged full-band windows that spill into the next band
// and the next superblock, which is deterministic only on its in-order grid;
// CUDA blocks run concurrently. By the sorted-prefix invariant every word
// past cnt_j is zero, so each band word cs < rband*128, and every base word
// when K > 0, is written exactly once, by exactly one thread, with no OR and
// no spill.
#include "bits.cuh"
#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps per block
constexpr int LANES = 128;

// inv[s, rank[s, c]] = c: the natural chunk of each sorted column. rank is
// the sort plan's permutation; this guard and the clamp in owner() keep the
// accesses of any other rank inside the superblock.
__global__ void __launch_bounds__(NT)
invert_rank_kernel(const int* __restrict__ rank, int* __restrict__ inv,
                   long long NC, int sbc) {
  const long long c = (long long)blockIdx.x * NT + threadIdx.x;
  if (c >= NC) return;
  const long long s0 = c / sbc * sbc;
  const int r = rank[c];
  if ((unsigned)r < (unsigned)sbc) inv[s0 + r] = (int)(c - s0);
}

// The block a thread owns, and the natural chunk that sorts to its column.
struct Owner {
  long long s;
  int cs, b, c;
};

__device__ __forceinline__ Owner owner(long long t, const int* inv, int C,
                                       int sbc) {
  const long long w = t >> 5, q = w / C;
  const int tiles = sbc >> 5;
  Owner o;
  o.b = (int)(w - q * C);
  o.s = q / tiles;
  o.cs = (int)(q - o.s * tiles) * 32 + (int)(t & 31);
  o.c = (int)min((unsigned)inv[o.s * sbc + o.cs], (unsigned)(sbc - 1));
  return o;
}

// Planes in registers: u16 rows pair symbols k and k+16 in one word.
template <typename T>
constexpr int kPlanes = sizeof(T) == 2 ? 16 : 32;

constexpr unsigned FULL = 0xFFFFFFFFu;

// Slot of quad q (16 bytes) of lane l's block in its warp's staging area:
// quad-major, the lane permuted by q, so that a pass over one quad of all
// lanes and a pass over all quads of two (u16) or one (u32) blocks per 8
// lanes both hit distinct banks.
template <int N>
__device__ __forceinline__ int slot(int q, int lane) {
  return q * 32 + (lane ^ (q * (32 / N)));
}

// The N words of this lane's block, chunk c at the warp's slot (blk0 is
// chunk 0's block, stride a chunk row), through the warp's staging area st:
// each load instruction reads whole blocks, N/4 lanes a block, so every
// 32-byte sector it touches is read whole.
template <int N, typename T>
__device__ __forceinline__ void load_words(const T* blk0, long long stride,
                                           int c, uint4* st,
                                           unsigned (&v)[N]) {
  constexpr int QB = N / 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    const int src = i * (32 / QB) + lane / QB, q = lane % QB;
    const int cs = __shfl_sync(FULL, c, src);
    st[slot<N>(q, src)] =
        __ldg(reinterpret_cast<const uint4*>(blk0 + cs * stride) + q);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const uint4 x = st[slot<N>(q, lane)];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// The mirror of load_words: each store instruction writes whole blocks.
template <int N, typename T>
__device__ __forceinline__ void store_words(T* blk0, long long stride, int c,
                                            uint4* st,
                                            const unsigned (&v)[N]) {
  constexpr int QB = N / 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < QB; ++q)
    st[slot<N>(q, lane)] =
        make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < QB; ++i) {
    const int src = i * (32 / QB) + lane / QB, q = lane % QB;
    const int cs = __shfl_sync(FULL, c, src);
    reinterpret_cast<uint4*>(blk0 + cs * stride)[q] = st[slot<N>(q, src)];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
bfp_encode_kernel(const T* __restrict__ rows, const int* __restrict__ inv,
                  const int* __restrict__ woff, const int* __restrict__ rband,
                  const int* __restrict__ sb_off, unsigned* __restrict__ base,
                  unsigned* __restrict__ resid, long long NB, int C, int sbc,
                  int K, int E) {
  constexpr int N = kPlanes<T>;
  __shared__ uint4 stage[NT / 32 * 8 * N];  // 8N quads a warp
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= NB) return;  // NB is a multiple of 32: whole warps
  const Owner o = owner(t, inv, C, sbc);
  const T* blk0 = rows + (o.s * sbc * C + o.b) * 32;
  uint4* st = stage + (threadIdx.x >> 5) * 8 * N;
  unsigned z[N];
  if constexpr (N == 16) {
    unsigned w[16];  // words 0-7: symbols 0-15, words 8-15: symbols 16-31
    load_words<16>(blk0, (long long)C * 32, o.c, st, w);
#pragma unroll
    for (int k = 0; k < 16; ++k)  // symbol k | symbol k+16 << 16
      z[k] = __byte_perm(w[k >> 1], w[8 + (k >> 1)],
                         k & 1 ? 0x7632 : 0x5410);
  } else {
    load_words<32>(blk0, (long long)C * 32, o.c, st, z);
  }
  bit_transpose<N>(z);  // z[j] = plane j
  const int Kp = K > 0 ? K : 1;
  const long long plane = (long long)C * sbc;
  unsigned* bdst = base + (o.s * Kp * C + o.b) * (long long)sbc + o.cs;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= K + E) break;
    const unsigned word = j < N ? z[j & (N - 1)] : 0u;
    if (j < K) {
      bdst[j * plane] = word;
    } else {
      const long long p = o.s * E + (j - K);
      const int rb = rband[p];
      if (o.cs < rb * LANES)
        resid[((long long)sb_off[o.s] + woff[p] + (long long)o.b * rb) *
                  LANES + o.cs] = word;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
bfp_decode_kernel(const unsigned* __restrict__ base,
                  const unsigned* __restrict__ resid,
                  const int* __restrict__ inv, const int* __restrict__ woff,
                  const int* __restrict__ rband,
                  const int* __restrict__ sb_off, const int* __restrict__ cnt,
                  T* __restrict__ out, long long NB, int C, int sbc, int K,
                  int E) {
  constexpr int N = kPlanes<T>;
  __shared__ uint4 stage[NT / 32 * 8 * N];  // 8N quads a warp
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= NB) return;
  const Owner o = owner(t, inv, C, sbc);
  const int Kp = K > 0 ? K : 1;
  const long long plane = (long long)C * sbc;
  const unsigned* bsrc = base + (o.s * Kp * C + o.b) * (long long)sbc + o.cs;
  unsigned z[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    unsigned word = 0u;
    if (j < K) {
      word = __ldg(bsrc + j * plane);
    } else if (j < K + E) {
      const long long p = o.s * E + (j - K);
      // columns at or past cnt_j hold no plane-j word of this superblock
      if (o.cs < cnt[p])
        word = __ldg(resid + ((long long)sb_off[o.s] + woff[p] +
                              (long long)o.b * rband[p]) * LANES + o.cs);
    }
    z[j] = word;
  }
  bit_transpose<N>(z);  // symbol k (u32), symbols k | k+16 << 16 (u16)
  T* blk0 = out + (o.s * sbc * C + o.b) * 32;
  uint4* st = stage + (threadIdx.x >> 5) * 8 * N;
  if constexpr (N == 16) {
    unsigned w[16];  // words 0-7: symbols 0-15, words 8-15: symbols 16-31
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = __byte_perm(z[2 * i], z[2 * i + 1], 0x5410);
      w[8 + i] = __byte_perm(z[2 * i], z[2 * i + 1], 0x7632);
    }
    store_words<16>(blk0, (long long)C * 32, o.c, st, w);
  } else {
    store_words<32>(blk0, (long long)C * 32, o.c, st, z);
  }
}

inline unsigned grid_for(long long n) {
  return (unsigned)((n + NT - 1) / NT);
}

// Geometry the kernels rely on: whole 32-column tiles, K + E <= 32.
inline bool bad_geometry(long long NB, int C, int sbc, int K, int E) {
  return K < 0 || E < 1 || K + E > 32 || NB <= 0 || C < 1 || sbc <= 0 ||
         sbc % 32 || NB % ((long long)C * sbc);
}

// The first launch of both entry points: inv from rank.
int invert_rank(const void* rank, void* inv, long long NC, int sbc,
                cudaStream_t st) {
  invert_rank_kernel<<<grid_for(NC), NT, 0, st>>>((const int*)rank,
                                                  (int*)inv, NC, sbc);
  return mgard_launch_status();
}

}  // namespace

// rows: (NB/C, 32*C) zigzag symbols in natural chunk order, u16 (wide = 0)
// or u32 (wide = 1), 16-byte aligned; rank: (NB/C,) sorted column of each
// chunk within its superblock; inv: scratch of rank's size; woff, rband:
// (NSB, E); sb_off: (NSB,); base: (NSB, max(K,1), C, sbc), every word
// written when K > 0; resid: the zero-filled band buffer. K + E <= 32.
MGARD_EXPORT int bfp_encode(const void* rows, int wide, const void* rank,
                            void* inv, const void* woff, const void* rband,
                            const void* sb_off, void* base, void* resid,
                            long long NB, int C, int sbc, int K, int E,
                            void* stream) {
  if (bad_geometry(NB, C, sbc, K, E)) return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(rows)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = invert_rank(rank, inv, NB / C, sbc, st);
  if (rc) return rc;
  if (wide)
    bfp_encode_kernel<uint32_t><<<grid_for(NB), NT, 0, st>>>(
        (const uint32_t*)rows, (const int*)inv, (const int*)woff,
        (const int*)rband, (const int*)sb_off, (unsigned*)base,
        (unsigned*)resid, NB, C, sbc, K, E);
  else
    bfp_encode_kernel<uint16_t><<<grid_for(NB), NT, 0, st>>>(
        (const uint16_t*)rows, (const int*)inv, (const int*)woff,
        (const int*)rband, (const int*)sb_off, (unsigned*)base,
        (unsigned*)resid, NB, C, sbc, K, E);
  return mgard_launch_status();
}

// The mirror of bfp_encode; cnt: (NSB, E) valid words per plane. Writes
// natural-order zigzag rows, u16 (wide = 0) or u32 (wide = 1), to out,
// which must be 16-byte aligned.
MGARD_EXPORT int bfp_decode(const void* base, const void* resid,
                            const void* rank, void* inv, const void* woff,
                            const void* rband, const void* sb_off,
                            const void* cnt, void* out, int wide, long long NB,
                            int C, int sbc, int K, int E, void* stream) {
  if (bad_geometry(NB, C, sbc, K, E)) return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = invert_rank(rank, inv, NB / C, sbc, st);
  if (rc) return rc;
  if (wide)
    bfp_decode_kernel<uint32_t><<<grid_for(NB), NT, 0, st>>>(
        (const unsigned*)base, (const unsigned*)resid, (const int*)inv,
        (const int*)woff, (const int*)rband, (const int*)sb_off,
        (const int*)cnt, (uint32_t*)out, NB, C, sbc, K, E);
  else
    bfp_decode_kernel<uint16_t><<<grid_for(NB), NT, 0, st>>>(
        (const unsigned*)base, (const unsigned*)resid, (const int*)inv,
        (const int*)woff, (const int*)rband, (const int*)sb_off,
        (const int*)cnt, (uint16_t*)out, NB, C, sbc, K, E);
  return mgard_launch_status();
}

// K12 bfp_compact and K13 bfp_expand: BFP5's wire compaction on the card.
//
// They replace no TPU kernel: the JAX package maps between K2/K3's
// row-padded bands and the compact wire words on the host, in NumPy
// (mgard_tpu/lossless/bfp.py, its band compaction and expansion). Plain
// versions, which also serve CPU tensors: compact_wire_plain and
// expand_wire_plain in mgard_tpu_torch/lossless/bfp.py.
//
// The wire holds, superblock by superblock and plane by plane, the C slots
// of each band, slot b as its first cnt words; the device layout holds
// slot b at rows row0 + b*rband of 128 words. A band is one row of tab:
// (row0, rband, cnt, wire offset), int64, from the blob's sidecar.
//
// What bounds them on the H100: memory, and nothing else (no arithmetic
// but an index). K12 reads and writes the C*cnt valid words of each band;
// K13 reads them and writes the band's whole C*rband*128 words (the
// padding as zeros), so every word of the band buffer is written exactly
// once and the buffer needs no zero fill.
//
// Design: a CTA per band. K12 walks the band's words in wire order
// k = b*cnt + i, neighbouring threads on neighbouring k, so a warp reads
// and writes 128-byte segments, each thread holding WU = 8 loads in flight
// before it stores (the card needs ~40 KB in flight an SM to reach its
// bandwidth; 8 CTAs of 256 threads an SM hold 64 KB). K13 walks the band
// buffer in 16-byte quads q = b*rband*32 + i/4 (a slot's rows start on a
// 512-byte boundary, so every store is one aligned vector store), each
// thread loading its quad's up to four wire words, WQ = 4 quads in flight.
// A band with nothing to move returns at once.
namespace {

constexpr int WU = 8;  // K12: loads in flight a thread
constexpr int WQ = 4;  // K13: 16-byte stores (4 loads each) a thread

// floor(k / d) for k < 2^31 and 1 <= d < 2^31 by a multiply and a shift
// (Granlund and Montgomery's round-up method), its constants made once a
// CTA: a band's index k splits into slot and column at ~5 instructions.
struct Divider {
  unsigned m;
  int l;
};

__device__ __forceinline__ Divider divider(unsigned d) {
  const int l = 32 - __clz(d - 1);  // ceil(log2 d)
  return {(unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1), l};
}

__device__ __forceinline__ unsigned divide(unsigned k, Divider v) {
  return (__umulhi(k, v.m) + k) >> v.l;
}

__global__ void __launch_bounds__(NT)
bfp_compact_kernel(const unsigned* __restrict__ resid,
                   const long long* __restrict__ tab,
                   unsigned* __restrict__ out, int C) {
  const long long* t = tab + 4 * (long long)blockIdx.x;
  const unsigned cnt = (unsigned)t[2];
  if (cnt == 0) return;
  const unsigned* src = resid + t[0] * LANES;
  const unsigned rw = (unsigned)t[1] * LANES, n = C * cnt;
  const Divider dv = divider(cnt);
  unsigned* dst = out + t[3];
  for (unsigned k0 = threadIdx.x; k0 < n; k0 += NT * WU) {
    unsigned v[WU];
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const unsigned k = k0 + u * NT;
      if (k < n) {
        const unsigned b = divide(k, dv);
        v[u] = __ldg(src + (size_t)b * rw + (k - b * cnt));
      }
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const unsigned k = k0 + u * NT;
      if (k < n) dst[k] = v[u];
    }
  }
}

__global__ void __launch_bounds__(NT)
bfp_expand_kernel(const unsigned* __restrict__ wire,
                  const long long* __restrict__ tab,
                  unsigned* __restrict__ resid, int C) {
  const long long* t = tab + 4 * (long long)blockIdx.x;
  const unsigned rq = (unsigned)t[1] * (LANES / 4);  // quads a slot
  if (rq == 0) return;
  const unsigned cnt = (unsigned)t[2], n = C * rq;
  const Divider dv = divider(rq);
  const unsigned* src = wire + t[3];
  uint4* dst = reinterpret_cast<uint4*>(resid + t[0] * LANES);
  for (unsigned q0 = threadIdx.x; q0 < n; q0 += NT * WQ) {
    uint4 v[WQ];
#pragma unroll
    for (int u = 0; u < WQ; ++u) {
      const unsigned q = q0 + u * NT;
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (q < n) {
        const unsigned b = divide(q, dv), i = 4 * (q - b * rq);
        const unsigned* s = src + (size_t)b * cnt + i;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i + e < cnt) w[e] = __ldg(s + e);
      }
      v[u] = make_uint4(w[0], w[1], w[2], w[3]);
    }
#pragma unroll
    for (int u = 0; u < WQ; ++u) {
      const unsigned q = q0 + u * NT;
      if (q < n) dst[q] = v[u];
    }
  }
}

}  // namespace

// resid: K2's band buffer (int32 rows of 128); tab: (bands, 4) int64 rows
// (row0, rband, cnt, wire offset), cnt <= rband*128 and C*rband*128 < 2^31
// (the wrapper checks); out: the wire words, sum of C*cnt, each written
// once.
MGARD_EXPORT int bfp_compact(const void* resid, const void* tab, void* out,
                             long long bands, int C, void* stream) {
  if (bands <= 0 || bands > 0x7FFFFFFFLL || C < 1)
    return (int)cudaErrorInvalidValue;
  bfp_compact_kernel<<<(unsigned)bands, NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)resid, (const long long*)tab, (unsigned*)out, C);
  return mgard_launch_status();
}

// The mirror of bfp_compact: wire words -> every word of the bands of tab
// in resid (the valid words, and zeros past cnt in each slot); resid must
// be 16-byte aligned.
MGARD_EXPORT int bfp_expand(const void* wire, const void* tab, void* resid,
                            long long bands, int C, void* stream) {
  if (bands <= 0 || bands > 0x7FFFFFFFLL || C < 1)
    return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(resid)) return (int)cudaErrorMisalignedAddress;
  bfp_expand_kernel<<<(unsigned)bands, NT, 0, (cudaStream_t)stream>>>(
      (const unsigned*)wire, (const long long*)tab, (unsigned*)resid, C);
  return mgard_launch_status();
}
