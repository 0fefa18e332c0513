// K5 bfx_encode and K6 bfx_decode: the BFX2 block bitplane packer and
// unpacker.
//
// Replaces the TPU kernels mgard_tpu/lossless/bfx.py::_encode_pallas (body
// _encode_kernel) and ::_decode_pallas (body _decode_kernel), together with
// the width and offset glue of encode_core/decode_core. Plain versions:
// encode_core_plain and decode_core_plain in
// mgard_tpu_torch/lossless/bfx.py (the JAX package's merge and split
// trees), which the kernels match word for word.
//
// The format fixes where every word goes: a block of width w (bit length of
// its largest zigzag code) stores w plane words, bit k of plane word j being
// bit j of symbol k; within a superblock of sb blocks the blocks follow in
// bit-reversed index order (what the TPU's log-depth merge tree produces),
// each block's words consecutive; superblock s starts at offs[s], its
// length rounded up to `align` words, and the gap words are zero.
//
// What bounds them on the H100: memory. K5 reads the int32 symbols once and
// writes w/32 of a word per symbol plus a width byte a block; K6 the
// reverse. The merge tree's log-depth shifting is replaced by its closed
// form: a scan of the widths in emission (bit-reversed) order gives every
// block's word offset.
//
// Design. A CTA owns P = min(sb, 512) blocks of one superblock: the range
// [r*P, (r+1)*P) of its emission order, which holds the natural blocks
// i = C*j + brev(r) (C = sb/P CTAs a superblock, j = 0..P-1), block j
// emitted at local position m = brev(j). Each block is one 128-byte line,
// so the CTA reads whole lines and writes ONE contiguous run of words.
//   K5 (one launch, clusters of C CTAs, one superblock a cluster): 16-byte
//   cp.async of the CTA's P lines into shared slots in emission order (the
//   quads swizzled so that a thread per slot reads them without bank
//   conflicts); a thread per block ORs its 32 zigzag codes into its width;
//   the CTA scans its widths; the cluster exchanges its CTA totals and
//   width bytes over distributed shared memory (base of each CTA in the
//   superblock, the superblock's length, the widths stored in natural order
//   as contiguous bytes); the superblock offset comes from a decoupled
//   look-back; a thread per block runs the register butterfly
//   (bits.cuh bit_transpose<32>) and writes its w plane words into a stage
//   in place of the slots it has read (a block's words never start past its
//   own slot, and every slot of a round is read before any is written); the
//   CTA then stores its run with 16-byte stores, scalar ones only at a
//   head or tail that is not a whole aligned quad; the superblock's last
//   CTA zeroes the alignment gap. Symbols are read from device memory once.
//   K6 (one launch): a CTA per emission range, no cluster. It reads the
//   superblock's sb width bytes (L2-resident: the C CTAs share them), from
//   which it gets its own widths in emission order, its base in the
//   superblock and the superblock's length; the offset by the same
//   look-back; then it loads exactly its run (16-byte cp.async inside,
//   scalars at the ends: nothing past `total` is read), a thread per block
//   takes its w words (zero above w), runs the butterfly and un-zigzags
//   into the block's slot (rounds walk the slots downwards, so a slot is
//   written only once every word staged below it is read), and the CTA
//   stores whole 128-byte lines.
//
// Superblock offsets: decoupled look-back over superblocks. Superblock s
// publishes its aligned length as an aggregate as soon as it has it, and
// its inclusive offset once known, each in one 64-bit status word (flag in
// the high half, value in the low half: a flag is never seen without its
// value), stored with release and read with acquire semantics. A reader
// sums the aggregates of the superblocks before it, backwards, until it
// reaches an inclusive value. The entry point zeroes the status words and
// the ticket counter (scratch[0]) on the stream before each launch.
//
// Forward progress: a unit's superblock is its ticket, taken with an atomic
// in the order units start (K5: cluster rank 0 takes it and broadcasts it;
// K6: ticket t is superblock t/C, emission range t%C), never blockIdx. A
// unit waits only on the status words of superblocks with smaller tickets,
// whose publishers (K5's clusters, K6's range-0 CTAs) have started, are
// resident (a started cluster is resident as a whole) and publish their
// aggregate without waiting on anything. So the unit with the smallest
// ticket still waiting can always finish, and by induction every unit does.
#include <cooperative_groups.h>

#include "bits.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // 8 warps per CTA
// blocks of 32 symbols a CTA (64 KB of symbols): superblocks of 4096 blocks
// take clusters of 8
constexpr int LOG_PB = 9, PB = 1 << LOG_PB;
constexpr int MAX_C = 16;  // CTAs a superblock (the largest cluster)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long AGG = 1ull << 32, INCL = 2ull << 32;

__device__ __forceinline__ int brev(int k, int bits) {
  return bits ? (int)(__brev((unsigned)k) >> (32 - bits)) : 0;
}

__device__ __forceinline__ unsigned zigzag(int x) {
  return ((unsigned)x << 1) ^ (unsigned)(x >> 31);
}

// Word index in the CTA buffer of quad q of slot m (4 leading words; the
// quads of a slot swizzled so that 8 threads reading quad q of 8
// consecutive slots hit 8 distinct bank groups).
__device__ __forceinline__ int quad_at(int m, int q) {
  return 4 + 32 * m + 4 * (q ^ (m & 7));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Exclusive prefix of v over the CTA (all NT threads call it); *total
// receives the sum. warp_tot: NT/32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
  for (int q = 0; q < NT / 32; ++q) {
    const int t = warp_tot[q];
    if (q < warp) before += t;
    tot += t;
  }
  __syncthreads();
  *total = tot;
  return before + x - v;
}

// off_s[m] = words of the slots before m (emission order); returns the
// CTA's words. Thread t scans a run of consecutive slots.
__device__ int cta_scan(const uint8_t* w_s, int* off_s, int P,
                        int* warp_tot) {
  const int per = (P + NT - 1) / NT, m0 = threadIdx.x * per;
  const int m1 = min(m0 + per, P);
  int sum = 0;
  for (int m = m0; m < m1; ++m) sum += w_s[m];
  int tot;
  int ex = block_exclusive_scan(sum, warp_tot, &tot);
  for (int m = m0; m < m1; ++m) {
    off_s[m] = ex;
    ex += w_s[m];
  }
  __syncthreads();
  return tot;
}

// Exclusive offset of superblock s: the aggregates of the superblocks
// before it, summed backwards until an inclusive value (one warp, 32
// status words a step). Every superblock read has a smaller ticket, so the
// wait ends; should it not, the kernel traps after seconds and the launch
// reports an error instead of holding the card.
__device__ int lookback(const unsigned long long* status, int s) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int top = s - 1; top >= 0; top -= 32) {
    const int u = top - lane;
    unsigned long long v = 0;
    for (int spins = 0;; ++spins) {
      if (u >= 0 && !(v >> 32)) v = ld_acquire(status + u);
      if (__all_sync(FULL, u < 0 || (v >> 32))) break;
      if (spins == 1 << 26) __trap();
      __nanosleep(64);
    }
    const unsigned incl = __ballot_sync(FULL, u >= 0 && (v & INCL));
    const int stop = incl ? __ffs(incl) - 1 : 31;
    excl += (int)__reduce_add_sync(
        FULL, u >= 0 && lane <= stop ? (unsigned)v : 0u);
    if (incl) break;
  }
  return excl;
}

// The superblock's aligned length (< 2^31: the wrapper checks the stream).
__device__ __forceinline__ int aligned(int L, int align) {
  return (int)(((long long)L + align - 1) / align * align);
}

// out[g0, g0 + n) = buf[a, a + n) with a = g0 & 3 (buf quads line up with
// the quads of out), or zeros when buf is null: 16-byte stores for whole
// quads, scalars at a partial head or tail.
__device__ void store_run(unsigned* out, int g0, int n, const unsigned* buf) {
  if (n <= 0) return;
  const int q0 = g0 >> 2, q1 = (g0 + n - 1) >> 2, g1 = g0 + n;
  for (int q = q0 + (int)threadIdx.x; q <= q1; q += NT) {
    const long long w0 = 4LL * q;  // the last quad may pass INT_MAX
    const int si = 4 * (q - q0);
    if (w0 >= g0 && w0 + 4 <= g1) {
      const uint4 v = buf ? *reinterpret_cast<const uint4*>(buf + si)
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(out + w0) = v;
    } else {
      for (int e = 0; e < 4; ++e)
        if (w0 + e >= g0 && w0 + e < g1) out[w0 + e] = buf ? buf[si + e] : 0u;
    }
  }
}

// The mirror of store_run: buf[a, a + n) = words[g0, g0 + n), a = g0 & 3;
// reads no word outside the run. Ends with the CTA's copies complete.
__device__ void load_run(unsigned* buf, const unsigned* words, int g0,
                         int n) {
  if (n > 0) {
    const int q0 = g0 >> 2, q1 = (g0 + n - 1) >> 2, g1 = g0 + n;
    for (int q = q0 + (int)threadIdx.x; q <= q1; q += NT) {
      const long long w0 = 4LL * q;
      const int si = 4 * (q - q0);
      if (w0 >= g0 && w0 + 4 <= g1) {
        cp_async16(buf + si, words + w0);
      } else {
        for (int e = 0; e < 4; ++e)
          if (w0 + e >= g0 && w0 + e < g1) buf[si + e] = __ldg(words + w0 + e);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// K5's butterfly rounds: slots [m0, m0 + NT) a round; every slot of the
// round is read into registers before any plane word is staged. A block's
// words go to a + off_s[m] + j < 4 + 32 * (m + 1): at or below its own
// slot, never into a slot not yet read.
__device__ void pack_rounds(unsigned* buf, const uint8_t* w_s,
                            const int* off_s, int P, int a) {
  for (int m0 = 0; m0 < P; m0 += NT) {
    const int m = m0 + (int)threadIdx.x;
    const bool on = m < P;
    unsigned z[32];
    if (on) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = *reinterpret_cast<const uint4*>(buf + quad_at(m, q));
        z[4 * q] = zigzag((int)v.x);
        z[4 * q + 1] = zigzag((int)v.y);
        z[4 * q + 2] = zigzag((int)v.z);
        z[4 * q + 3] = zigzag((int)v.w);
      }
      bit_transpose<32>(z);
    }
    __syncthreads();
    if (on) {
      const int w = w_s[m], o = a + off_s[m];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < w) buf[o + j] = z[j];
    }
  }
  __syncthreads();
}

struct Geo {
  int P, logP, logC, align;
};

// Dynamic shared memory of a CTA of P blocks: the slots (and stage), then
// off_s (P ints) and w_s (P bytes).
inline size_t smem_bytes(int P) {
  return ((size_t)(4 + 32 * P) * 4 + (size_t)P * 5 + 15) / 16 * 16;
}

// K5. Grid NSB * C in clusters of C = sb / P; one superblock a cluster.
__global__ void __launch_bounds__(NT, 2)
bfx_encode_kernel(const int* __restrict__ sym, uint8_t* __restrict__ widths,
                  unsigned long long* __restrict__ scratch,
                  int* __restrict__ offs, unsigned* __restrict__ out, Geo G) {
  extern __shared__ uint4 smem[];
  unsigned* buf = reinterpret_cast<unsigned*>(smem);
  int* off_s = reinterpret_cast<int*>(buf + 4 + 32 * G.P);
  uint8_t* w_s = reinterpret_cast<uint8_t*>(off_s + G.P);
  __shared__ int warp_tot[NT / 32];
  // ticket (rank 0), the CTA's words, its base in the superblock, the
  // superblock's words, its offset
  __shared__ int cl[5];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = G.P, C = 1 << G.logC, r = (int)cluster.block_rank();
  unsigned long long* status = scratch + 1;

  if (r == 0 && threadIdx.x == 0)
    cl[0] = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  cluster.sync();
  const int s = *cluster.map_shared_rank(&cl[0], 0);
  const long long blk0 = (long long)s << (G.logP + G.logC);
  const int rr = brev(r, G.logC);

  // the CTA's P lines, slot m = local emission position
  for (int i = threadIdx.x; i < 8 * P; i += NT) {
    const int m = i >> 3, q = i & 7;
    const long long b = blk0 + ((long long)brev(m, G.logP) << G.logC) + rr;
    cp_async16(buf + quad_at(m, q), sym + b * 32 + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int m = threadIdx.x; m < P; m += NT) {
    unsigned o = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + quad_at(m, q));
      o |= zigzag((int)v.x) | zigzag((int)v.y) | zigzag((int)v.z) |
           zigzag((int)v.w);
    }
    w_s[m] = (uint8_t)(32 - __clz((int)o));
  }
  __syncthreads();
  const int T = cta_scan(w_s, off_s, P, warp_tot);
  if (threadIdx.x == 0) cl[1] = T;
  cluster.sync();  // every CTA's widths and words are in place

  if (threadIdx.x < 32) {
    const int q = threadIdx.x;
    const unsigned t = q < C ? *cluster.map_shared_rank(&cl[1], q) : 0u;
    const int base = (int)__reduce_add_sync(FULL, q < r ? t : 0u);
    const int L = (int)__reduce_add_sync(FULL, t);
    if (q == 0) {
      cl[2] = base;
      cl[3] = L;
      if (r == 0)
        st_release(status + s,
                   (s ? AGG : INCL) | (unsigned)aligned(L, G.align));
    }
  }
  // natural width bytes [r*P, (r+1)*P) of the superblock, one run
  for (int x = threadIdx.x; x < P; x += NT) {
    const int i = r * P + x;
    widths[blk0 + i] = *cluster.map_shared_rank(
        &w_s[brev(i >> G.logC, G.logP)], brev(i & (C - 1), G.logC));
  }
  __syncthreads();
  const int base = cl[2], L = cl[3], A = aligned(L, G.align);
  // the stage's quads line up with out's once base + offset mod 4 is known:
  // before the look-back when every offset is a multiple of 4
  const bool early = (G.align & 3) == 0;
  if (early) pack_rounds(buf, w_s, off_s, P, base & 3);
  if (r == 0 && threadIdx.x < 32) {
    const int E = s ? lookback(status, s) : 0;
    if (threadIdx.x == 0) {
      if (s) st_release(status + s, INCL | (unsigned)(E + A));
      offs[s + 1] = E + A;
      if (s == 0) offs[0] = 0;
    }
    if ((int)threadIdx.x < C)
      *cluster.map_shared_rank(&cl[4], threadIdx.x) = E;
  }
  cluster.sync();  // the offset is in every CTA; no remote access after this
  const int E = cl[4], g0 = E + base;
  if (!early) pack_rounds(buf, w_s, off_s, P, g0 & 3);
  store_run(out, g0, T, buf);
  if (r == C - 1) store_run(out, E + L, A - L, nullptr);
}

// K6. Grid NSB * C CTAs; ticket t is emission range t % C of superblock
// t / C.
__global__ void __launch_bounds__(NT, 2)
bfx_decode_kernel(const unsigned* __restrict__ words,
                  const uint8_t* __restrict__ widths,
                  unsigned long long* __restrict__ scratch,
                  int* __restrict__ sym, Geo G) {
  extern __shared__ uint4 smem[];
  unsigned* buf = reinterpret_cast<unsigned*>(smem);
  int* off_s = reinterpret_cast<int*>(buf + 4 + 32 * G.P);
  uint8_t* w_s = reinterpret_cast<uint8_t*>(off_s + G.P);
  __shared__ int warp_tot[NT / 32];
  __shared__ int sums[MAX_C];  // words of each residue class i % C
  __shared__ int cl[2];     // ticket, the superblock's offset
  const int P = G.P, C = 1 << G.logC;
  unsigned long long* status = scratch + 1;

  if (threadIdx.x == 0)
    cl[0] = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  if (threadIdx.x < MAX_C) sums[threadIdx.x] = 0;
  __syncthreads();
  const int s = cl[0] >> G.logC, r = cl[0] & (C - 1), rr = brev(r, G.logC);
  const int sb = P << G.logC;
  const long long blk0 = (long long)s * sb;

  // the superblock's widths: this CTA's in emission order, and the words
  // of each residue class (thread t only sees class t % C: C divides NT)
  int mine = 0;
  for (int i = threadIdx.x; i < sb; i += NT) {
    const int w = widths[blk0 + i];
    mine += w;
    if ((i & (C - 1)) == rr) w_s[brev(i >> G.logC, G.logP)] = (uint8_t)w;
  }
  atomicAdd(&sums[threadIdx.x & (C - 1)], mine);
  __syncthreads();
  const int T = cta_scan(w_s, off_s, P, warp_tot);
  int base = 0, L = 0;
  for (int q = 0; q < C; ++q) {
    const int t = sums[brev(q, G.logC)];
    base += q < r ? t : 0;
    L += t;
  }
  const int A = aligned(L, G.align);
  if (r == 0 && threadIdx.x == 0)
    st_release(status + s, (s ? AGG : INCL) | (unsigned)A);
  if (threadIdx.x < 32) {
    const int E = s ? lookback(status, s) : 0;
    if (threadIdx.x == 0) {
      if (r == 0 && s) st_release(status + s, INCL | (unsigned)(E + A));
      cl[1] = E;
    }
  }
  __syncthreads();
  const int g0 = cl[1] + base, a = g0 & 3;
  load_run(buf, words, g0, T);

  // rounds walk the slots downwards: slot m's symbols overwrite only words
  // staged for slots >= m, which earlier rounds (or this one, before the
  // barrier) have read
  const int last = (P - 1) / NT * NT;
  for (int m0 = last; m0 >= 0; m0 -= NT) {
    const int m = m0 + (int)threadIdx.x;
    const bool on = m < P;
    unsigned z[32];
    if (on) {
      const int w = w_s[m], o = a + off_s[m];
#pragma unroll
      for (int j = 0; j < 32; ++j) z[j] = j < w ? buf[o + j] : 0u;
      bit_transpose<32>(z);
    }
    __syncthreads();
    if (on) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint4 v;
        v.x = (z[4 * q] >> 1) ^ (0u - (z[4 * q] & 1u));
        v.y = (z[4 * q + 1] >> 1) ^ (0u - (z[4 * q + 1] & 1u));
        v.z = (z[4 * q + 2] >> 1) ^ (0u - (z[4 * q + 2] & 1u));
        v.w = (z[4 * q + 3] >> 1) ^ (0u - (z[4 * q + 3] & 1u));
        *reinterpret_cast<uint4*>(buf + quad_at(m, q)) = v;
      }
    }
  }
  __syncthreads();
  // whole 128-byte lines: 8 threads a block
  for (int i = threadIdx.x; i < 8 * P; i += NT) {
    const int m = i >> 3, q = i & 7;
    const long long b = blk0 + ((long long)brev(m, G.logP) << G.logC) + rr;
    *reinterpret_cast<uint4*>(sym + b * 32 + 4 * q) =
        *reinterpret_cast<const uint4*>(buf + quad_at(m, q));
  }
}

inline int log2_exact(int sb) {
  int bits = 0;
  while ((1 << bits) < sb) ++bits;
  return (1 << bits) == sb ? bits : -1;
}

// The CTA geometry of superblocks of sb blocks: P = min(sb, PB) blocks a
// CTA, C = sb / P CTAs a superblock.
Geo geometry(int sb, int align) {
  const int bits = log2_exact(sb);
  const int logP = bits < LOG_PB ? bits : LOG_PB;
  return Geo{1 << logP, logP, bits - logP, align};
}

// K5's and K6's function attributes, set once per device: the shared
// memory of a CTA of PB blocks, and clusters above the portable 8 (a PB
// below 512).
struct BfxAttributes;
cudaError_t set_attributes() {
  return mgard_set_attributes<BfxAttributes>(
      {(const void*)bfx_encode_kernel, (const void*)bfx_decode_kernel},
      (int)smem_bytes(PB), true);
}

// The ticket counter and the NSB status words, zeroed on the stream.
inline cudaError_t zero_scratch(void* scratch, long long NSB,
                                cudaStream_t st) {
  return cudaMemsetAsync(scratch, 0, (size_t)(NSB + 1) * 8, st);
}

// sb a power of two of at most MAX_C * PB blocks, whole superblocks, and a
// grid that fits
inline bool bad_geometry(long long NB, int sb, int align) {
  return log2_exact(sb) < 0 || sb > MAX_C * PB || NB <= 0 || NB % sb ||
         align < 1 || NB / (sb < PB ? sb : PB) > 0x7FFFFFFF;
}

}  // namespace

// sym: (NB*32,) int32, 16-byte aligned; widths: (NB,) u8 out; scratch:
// (NB/sb + 1,) u64, zeroed here (the ticket counter, then one status word
// a superblock); offs: (NB/sb + 1,) int32 out (offs[NB/sb] =
// total words); out: the word buffer (at least offs[NB/sb] words), 16-byte
// aligned. sb a power of two dividing NB; align >= 1. Words past the total
// are left as they were.
MGARD_EXPORT int bfx_encode(const void* sym, void* widths, void* scratch,
                            void* offs, void* out, long long NB, int sb,
                            int align, void* stream) {
  if (bad_geometry(NB, sb, align)) return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(sym) || !mgard_aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const Geo G = geometry(sb, align);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1u << G.logC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)(NB / G.P));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(G.P);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = set_attributes();
  if (e == cudaSuccess) e = zero_scratch(scratch, NB / sb, cfg.stream);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, bfx_encode_kernel, (const int*)sym,
                           (uint8_t*)widths, (unsigned long long*)scratch,
                           (int*)offs, (unsigned*)out, G);
  return mgard_launch_status(e);
}

// words: the stream's total words (no slack), 16-byte aligned; widths:
// (NB,) u8, each <= 32; scratch: as for bfx_encode; sym: (NB*32,) int32
// out, 16-byte aligned.
MGARD_EXPORT int bfx_decode(const void* words, const void* widths,
                            void* scratch, void* sym, long long NB, int sb,
                            int align, void* stream) {
  if (bad_geometry(NB, sb, align)) return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(words) || !mgard_aligned16(sym))
    return (int)cudaErrorMisalignedAddress;
  const Geo G = geometry(sb, align);
  cudaError_t e = set_attributes();
  if (e == cudaSuccess)
    e = zero_scratch(scratch, NB / sb, (cudaStream_t)stream);
  if (e == cudaSuccess) {
    bfx_decode_kernel<<<(unsigned)(NB / G.P), NT, smem_bytes(G.P),
                        (cudaStream_t)stream>>>(
        (const unsigned*)words, (const uint8_t*)widths,
        (unsigned long long*)scratch, (int*)sym, G);
    e = cudaSuccess;
  }
  return mgard_launch_status(e);
}
