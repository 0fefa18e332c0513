// K10 hybrid_pack_v3 and K11 hybrid_unpack_v3: the fused transform+pack
// front end of hybrid flag-2 ("v3") streams.
//
// Replaces the TPU kernels mgard_tpu/ops/hybrid.py::local_transform_pack_v3
// (body _fwd_kernel_v3_body, plan _v3_plan_kernel) and ::unpack_inverse_v3
// (body _inv_kernel_v3_body). Plain versions: transform_pack_v3 and
// unpack_inverse_v3_plain in mgard_tpu_torch/ops/hybrid.py, which the
// kernels match bit for bit (the line walk's float operations are K1/K4's;
// the library is built with -fmad=false).
//
// The scheme: each (8, 128, Z) tile of the field is one BFP superblock of
// 1024 chunks, a chunk being one (x, y) row of Z z-grouped zigzag codes
// (C = Z/32 blocks of 32), chunks in tile-major order. Chunks are stably
// sorted by residual length crl = clip(cw - K, 0, E), descending; block b of
// the chunk with sorted column c' stores base plane j at base[s, j, b, c']
// and residual plane K+j at resid[s, j, b, c'] (the static-cap layout: no
// offset depends on the data, so no scan across superblocks is needed).
//
// What bounds them on the H100: memory. K10 must read 4 bytes per element
// and write (K+E)/8; K11 the reverse. The stencil is ~20 flops per element.
//
// Design: one pass over each tile, by a cluster of 16 thread blocks.
// A chunk's sorted column depends on the widths of all 1024 chunks of its
// tile, and a width on the chunk's whole transformed row, so the tile's
// codes must be held somewhere until its widths are known; a thread block
// has 227 KB, the tile 2 bytes per element (1 MB at Z = 512). Block r of the
// cluster owns the 8x8 (x, y) column at y0 + 8r: chunk rows xi*128 + 8r +
// yi of the superblock, 64 rows of Z codes, which it keeps in a row buffer
// in its dynamic shared memory (64 KB at Z = 512, 128 KB at Z = 1024).
// The other blocks read and write that buffer through distributed shared
// memory, so nothing goes through device memory between the passes.
//   K10: the warps run K1's register line walk (line8.cuh) down the
//   column, a warp per 8^3 block, the corners straight to rem, the codes
//   into the row buffer, each row's codes OR-ed in registers for its width
//   (a chunk is a whole row). Each block then turns every slot b (32
//   codes) of its own rows into bit planes in place: the 16x16 butterfly
//   of bits.cuh on symbols k and k+16 paired, plane p at the slot's word p,
//   nq = ceil((K+E)/4) quads kept. Every block reads the tile's 1024
//   widths from the 16 blocks, poisons the tile to 32 if a width is over 16
//   (the caller falls back), and ranks crl with a counting sort in shared
//   memory, bit-identical to lossless/bfp.py _sort_plan. Block r then packs
//   the sorted columns [64r, 64r + 64): a thread per (column, slot b) reads
//   the nq plane quads of slot b of the chunk that sorts there from its
//   owner's buffer and stores the K + E plane words; a warp's 32 consecutive
//   columns make every plane one 128-byte row. Every base and residual word
//   is stored exactly once (above a chunk's width the planes are zero by
//   construction). Transposing at the owner, where the reads are local,
//   moves 4*nq of 16 words a slot between blocks (12 of 16 at K + E = 12)
//   and takes the butterfly out of the phase that waits on remote reads.
//   Split cluster barriers let a block transpose while the others finish
//   their walks and rank while they finish their transposes; a last
//   barrier keeps every buffer alive until the other blocks have read it.
//   K11: the mirror. Each block ranks its tile's crl and unpacks its 64
//   sorted columns (base words, and a residual word only where crl is over
//   its plane: a deserialized resid need not hold zeros there) as plane
//   quads into the owners' buffers; after a cluster barrier each block
//   turns its own slots back into codes and runs K4's line walk on its
//   rows, its output tile staged in shared memory so that a warp stores
//   whole rows.
//
// The row buffer: row R = 8*xi + yi holds Z u16 codes in grouped order
// (slot c*g + jz holds z = 8*jz + c), its 4-byte word w at w ^ swz(R). The
// swizzle spreads every access pattern over the banks: the line walk's u16
// stores and loads (one slot, rows 2*lane + s) hit 32 distinct banks; a
// 16-byte access (a quad of four words, at quad (w >> 2) ^ (swz >> 2)) by a
// quarter warp of 8 consecutive chunks hits 8 distinct quad banks (the
// transposes' quarter warps take 8 rows of one xi; in the pack and unpack,
// equal widths sort in natural order, so that is the common case); a
// thread undoes the word order inside a quad (XOR by swz & 3) in registers.
#include <cooperative_groups.h>

#include "bits.cuh"
#include "common.cuh"
#include "line8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SBC = 1024;    // chunks per superblock (an (8, 128) tile)
constexpr int CLUSTER = 16;  // thread blocks per tile: its 8x8 columns
constexpr int ROWS = 64;     // chunk rows of a block
constexpr int MAX_B = 16;    // residual-length buckets: E + 1 <= 16
constexpr int NW = 8;        // warps a block: z-blocks a tile of the walk
constexpr int NT = 32 * NW;
constexpr int BATCH = 2;     // K10's pack tasks a warp has in flight

struct RankScratch {
  int wtot[MAX_B][32];  // per bucket, per group of 32 chunks: count, then
                        // exclusive prefix over the groups
  int tot[MAX_B];       // per bucket: count over the superblock
};

// Stable descending counting sort of crl[0..1024) (values in [0, E]):
// rank[i] = #(crl > crl[i]) + #(j < i with crl[j] == crl[i]). The caller
// synchronizes before (crl filled) and after.
__device__ void sb_rank(const int* crl, int E, int* rank, RankScratch& rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < SBC / 32; g += NW) {
    const int r = crl[g * 32 + lane];
    for (int k = 0; k <= E; ++k) {
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, r == k);
      if (lane == 0) rs.wtot[k][g] = __popc(bal);
    }
  }
  __syncthreads();
  for (int k = warp; k <= E; k += NW) {
    const int x = rs.wtot[k][lane];
    int incl = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    rs.wtot[k][lane] = incl - x;
    if (lane == 31) rs.tot[k] = incl;
  }
  __syncthreads();
  for (int g = warp; g < SBC / 32; g += NW) {
    const int r = crl[g * 32 + lane];
    const unsigned same = __match_any_sync(0xFFFFFFFFu, r);
    int before = rs.wtot[r][g] + __popc(same & ((1u << lane) - 1u));
    for (int k = r + 1; k <= E; ++k) before += rs.tot[k];
    rank[g * 32 + lane] = before;
  }
}

// The shared state of a block besides its row buffer: the tile's crl and
// rank, and the chunk of each of the block's 64 sorted columns.
struct TileRank {
  int crl[SBC];
  int rank[SBC];
  int inv[ROWS];
  RankScratch rs;
};

// Rank the tile's crl (filled by the caller, who synchronizes) and set
// inv[i] = the chunk at sorted column 64r + i. Returns synchronized.
__device__ void rank_tile(TileRank& tr, int E, int r) {
  sb_rank(tr.crl, E, tr.rank, tr.rs);
  __syncthreads();
  for (int c = threadIdx.x; c < SBC; c += NT) {
    const int cs = tr.rank[c];
    if ((cs >> 6) == r) tr.inv[cs & (ROWS - 1)] = c;
  }
  __syncthreads();
}

// Owner (cluster rank) of chunk c of the tile, and its row there.
__device__ __forceinline__ int owner_of(int c) { return (c >> 3) & 15; }
__device__ __forceinline__ int row_in_owner(int c) {
  return ((c >> 7) << 3) | (c & 7);
}

// Word swizzle of row R of a row buffer (see the header).
__device__ __forceinline__ int swz(int R) {
  return ((R >> 1) ^ (R << 2)) & 31;
}

// The u16 code at grouped slot `col` of row R; RW = Z/2 words a row.
__device__ __forceinline__ uint16_t* code_at(uint16_t* rows, int RW, int R,
                                             int col) {
  unsigned* w = reinterpret_cast<unsigned*>(rows) + R * RW +
                ((col >> 1) ^ swz(R));
  return reinterpret_cast<uint16_t*>(w) + (col & 1);
}

// Word order inside a quad: the XOR by p in 0..3 of the word index (its own
// inverse).
__device__ __forceinline__ uint4 quad_perm(uint4 x, int p) {
  if (p & 1) x = make_uint4(x.y, x.x, x.w, x.z);
  if (p & 2) x = make_uint4(x.z, x.w, x.x, x.y);
  return x;
}

// Quad i (16 bytes: symbols 8i..8i+7) of block b of row R, as an index into
// the row's quads.
__device__ __forceinline__ int quad_at(int R, int b, int i) {
  return (4 * b + i) ^ (swz(R) >> 2);
}

// A split cluster barrier, so that a block works while the others catch
// up: arrive releases the thread's earlier shared-memory writes to the
// cluster, wait returns once every thread of the cluster has arrived.
// Relaxed arrival orders no memory: K11 arrives so on entry and waits
// before its first remote store, since no block may touch another's
// shared memory before that block has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ int clip_crl(int w, int K, int E) {
  return min(max(w - K, 0), E);
}

// Slot b of local row R (rowq: the row's quads), in place: its 32 codes
// become planes 0..4*nq-1 of the 16x16 butterfly on paired halves (plane p
// at the slot's word p), nq = ceil((K+E)/4) quads written.
__device__ __forceinline__ void codes_to_planes(uint4* rowq, int R, int b,
                                                int nq) {
  const int sw = swz(R);
  unsigned w[16];  // words 0-7: symbols 0-15, words 8-15: symbols 16-31
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 x = quad_perm(rowq[quad_at(R, b, i)], sw & 3);
    w[4 * i] = x.x;
    w[4 * i + 1] = x.y;
    w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
  unsigned z[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)  // symbol q | symbol q+16 << 16
    z[q] = __byte_perm(w[q >> 1], w[8 + (q >> 1)], q & 1 ? 0x7632 : 0x5410);
  bit_transpose<16>(z);  // z[p] = plane p
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < nq)
      rowq[quad_at(R, b, i)] = quad_perm(
          make_uint4(z[4 * i], z[4 * i + 1], z[4 * i + 2], z[4 * i + 3]),
          sw & 3);
}

// The mirror: planes 0..4*nq-1 of slot b (planes above read as 0) become
// its 32 codes again.
__device__ __forceinline__ void planes_to_codes(uint4* rowq, int R, int b,
                                                int nq) {
  const int sw = swz(R);
  unsigned z[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 x = i < nq ? quad_perm(rowq[quad_at(R, b, i)], sw & 3)
                           : make_uint4(0u, 0u, 0u, 0u);
    z[4 * i] = x.x;
    z[4 * i + 1] = x.y;
    z[4 * i + 2] = x.z;
    z[4 * i + 3] = x.w;
  }
  bit_transpose<16>(z);  // symbols q | q+16 << 16
  unsigned w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = __byte_perm(z[2 * i], z[2 * i + 1], 0x5410);
    w[8 + i] = __byte_perm(z[2 * i], z[2 * i + 1], 0x7632);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    rowq[quad_at(R, b, i)] = quad_perm(
        make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]),
        sw & 3);
}

// K10. Grid (Y/8, X/8) in clusters of 16 along x: block r = blockIdx.x % 16
// of the cluster owns the column at y0 = 8 * blockIdx.x of the tile
// (blockIdx.x / 16, blockIdx.y).
__global__ void __launch_bounds__(NT, 2)
v3_pack_kernel(const float* __restrict__ v, float inv_q,
               unsigned* __restrict__ base, unsigned* __restrict__ resid,
               int* __restrict__ cw, float* __restrict__ rem, int Y, int Z,
               int nl, int K, int E) {
  extern __shared__ uint4 dyn[];  // the row buffer
  uint16_t* rows_s = reinterpret_cast<uint16_t*>(dyn);
  __shared__ unsigned wor[ROWS];  // OR of each row's codes
  __shared__ TileRank tr;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xi = lane >> 2, j = lane & 3;
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8, C = Z / 32, RW = Z / 2, RQ = Z / 8;
  const int nq = (K + E + 3) / 4;  // plane quads a slot
  const unsigned cmask = chain_mask(nl);
  const int k = __popc(cmask), RY = Y / 8 * k, RZ = Z / 8 * k;
  const long long s = (long long)blockIdx.y * (Y >> 7) + (blockIdx.x >> 4);
  if (threadIdx.x < ROWS) wor[threadIdx.x] = 0u;
  __syncthreads();

  // 1. The line walk: warp w takes z-blocks w, w + NW, ...; lane (xi, j)
  // the rows Ra = 2*lane (y = 2j) and Rb = Ra + 1, the next block's lines
  // in flight while the current one is computed.
  const bool xin = in_chain(nl, xi);
  const bool ca = xin && in_chain(nl, 2 * j);
  const bool cb = xin && in_chain(nl, 2 * j + 1);
  const int Ra = 2 * lane, Rb = Ra + 1;
  const float* ra = v + row_of(x0, y0, Y, Z, Ra);
  const float* rb = ra + Z;
  unsigned acc_a = 0u, acc_b = 0u;
  Lines nx;
  load_line(ra + 8 * warp, nx.a);
  load_line(rb + 8 * warp, nx.b);
  for (int jz = warp; jz < g; jz += NW) {
    Lines l = nx;
    if (jz + NW < g) {
      load_line(ra + 8 * (jz + NW), nx.a);
      load_line(rb + 8 * (jz + NW), nx.b);
    }
    decompose_lines(l, xi, j, nl);
    unsigned za[8], zb[8];
    line_codes(l.a, ca, cmask, inv_q,
               rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j, jz, 0), za);
    line_codes(l.b, cb, cmask, inv_q,
               rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j + 1, jz, 0),
               zb);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc_a |= za[c];
      acc_b |= zb[c];
      *code_at(rows_s, RW, Ra, c * g + jz) = (uint16_t)za[c];
      *code_at(rows_s, RW, Rb, c * g + jz) = (uint16_t)zb[c];
    }
  }
  atomicOr(&wor[Ra], acc_a);
  atomicOr(&wor[Rb], acc_b);
  __syncthreads();
  cluster_arrive();  // the block's row ORs are in place

  // 2. Every slot of the block's own rows to bit planes, in place: a thread
  // per (row, slot), a quarter warp on 8 rows of one xi.
  uint4* rows_q = dyn;
  for (int t = threadIdx.x; t < ROWS * C; t += NT)
    codes_to_planes(rows_q + (t & 63) * RQ, t & 63, t >> 6, nq);
  cluster_wait();    // every block's row ORs are in place
  cluster_arrive();  // the block's planes are in place

  // 3. Widths (a code over 16 bits poisons the tile) and the rank.
  int over = 0;
  for (int c = threadIdx.x; c < SBC; c += NT) {
    const unsigned* wr = cluster.map_shared_rank(wor, owner_of(c));
    const int w = 32 - __clz((int)wr[row_in_owner(c)]);
    tr.crl[c] = w;
    over |= w > 16;
  }
  over = __syncthreads_or(over);
  for (int c = threadIdx.x; c < SBC; c += NT)
    tr.crl[c] = clip_crl(over ? 32 : tr.crl[c], K, E);
  if (threadIdx.x < ROWS) {
    const int R = threadIdx.x;
    cw[s * SBC + (R >> 3) * 128 + 8 * r + (R & 7)] =
        over ? 32 : 32 - __clz((int)wor[R]);
  }
  __syncthreads();
  rank_tile(tr, E, r);
  cluster_wait();  // every block's planes are in place

  // 4. Pack the sorted columns 64r..64r+63: warp task (half, b) is 32
  // consecutive columns at slot b. A thread reads the nq plane quads of
  // slot b of the chunk that sorts to its column from the owner's buffer
  // and stores the K + E plane words; a warp has BATCH tasks' loads in
  // flight before it stores any.
  const long long plane = (long long)C * SBC;
  unsigned* bdst = base + s * K * plane;
  unsigned* rdst = resid + s * E * plane;
  for (int t0 = warp; t0 < 2 * C; t0 += BATCH * NW) {
    uint4 blk[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int task = t0 + u * NW;
      if (task >= 2 * C) break;
      const int c = tr.inv[((task & 1) << 5) | lane];
      const int R = row_in_owner(c);
      const uint4* rowq =
          cluster.map_shared_rank(rows_q, owner_of(c)) + R * RQ;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        blk[u][i] = i < nq ? quad_perm(rowq[quad_at(R, task >> 1, i)],
                                       swz(R) & 3)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int task = t0 + u * NW;
      if (task >= 2 * C) break;
      const long long at = (long long)(task >> 1) * SBC +
                           ((r << 6) | ((task & 1) << 5) | lane);
      const unsigned z[16] = {
          blk[u][0].x, blk[u][0].y, blk[u][0].z, blk[u][0].w,
          blk[u][1].x, blk[u][1].y, blk[u][1].z, blk[u][1].w,
          blk[u][2].x, blk[u][2].y, blk[u][2].z, blk[u][2].w,
          blk[u][3].x, blk[u][3].y, blk[u][3].z, blk[u][3].w};
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        if (p >= K + E) break;
        if (p < K)
          bdst[p * plane + at] = z[p];
        else
          rdst[(p - K) * plane + at] = z[p];
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its buffer
}

// K11, on K10's grid and clusters.
__global__ void __launch_bounds__(NT, 2)
v3_unpack_kernel(const unsigned* __restrict__ base,
                 const int* __restrict__ crl_g,
                 const unsigned* __restrict__ resid,
                 const float* __restrict__ rem, float q,
                 float* __restrict__ out, int Y, int Z, int nl, int K, int E) {
  extern __shared__ uint4 dyn[];  // the row buffer
  uint16_t* rows_s = reinterpret_cast<uint16_t*>(dyn);
  __shared__ float4 ob[2][ROWS * 2 * NW];  // output tiles, double-buffered
  __shared__ TileRank tr;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xi = lane >> 2, j = lane & 3;
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8, C = Z / 32, RW = Z / 2, RQ = Z / 8;
  const int nq = (K + E + 3) / 4;  // plane quads a slot
  const unsigned cmask = chain_mask(nl);
  const int k = __popc(cmask), RY = Y / 8 * k, RZ = Z / 8 * k;
  const long long s = (long long)blockIdx.y * (Y >> 7) + (blockIdx.x >> 4);

  cluster_arrive_relaxed();

  // 1. Rank the tile's crl.
  for (int c = threadIdx.x; c < SBC; c += NT) tr.crl[c] = crl_g[s * SBC + c];
  __syncthreads();
  rank_tile(tr, E, r);

  // 2. Unpack the sorted columns 64r..64r+63: a thread loads the plane
  // words of its (column, slot) and stores them as nq plane quads into
  // slot b of the chunk's row in the owner's buffer.
  const long long plane = (long long)C * SBC;
  const unsigned* bsrc = base + s * (K > 0 ? K : 1) * plane;
  const unsigned* rsrc = resid + s * E * plane;
  uint4* rows_q = dyn;
  cluster_wait();  // every block of the cluster has started
  for (int task = warp; task < 2 * C; task += NW) {
    const int col = ((task & 1) << 5) | lane, c = tr.inv[col];
    const long long at = (long long)(task >> 1) * SBC + ((r << 6) | col);
    unsigned z[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      unsigned word = 0u;
      if (p < K)
        word = __ldg(bsrc + p * plane + at);
      else if (p < K + E && tr.crl[c] > p - K)
        // plane K+i holds a word of this chunk only where crl > i
        word = __ldg(rsrc + (p - K) * plane + at);
      z[p] = word;
    }
    const int R = row_in_owner(c), sw = swz(R);
    uint4* rowq = cluster.map_shared_rank(rows_q, owner_of(c)) + R * RQ;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nq)
        rowq[quad_at(R, task >> 1, i)] = quad_perm(
            make_uint4(z[4 * i], z[4 * i + 1], z[4 * i + 2], z[4 * i + 3]),
            sw & 3);
  }
  cluster.sync();  // every block's rows hold their planes

  // 3. The block's own slots back to codes, in place.
  for (int t = threadIdx.x; t < ROWS * C; t += NT)
    planes_to_codes(rows_q + (t & 63) * RQ, t & 63, t >> 6, nq);
  __syncthreads();

  // 4. K4's line walk on the block's own rows; corners a tile ahead.
  const bool xin = in_chain(nl, xi);
  const bool ca = xin && in_chain(nl, 2 * j);
  const bool cb = xin && in_chain(nl, 2 * j + 1);
  const int Ra = 2 * lane, Rb = Ra + 1;
  float cra[8], crb[8];
  auto corners = [&](int jz) {
    line_corners(rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j, jz, 0), ca,
                 cmask, cra);
    line_corners(
        rem + rem_index(nl, k, RY, RZ, x0, y0, xi, 2 * j + 1, jz, 0), cb,
        cmask, crb);
  };
  corners(warp);
  float* out0 = out + row_of(x0, y0, Y, Z, 0);
  for (int t = 0; t < g / NW; ++t) {
    const int jz = t * NW + warp;
    Lines l;
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      l.a[z] = cra[z];
      l.b[z] = crb[z];
    }
    if (jz + NW < g) corners(jz + NW);
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      const bool on = (cmask >> z) & 1u;
      if (!(ca && on))
        l.a[z] = unzigzag_dequantize(*code_at(rows_s, RW, Ra, z * g + jz), q);
      if (!(cb && on))
        l.b[z] = unzigzag_dequantize(*code_at(rows_s, RW, Rb, z * g + jz), q);
    }
    recompose_lines(l, xi, j, nl);
    // One barrier a tile: ob is double-buffered, and a warp stages tile t
    // + 2 into this half only after every thread passed tile t + 1's
    // barrier, that is, finished storing tile t.
    stage_tile<NW>(ob[t & 1], l, warp, lane);
    __syncthreads();
    store_tile<NW>(ob[t & 1], out0 + 8 * NW * t, Y, Z);
  }
}

inline int row_bytes(int Z) { return ROWS * Z * (int)sizeof(uint16_t); }

// K10's and K11's function attributes, set once per device: the row buffer
// at the largest Z, and clusters of 16 (a size above the portable 8).
struct V3Attributes;
cudaError_t set_attributes() {
  return mgard_set_attributes<V3Attributes>(
      {(const void*)v3_pack_kernel, (const void*)v3_unpack_kernel},
      row_bytes(1024), true);
}

// The launch of K10 or K11 at depth Z on grid: clusters of 16 along x and
// the row buffer.
cudaLaunchConfig_t cluster_config(int Z, dim3 grid, cudaStream_t st,
                                  cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = row_bytes(Z);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

inline bool bad_shape(int X, int Y, int Z, int nl) {
  return X < 8 || X % 8 || Y < 128 || Y % 128 || Z < 128 || Z % 128 ||
         Z > 1024 || nl < 1 || nl > 3;
}

}  // namespace

// Shapes: X a multiple of 8, Y of 128, Z a multiple of 128 in [128, 1024],
// nl in 1..3, 1 <= K, 1 <= E <= 15, K + E <= 16; v 16-byte aligned.
// Outputs: base (NSB, K, C, 1024), resid (NSB, E, C, 1024), cw (NSB, 1024),
// rem; every word of base and resid is written.
MGARD_EXPORT int hybrid_pack_v3(const void* v, float inv_q, void* base,
                                void* resid, void* cw, void* rem, int X,
                                int Y, int Z, int nl, int K, int E,
                                void* stream) {
  if (bad_shape(X, Y, Z, nl) || K < 1 || E < 1 || E + 1 > MAX_B ||
      K + E > 16)
    return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(v)) return (int)cudaErrorMisalignedAddress;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(Z, dim3(Y / 8, X / 8), (cudaStream_t)stream, attr);
  cudaError_t e = set_attributes();
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, v3_pack_kernel, (const float*)v, inv_q,
                           (unsigned*)base, (unsigned*)resid, (int*)cw,
                           (float*)rem, Y, Z, nl, K, E);
  return mgard_launch_status(e);
}

// The mirror: base (NSB, max(K,1), C, 1024), crl (NSB, 1024), resid (NSB, E,
// C, 1024), rem -> out (X, Y, Z) float32, 16-byte aligned. K >= 0.
MGARD_EXPORT int hybrid_unpack_v3(const void* base, const void* crl,
                                  const void* resid, const void* rem, float q,
                                  void* out, int X, int Y, int Z, int nl,
                                  int K, int E, void* stream) {
  if (bad_shape(X, Y, Z, nl) || K < 0 || E < 1 || E + 1 > MAX_B ||
      K + E > 16)
    return (int)cudaErrorInvalidValue;
  if (!mgard_aligned16(out)) return (int)cudaErrorMisalignedAddress;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(Z, dim3(Y / 8, X / 8), (cudaStream_t)stream, attr);
  cudaError_t e = set_attributes();
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, v3_unpack_kernel, (const unsigned*)base,
                           (const int*)crl, (const unsigned*)resid,
                           (const float*)rem, q, (float*)out, Y, Z, nl, K, E);
  return mgard_launch_status(e);
}

// How many clusters of K10 (out[0]) and K11 (out[1]) the card holds at once
// at depth Z (cudaOccupancyMaxActiveClusters).
MGARD_EXPORT int hybrid_v3_max_clusters(int Z, int* out) {
  if (bad_shape(8, 128, Z, 1)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(Z, dim3(CLUSTER), 0, attr);
  cudaError_t e = set_attributes();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&out[0], v3_pack_kernel, &cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&out[1], v3_unpack_kernel, &cfg);
  return mgard_launch_status(e);
}
