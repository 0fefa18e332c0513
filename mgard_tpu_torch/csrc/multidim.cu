// K14 multidim_decompose / multidim_recompose: one MultiDim level step of a
// 3D field, float32 or float64, hierarchical or L2 (orthogonal) basis, on
// uniform or non-uniform coordinates.
//
// Replaces no TPU kernel: the JAX package runs the level step as XLA
// matmuls by dense operators (mgard_tpu/ops/refactor.py), which the port
// kept as torch.tensordot (ops/refactor.py::decompose_level_fast /
// recompose_level_fast). Those are its plain versions, and the CPU's route.
// A dense (nf x nf) interpolation matrix with two nonzeros a row, a 0/1
// reorder matrix, a dense (nc x nf) correction and a rotation copy after
// each product do ~1000 flops an element where the linear map needs tens.
//
// What bounds K14 on the H100: memory. Per level of fine volume V bytes:
// the residual pass reads the level box and writes it once (2V); the L2
// correction restricts the residual along each axis (V + V/2, V/2 + V/4,
// V/4 + V/8) and runs three Thomas sweeps on the coarse volume (each reads
// and writes V/8, twice where a line is longer than one 32-wide chunk,
// the last one adding into the coarse values). The recompose mirrors it.
//
// Design. Every axis is indexed in place through the strides of the
// nested-box layout: no permute, no rotation copy.
// - Residual pass (resid_kernel): a thread per pair of fine nodes
//   (2t, 2t+1) along the contiguous axis of one row (i, j). The tensor
//   product lerp takes at most 8 coarse neighbours, evaluated in the dense
//   path's order (axis 0 innermost); the row's class along axes 0 and 1 is
//   uniform across the block. The thread writes node 2t's residual to the
//   reordered position t and node 2t+1's to nc + t, so a warp's stores are
//   two contiguous runs; coarse values go to the coarse box (the next
//   level's input, or the leading box at level 1).
// - Restriction (restrict_kernel): the mass stencil and restriction along
//   one axis as one 5-point stencil a coarse node (weights built in
//   float64 on the host), each pass shrinking its axis nf -> nc; the
//   first reads the residual where the residual pass left it (the nested
//   box), with the all-coarse corner read as 0.
// - Thomas sweeps (thomas_kernel): a warp takes 32 lines and walks them in
//   chunks of 32 positions through a 32 x 33 shared tile, so that every
//   global load and store is a coalesced row: lines across the contiguous
//   axis for axes 0 and 1, and through a tile transpose for axis 2. The
//   last sweep adds (decompose) or subtracts (recompose) the correction
//   into the coarse values.
// - Interpolation pass (interp_kernel, recompose): the same pair schedule
//   as the residual pass, reading coarse values and residuals, writing the
//   fine box.
// The Python host side (ops/multidim.py) keeps the coarse values of each
// level in a compact buffer of their own, so no pass reads what another
// thread of the same pass writes.
#include "common.cuh"

namespace {

constexpr int NT = 128;
constexpr int GRID_Y_MAX = 65535;

// One axis of one level step; the tables are device pointers into the
// level's table (ops/multidim.py::level_table): wl, wr (ncoef), W (nc, 5),
// f, binv, g (nc).
template <typename T>
struct Axis {
  int nf, nc, ncoef, ghost;
  const T* wl;
  const T* wr;
  const T* W;
  const T* f;
  const T* binv;
  const T* g;
};

template <typename T>
Axis<T> axis_at(const T*& tab, int nf) {
  Axis<T> a;
  a.nf = nf;
  a.nc = nf / 2 + 1;
  a.ncoef = nf - a.nc;
  a.ghost = (nf % 2 == 0 && nf != 2) ? 1 : 0;
  a.wl = tab;
  a.wr = a.wl + a.ncoef;
  a.W = a.wr + a.ncoef;
  a.f = a.W + 5 * a.nc;
  a.binv = a.f + a.nc;
  a.g = a.binv + a.nc;
  tab = a.g + a.nc;
  return a;
}

// A coefficient node: odd and not the last node of an even axis.
__device__ __forceinline__ bool is_coef(int i, int nf) {
  return (i & 1) && i < nf - 1;
}

// Position of fine node i in the reordered axis: coarse nodes first (their
// coarse index), then the coefficients.
__device__ __forceinline__ int reo(int i, int nf, int nc) {
  return is_coef(i, nf) ? nc + (i >> 1) : (i == nf - 1 ? nc - 1 : (i >> 1));
}

// Physical node of extended node e (the zero ghost of an even axis sits
// before the last node), or -1 where the extended grid has no value.
__device__ __forceinline__ int phys(int e, int nf, int ghost) {
  if (e < 0 || e >= nf + ghost || (ghost && e == nf - 1)) return -1;
  return (ghost && e == nf) ? nf - 1 : e;
}

template <typename T>
__device__ __forceinline__ T lerp2(T wl, T a, T wr, T b) {
  return wl * a + wr * b;
}

// Decompose, residual pass: v is the compact fine box (nf0, nf1, nf2);
// residuals go to out (strides S0, S1, 1) at their reordered positions,
// coarse values to cd (strides C0, C1, 1) at their coarse indices.
template <typename T>
__global__ void __launch_bounds__(NT)
resid_kernel(const T* __restrict__ v, T* __restrict__ out, long long S0,
             long long S1, T* __restrict__ cd, long long C0, long long C1,
             Axis<T> a0, Axis<T> a1, Axis<T> a2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (a2.nf + 1) >> 1) return;
  const long long rows = (long long)a0.nf * a1.nf;
  const long long P0 = (long long)a1.nf * a2.nf;
  const long long P1 = a2.nf;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < rows; r += (long long)gridDim.y * blockDim.y) {
    const int i = (int)(r / a1.nf);
    const int j = (int)(r - (long long)i * a1.nf);
    const bool ci = is_coef(i, a0.nf), cj = is_coef(j, a1.nf);
    const T wl0 = ci ? a0.wl[i >> 1] : T(0), wr0 = ci ? a0.wr[i >> 1] : T(0);
    const T wl1 = cj ? a1.wl[j >> 1] : T(0), wr1 = cj ? a1.wr[j >> 1] : T(0);
    const T* row = v + i * P0 + j * P1;
    // the lerps of axes 0 and 1 at column k of this row, axis 0 innermost
    auto A = [&](const T* p) -> T {
      return ci ? lerp2(wl0, p[-P0], wr0, p[P0]) : p[0];
    };
    auto X = [&](int k) -> T {
      const T* p = row + k;
      return cj ? lerp2(wl1, A(p - P1), wr1, A(p + P1)) : A(p);
    };
    const bool corner = !ci && !cj;
    const int ri = reo(i, a0.nf, a0.nc), rj = reo(j, a1.nf, a1.nc);
    const long long o = ri * S0 + rj * S1;
    // a coarse node's reordered position is its coarse index
    const long long oc0 = ri * C0 + rj * C1;
    const int k0 = 2 * t;
    const T x0 = X(k0);
    const T v0 = row[k0];
    if (corner)
      cd[oc0 + t] = v0;
    else
      out[o + t] = v0 - x0;
    const int k1 = k0 + 1;
    if (k1 < a2.nf) {
      const T v1 = row[k1];
      if (t < a2.ncoef) {
        const T x1 = lerp2(a2.wl[t], x0, a2.wr[t], X(k0 + 2));
        out[o + a2.nc + t] = v1 - x1;
      } else if (corner) {  // the last node of an even axis: coarse
        cd[oc0 + a2.nc - 1] = v1;
      } else {
        out[o + a2.nc - 1] = v1 - X(k1);
      }
    }
  }
}

// Recompose, interpolation pass: c is the compact coarse box (nc0, nc1,
// nc2) with the correction already taken off; residuals are read from dec
// (strides S0, S1, 1) at their reordered positions; the fine box goes to
// the compact dst (nf0, nf1, nf2).
template <typename T>
__global__ void __launch_bounds__(NT)
interp_kernel(const T* __restrict__ dec, long long S0, long long S1,
              const T* __restrict__ c, T* __restrict__ dst, Axis<T> a0,
              Axis<T> a1, Axis<T> a2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (a2.nf + 1) >> 1) return;
  const long long rows = (long long)a0.nf * a1.nf;
  const long long P0 = (long long)a1.nf * a2.nf;
  const long long P1 = a2.nf;
  const long long Q0 = (long long)a1.nc * a2.nc;
  const long long Q1 = a2.nc;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < rows; r += (long long)gridDim.y * blockDim.y) {
    const int i = (int)(r / a1.nf);
    const int j = (int)(r - (long long)i * a1.nf);
    const bool ci = is_coef(i, a0.nf), cj = is_coef(j, a1.nf);
    const T wl0 = ci ? a0.wl[i >> 1] : T(0), wr0 = ci ? a0.wr[i >> 1] : T(0);
    const T wl1 = cj ? a1.wl[j >> 1] : T(0), wr1 = cj ? a1.wr[j >> 1] : T(0);
    // coarse row of node i: its own, or the left neighbour of a coefficient
    const int i0 = ci ? (i >> 1) : reo(i, a0.nf, a0.nc);
    const int j0 = cj ? (j >> 1) : reo(j, a1.nf, a1.nc);
    const T* crow = c + i0 * Q0 + j0 * Q1;
    auto A = [&](const T* p) -> T {
      return ci ? lerp2(wl0, p[0], wr0, p[Q0]) : p[0];
    };
    auto X = [&](int kc) -> T {
      const T* p = crow + kc;
      return cj ? lerp2(wl1, A(p), wr1, A(p + Q1)) : A(p);
    };
    const bool corner = !ci && !cj;
    const long long o = reo(i, a0.nf, a0.nc) * S0 + reo(j, a1.nf, a1.nc) * S1;
    T* drow = dst + i * P0 + j * P1;
    const int k0 = 2 * t;
    const T x0 = X(t);
    drow[k0] = corner ? x0 : x0 + dec[o + t];
    const int k1 = k0 + 1;
    if (k1 < a2.nf) {
      if (t < a2.ncoef) {
        const T x1 = lerp2(a2.wl[t], x0, a2.wr[t], X(t + 1));
        drow[k1] = x1 + dec[o + a2.nc + t];
      } else {  // the last node of an even axis: coarse
        const T x1 = X(a2.nc - 1);
        drow[k1] = corner ? x1 : x1 + dec[o + a2.nc - 1];
      }
    }
  }
}

// Mass stencil and restriction along axis AX as one 5-point stencil a
// coarse node. REO (AX == 0 only): the input is the residual in the nested
// box (strides S0, S1, 1), with the all-coarse corner read as 0; otherwise
// the compact input (n0, n1, n2). The output is compact, axis AX shrunk to
// nc. A thread per output element, the contiguous axis across threads.
template <typename T, int AX, bool REO>
__global__ void __launch_bounds__(NT)
restrict_kernel(const T* __restrict__ in, long long S0, long long S1,
                T* __restrict__ outp, int n0, int n1, int n2, Axis<T> ax,
                Axis<T> b1, Axis<T> b2) {
  const int o0 = AX == 0 ? ax.nc : n0;
  const int o1 = AX == 1 ? ax.nc : n1;
  const int o2 = AX == 2 ? ax.nc : n2;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= o2) return;
  const long long rows = (long long)o0 * o1;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < rows; r += (long long)gridDim.y * blockDim.y) {
    const int a = (int)(r / o1);
    const int b = (int)(r - (long long)a * o1);
    const int jc = AX == 0 ? a : (AX == 1 ? b : z);  // the coarse node
    const T* W = ax.W + 5 * jc;
    T acc = T(0);
    if (REO) {
      const bool cbz = !is_coef(b, b1.nf) && !is_coef(z, b2.nf);
      const long long oyz = reo(b, b1.nf, b1.nc) * S1 + reo(z, b2.nf, b2.nc);
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int i = phys(2 * jc + q - 2, ax.nf, ax.ghost);
        if (i < 0) continue;
        const T x = (cbz && !is_coef(i, ax.nf))
                        ? T(0)
                        : in[reo(i, ax.nf, ax.nc) * S0 + oyz];
        acc = acc + W[q] * x;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int e = phys(2 * jc + q - 2, ax.nf, ax.ghost);
        if (e < 0) continue;
        const long long idx =
            AX == 1 ? ((long long)a * n1 + e) * n2 + z
                    : ((long long)a * n1 + b) * n2 + e;
        acc = acc + W[q] * in[idx];
      }
    }
    outp[((long long)a * o1 + b) * o2 + z] = acc;
  }
}

// Thomas forward and backward sweeps of the coarse mass matrix along lines
// of n positions, in place: y_p = d_p + f_p y_{p-1}, then
// x_p = y_p binv_p + g_p x_{p+1}. CONTIG: line L is row L of x (positions
// contiguous), and the result is added to c at row (L / nb, L % nb)
// (strides C0, C1, 1) times sign; otherwise line L starts at
// (L / inner) * outer + L % inner with positions `stride` apart, and the
// result stays in x. A warp owns 32 lines; chunks of 32 positions go
// through the tile tl[position][line], loaded and stored as coalesced
// rows.
template <typename T, bool CONTIG>
__global__ void __launch_bounds__(NT)
thomas_kernel(T* __restrict__ x, long long nlines, int n, long long inner,
              long long outer, long long stride, const T* __restrict__ f,
              const T* __restrict__ binv, const T* __restrict__ g,
              T* __restrict__ c, long long C0, long long C1, long long nb,
              T sign) {
  __shared__ T tile[NT / 32][32][33];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T(*tl)[33] = tile[w];
  const long long L0 = ((long long)blockIdx.x * (NT / 32) + w) * 32;
  if (L0 >= nlines) return;  // the whole warp: only __syncwarp below
  const int nch = (n + 31) >> 5;
  // element (line L0 + l, position p)
  long long base = 0;  // strided: this lane's line start
  if (!CONTIG && L0 + lane < nlines) {
    const long long L = L0 + lane;
    const long long q = L / inner;
    base = q * outer + (L - q * inner);
  }
  auto load = [&](int c0) {
    if (CONTIG) {
      for (int l = 0; l < 32; ++l) {
        const int p = c0 + lane;
        if (L0 + l < nlines && p < n) tl[lane][l] = x[(L0 + l) * n + p];
      }
    } else {
      for (int p = 0; p < 32 && c0 + p < n; ++p)
        if (L0 + lane < nlines) tl[p][lane] = x[base + (c0 + p) * stride];
    }
  };
  auto store = [&](int c0) {
    if (CONTIG) {
      for (int l = 0; l < 32; ++l) {
        const int p = c0 + lane;
        if (L0 + l < nlines && p < n) x[(L0 + l) * n + p] = tl[lane][l];
      }
    } else {
      for (int p = 0; p < 32 && c0 + p < n; ++p)
        if (L0 + lane < nlines) x[base + (c0 + p) * stride] = tl[p][lane];
    }
  };
  T y = T(0);
  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = ch * 32;
    load(c0);
    __syncwarp();
    for (int p = 0; p < 32 && c0 + p < n; ++p) {
      const int col = c0 + p;
      const T d = tl[p][lane];
      y = col == 0 ? d : d + f[col] * y;
      tl[p][lane] = y;
    }
    __syncwarp();
    if (nch > 1) store(c0);
    __syncwarp();
  }
  T xn = T(0);
  long long a = 0, b = 0;
  if (CONTIG) {
    a = L0 / nb;
    b = L0 - a * nb;
  }
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int c0 = ch * 32;
    if (nch > 1) {
      load(c0);
      __syncwarp();
    }
    for (int p = min(31, n - 1 - c0); p >= 0; --p) {
      const int col = c0 + p;
      const T d = tl[p][lane] * binv[col];
      xn = col == n - 1 ? d : d + g[col] * xn;
      tl[p][lane] = xn;
    }
    __syncwarp();
    if (CONTIG) {
      long long aa = a, bb = b;
      for (int l = 0; l < 32 && L0 + l < nlines; ++l) {
        const int p = c0 + lane;
        if (p < n) {
          T* q = c + aa * C0 + bb * C1 + p;
          *q = *q + sign * tl[lane][l];
        }
        if (++bb == nb) {
          bb = 0;
          ++aa;
        }
      }
    } else {
      store(c0);
    }
    __syncwarp();
  }
}

dim3 block_for(int nx) {
  int bx = 32;
  while (bx < nx && bx < NT) bx <<= 1;
  return dim3(bx, NT / bx);
}

dim3 grid_for(int nx, long long rows, dim3 b) {
  const long long gy = (rows + b.y - 1) / b.y;
  return dim3((nx + b.x - 1) / b.x,
              (unsigned)(gy < GRID_Y_MAX ? gy : GRID_Y_MAX));
}

template <typename T, int AX, bool REO>
void restrict_axis(const T* in, long long S0, long long S1, T* outp, int n0,
                   int n1, int n2, const Axis<T>& ax, const Axis<T>& b1,
                   const Axis<T>& b2, cudaStream_t s) {
  const int o0 = AX == 0 ? ax.nc : n0, o1 = AX == 1 ? ax.nc : n1;
  const int o2 = AX == 2 ? ax.nc : n2;
  const dim3 b = block_for(o2);
  restrict_kernel<T, AX, REO><<<grid_for(o2, (long long)o0 * o1, b), b, 0,
                                 s>>>(in, S0, S1, outp, n0, n1, n2, ax, b1,
                                      b2);
}

// The L2 correction of one level: restrict the residual r (nested box,
// strides S0, S1) along axes 0, 1, 2 into the scratch, solve along axes
// 0, 1, 2, and add sign times the result into the coarse box c (strides
// C0, C1, 1). Scratch: t1 (nc0, nf1, nf2), t2 (nc0, nc1, nf2), t3 (nc0,
// nc1, nc2), back to back.
template <typename T>
void correction(const T* r, long long S0, long long S1, T* c, long long C0,
                long long C1, T sign, T* scr, const Axis<T>& a0,
                const Axis<T>& a1, const Axis<T>& a2, cudaStream_t s) {
  T* t1 = scr;
  T* t2 = t1 + (long long)a0.nc * a1.nf * a2.nf;
  T* t3 = t2 + (long long)a0.nc * a1.nc * a2.nf;
  restrict_axis<T, 0, true>(r, S0, S1, t1, a0.nf, a1.nf, a2.nf, a0, a1, a2,
                            s);
  restrict_axis<T, 1, false>(t1, 0, 0, t2, a0.nc, a1.nf, a2.nf, a1, a1, a2,
                             s);
  restrict_axis<T, 2, false>(t2, 0, 0, t3, a0.nc, a1.nc, a2.nf, a2, a1, a2,
                             s);
  const long long plane = (long long)a1.nc * a2.nc;
  const long long lines0 = plane, lines1 = (long long)a0.nc * a2.nc;
  const long long lines2 = (long long)a0.nc * a1.nc;
  const int per = NT;  // lines a block: four warps of 32
  thomas_kernel<T, false><<<(unsigned)((lines0 + per - 1) / per), NT, 0, s>>>(
      t3, lines0, a0.nc, lines0, 0, plane, a0.f, a0.binv, a0.g, nullptr, 0,
      0, 1, sign);
  thomas_kernel<T, false><<<(unsigned)((lines1 + per - 1) / per), NT, 0, s>>>(
      t3, lines1, a1.nc, a2.nc, plane, a2.nc, a1.f, a1.binv, a1.g, nullptr,
      0, 0, 1, sign);
  thomas_kernel<T, true><<<(unsigned)((lines2 + per - 1) / per), NT, 0, s>>>(
      t3, lines2, a2.nc, 0, 0, 1, a2.f, a2.binv, a2.g, c, C0, C1, a1.nc,
      sign);
}

template <typename T>
int decompose_level(const T* v, T* out, long long S0, long long S1, T* cd,
                    long long C0, long long C1, const T* tab, T* scr, int n0,
                    int n1, int n2, int orthogonal, cudaStream_t s) {
  const Axis<T> a0 = axis_at(tab, n0), a1 = axis_at(tab, n1),
                a2 = axis_at(tab, n2);
  const int np = (n2 + 1) / 2;
  const dim3 b = block_for(np);
  resid_kernel<T><<<grid_for(np, (long long)n0 * n1, b), b, 0, s>>>(
      v, out, S0, S1, cd, C0, C1, a0, a1, a2);
  if (orthogonal)
    correction<T>(out, S0, S1, cd, C0, C1, T(1), scr, a0, a1, a2, s);
  return mgard_launch_status();
}

template <typename T>
int recompose_level(const T* dec, long long S0, long long S1, T* c, T* dst,
                    const T* tab, T* scr, int n0, int n1, int n2,
                    int orthogonal, cudaStream_t s) {
  const Axis<T> a0 = axis_at(tab, n0), a1 = axis_at(tab, n1),
                a2 = axis_at(tab, n2);
  if (orthogonal)
    correction<T>(dec, S0, S1, c, (long long)a1.nc * a2.nc, a2.nc, T(-1), scr,
                  a0, a1, a2, s);
  const int np = (n2 + 1) / 2;
  const dim3 b = block_for(np);
  interp_kernel<T><<<grid_for(np, (long long)n0 * n1, b), b, 0, s>>>(
      dec, S0, S1, c, dst, a0, a1, a2);
  return mgard_launch_status();
}

}  // namespace

// v: the compact fine box (n0, n1, n2); out: the transform's output
// (strides S0, S1, 1), the level's residuals at their nested-box
// positions; cd: the coarse box (strides C0, C1, 1); tab: the level's
// table; scr: the correction's scratch (orthogonal only). f64 selects
// double.
MGARD_EXPORT int multidim_decompose(const void* v, void* out, long long S0,
                                    long long S1, void* cd, long long C0,
                                    long long C1, const void* tab, void* scr,
                                    int n0, int n1, int n2, int orthogonal,
                                    int f64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return decompose_level<double>((const double*)v, (double*)out, S0, S1,
                                   (double*)cd, C0, C1, (const double*)tab,
                                   (double*)scr, n0, n1, n2, orthogonal, s);
  return decompose_level<float>((const float*)v, (float*)out, S0, S1,
                                (float*)cd, C0, C1, (const float*)tab,
                                (float*)scr, n0, n1, n2, orthogonal, s);
}

// dec: the decomposed array (strides S0, S1, 1); c: the compact coarse box
// (nc0, nc1, nc2), which the correction changes in place; dst: the compact
// fine box (n0, n1, n2).
MGARD_EXPORT int multidim_recompose(const void* dec, long long S0,
                                    long long S1, void* c, void* dst,
                                    const void* tab, void* scr, int n0,
                                    int n1, int n2, int orthogonal, int f64,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return recompose_level<double>((const double*)dec, S0, S1, (double*)c,
                                   (double*)dst, (const double*)tab,
                                   (double*)scr, n0, n1, n2, orthogonal, s);
  return recompose_level<float>((const float*)dec, S0, S1, (float*)c,
                                (float*)dst, (const float*)tab, (float*)scr,
                                n0, n1, n2, orthogonal, s);
}
