// K1 hybrid_fwd_v2 and K4 hybrid_inv_v2: the hybrid flag-1 ("v2") front end.
//
// Replaces the TPU kernels mgard_tpu/ops/hybrid.py::local_transform_fused_v2
// (body _fwd_kernel_v2_body) and ::local_inverse_fused_v2 (body
// _inv_kernel_v2_body). Plain versions: local_transform_v2 and
// local_inverse_v2 in mgard_tpu_torch/ops/hybrid.py, which the kernels match
// bit for bit (every float operation below is one rounded IEEE f32 operation
// in the plain version's order; the library is built with -fmad=false).
//
// What bounds them on the H100: both are memory-bound byte movers. K1 reads
// 4 bytes and writes 2 (+ 1/16 of a float for the remainder) per element;
// K4 the reverse. The 3-level stencil is ~20 flops per element, far below
// the card's ratio of flops to bytes.
//
// Design: one thread block owns an 8x8 (x, y) column of 8-blocks over the
// whole z axis and walks it in tiles of 8 whole 8^3 blocks (8 x 8 x 64), so
// the stencil never needs a halo and the per-chunk widths of its 64 (x, y)
// rows stay in shared memory until one final store (no global atomics).
// The TPU kernel's 0/1 selection matmul for the remainder and its bf16 byte
// matmuls for the z-class permutation become index arithmetic here. Global
// loads and stores run along z; the u16 payload is stored in grouped order
// in runs of 8 (one run per z class and tile).
#include "common.cuh"
#include "tile8.cuh"

namespace {

constexpr int MAX_H = 32;  // chunk rows per (x, y) row (Z <= 1024)

__global__ void __launch_bounds__(NT)
hybrid_fwd_v2_kernel(const float* __restrict__ v, float inv_q,
                     uint16_t* __restrict__ pay, int* __restrict__ cw,
                     float* __restrict__ rem, int X, int Y, int Z, int CL,
                     int H, int nl) {
  __shared__ float vs[TILE];
  __shared__ float ws[TILE];
  __shared__ unsigned wmax[64 * MAX_H];
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8;
  const int k = __popc(chain_mask(nl));
  const int RY = Y / 8 * k, RZ = Z / 8 * k;
  for (int i = threadIdx.x; i < 64 * H; i += NT) wmax[i] = 0u;

  for (int z0 = 0; z0 < Z; z0 += ZT) {
    __syncthreads();
    for (int e = threadIdx.x; e < TILE; e += NT) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, zi = e % ZT;
      vs[e] = v[((size_t)(x0 + xi) * Y + (y0 + yi)) * Z + z0 + zi];
    }
    __syncthreads();
    decompose_tile(vs, ws, nl);
    for (int o = threadIdx.x; o < TILE; o += NT) {
      int xi, yi, c, jj;
      payload_slot(o, xi, yi, c, jj);
      const float val = vs[(xi * 8 + yi) * ZT + 8 * jj + c];
      const int jz = (z0 >> 3) + jj;
      unsigned zz = 0u;
      if (in_chain(nl, xi) && in_chain(nl, yi) && in_chain(nl, c)) {
        rem[rem_index(nl, k, RY, RZ, x0, y0, xi, yi, jz, c)] = val;
      } else {
        zz = quantize_zigzag(val, inv_q);
      }
      const int gz = c * g + jz;
      pay[((size_t)(x0 + xi) * Y + (y0 + yi)) * Z + gz] = (uint16_t)(zz & 0xFFFFu);
      const unsigned w = zz ? 32u - (unsigned)__clz((int)zz) : 0u;
      unsigned* slot = &wmax[(xi * 8 + yi) * H + gz / CL];
      if (w > *slot) atomicMax(slot, w);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * H; i += NT) {
    const int col = i / H, h = i % H;
    cw[((size_t)(x0 + col / 8) * Y + (y0 + col % 8)) * H + h] = (int)wmax[i];
  }
}

__global__ void __launch_bounds__(NT)
hybrid_inv_v2_kernel(const uint16_t* __restrict__ pay,
                     const float* __restrict__ rem, float q,
                     float* __restrict__ out, int X, int Y, int Z, int nl) {
  __shared__ float xs[TILE];
  __shared__ float ys[TILE];
  const int x0 = blockIdx.y * 8, y0 = blockIdx.x * 8;
  const int g = Z / 8;
  const int k = __popc(chain_mask(nl));
  const int RY = Y / 8 * k, RZ = Z / 8 * k;

  for (int z0 = 0; z0 < Z; z0 += ZT) {
    __syncthreads();
    for (int o = threadIdx.x; o < TILE; o += NT) {
      int xi, yi, c, jj;
      payload_slot(o, xi, yi, c, jj);
      const int jz = (z0 >> 3) + jj;
      float val;
      if (in_chain(nl, xi) && in_chain(nl, yi) && in_chain(nl, c)) {
        val = rem[rem_index(nl, k, RY, RZ, x0, y0, xi, yi, jz, c)];
      } else {
        val = unzigzag_dequantize(
            pay[((size_t)(x0 + xi) * Y + (y0 + yi)) * Z + c * g + jz], q);
      }
      xs[(xi * 8 + yi) * ZT + 8 * jj + c] = val;
    }
    __syncthreads();
    recompose_tile(xs, ys, nl);
    for (int e = threadIdx.x; e < TILE; e += NT) {
      const int xi = e / (8 * ZT), yi = (e / ZT) & 7, zi = e % ZT;
      out[((size_t)(x0 + xi) * Y + (y0 + yi)) * Z + z0 + zi] = xs[e];
    }
  }
}

}  // namespace

MGARD_EXPORT const char* mgard_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Shapes are checked by the Python wrapper: X, Y multiples of 8, Z a
// multiple of 128 and at most 1024, C*32 divides Z, nl in 1..3.
MGARD_EXPORT int hybrid_fwd_v2(const void* v, float inv_q, void* pay, void* cw,
                               void* rem, int X, int Y, int Z, int C, int nl,
                               void* stream) {
  const int CL = C * 32, H = Z / CL;
  if (H > MAX_H) return (int)cudaErrorInvalidValue;
  dim3 grid(Y / 8, X / 8);
  hybrid_fwd_v2_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)v, inv_q, (uint16_t*)pay, (int*)cw, (float*)rem, X, Y, Z,
      CL, H, nl);
  return mgard_launch_status();
}

MGARD_EXPORT int hybrid_inv_v2(const void* pay, const void* rem, float q,
                               void* out, int X, int Y, int Z, int nl,
                               void* stream) {
  dim3 grid(Y / 8, X / 8);
  hybrid_inv_v2_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)pay, (const float*)rem, q, (float*)out, X, Y, Z, nl);
  return mgard_launch_status();
}
