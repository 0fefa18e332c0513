// Shared definitions of the port's CUDA kernels (built by
// mgard_tpu_torch/kernels.py with nvcc for sm_90a, plain C entry points).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#define MGARD_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch (bad grid, too much shared
// memory) reaches the Python wrapper, which raises.
static inline int mgard_launch_status() { return (int)cudaGetLastError(); }

// For entry points that launch through a call returning an error (cluster
// launches, attribute setup): a refused launch returns its error and leaves
// none pending for the next entry point's cudaGetLastError.
static inline int mgard_launch_status(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return mgard_launch_status();
}

// Sets the kernels' dynamic shared memory limit to smem bytes and, with
// clusters, allows clusters above the portable 8; once per device (Tag
// gives each entry point's kernels their own record).
template <class Tag>
cudaError_t mgard_set_attributes(std::initializer_list<const void*> kernels,
                                 int smem, bool clusters) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[d].load(std::memory_order_acquire)) return cudaSuccess;
  for (const void* kernel : kernels) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess && clusters)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  done[d].store(true, std::memory_order_release);
  return cudaSuccess;
}

// Vector (16-byte) loads and stores need 16-byte aligned pointers; the
// entry points that use them return cudaErrorMisalignedAddress otherwise.
static inline bool mgard_aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}
