// Shared definitions of the port's CUDA kernels (built by
// mgard_tpu_torch/kernels.py with nvcc for sm_90a, plain C entry points).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MGARD_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch (bad grid, too much shared
// memory) reaches the Python wrapper, which raises.
static inline int mgard_launch_status() { return (int)cudaGetLastError(); }

// Vector (16-byte) loads and stores need 16-byte aligned pointers; the
// entry points that use them return cudaErrorMisalignedAddress otherwise.
static inline bool mgard_aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}
