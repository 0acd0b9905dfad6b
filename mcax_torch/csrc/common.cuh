// Shared helpers of the port's CUDA kernels (compiled for sm_90a).
//
// Every C entry point has a plain C interface (bound from Python through
// ctypes), launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so that a refused launch
// (too many threads, too much shared memory) reaches the Python wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MCAX_API extern "C" __attribute__((visibility("default")))

namespace mcax {

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

}  // namespace mcax
