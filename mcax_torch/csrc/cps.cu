// PHAT-weighted cross-power spectrum of gathered pair spectra.
//
// Replaces: mcax/kernels/cps.py, _cps_phat_pallas (the Pallas kernel
// _cps_phat_kernel): GCC-PHAT's whitening step (config1).
//
// What it computes.  For complex64 a, b of n elements (pair spectra that the
// caller gathered, any layout),
//     g = a * conj(b),   out = g / (|g| + eps)
// in the reference kernel's order: gr = ar*br + ai*bi, gi = ai*br - ar*bi,
// w = 1 / (sqrt(gr^2 + gi^2) + eps), out = (gr*w, gi*w).
//
// What bounds it on this card.  Two complex64 reads and one write per
// element against ~12 fp32 operations: memory-bound (config1, B = 512:
// 8192 x 257 elements, ~50 MB, ~0.015 ms at 3.35 TB/s).
//
// Design.  One thread per element, one float2 load per operand and one
// float2 store, consecutive threads on consecutive elements, so every
// access is coalesced.  Every operation is an explicitly rounded intrinsic
// (no contracted FMA, IEEE sqrt and divide), so the kernel performs the
// plain version's IEEE operations exactly.
#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) cps_phat_kernel(
    const float2* __restrict__ a, const float2* __restrict__ b,
    float2* __restrict__ g, long long n, float eps) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float2 x = a[i];
  const float2 y = b[i];
  const float gr = add(mul(x.x, y.x), mul(x.y, y.y));
  const float gi = sub(mul(x.y, y.x), mul(x.x, y.y));
  const float w =
      __fdiv_rn(1.0f, add(__fsqrt_rn(add(mul(gr, gr), mul(gi, gi))), eps));
  g[i] = make_float2(mul(gr, w), mul(gi, w));
}

}  // namespace

// a, b, g complex64 [n]; g may not alias a or b.
MCAX_API int mcax_cps_phat(const void* a, const void* b, void* g, long long n,
                           float eps, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)mcax::ceil_div(n, THREADS);
  cps_phat_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(b),
      static_cast<float2*>(g), n, eps);
  return (int)cudaGetLastError();
}
