// MVDR weight solve per (block, bin), from either covariance layout.
//
// Replaces: mcax/kernels/mvdrsolve.py, weights_blocks_fused_rows (the
// Pallas kernel _kernel_rows: covariance-prefix rows, the batched path) and
// weights_blocks_fused (the Pallas kernel _kernel: complex [B, F, C, C]
// covariances, the block step and the multi-stream step), both around the
// one solve _solve_math.
//
// What it computes.  For each (block b, bin f): R = the covariance; diagonal
// loading R += delta*tr(R)/C * I; a complex Cholesky R = L L^H with a real
// pivot sqrt(max(., 1e-30)); for each of the S sources, forward (L y = d)
// and adjoint (L^H z = y) substitution and
//     w = z / (d^H z),
// where a denominator with |d^H z| <= 1e-12 is replaced by 1e-12 + 0j.  One
// factorisation is shared by all sources.  The arithmetic follows the
// reference's _solve_math operation for operation, in fp32.  The two entry
// points differ only in how the lower triangle of R is loaded:
//   * rows [B, 2C^2, F] (row i*C+j = Re R[i,j], C^2+i*C+j = Im R[i,j]);
//   * complex64 [B, F, C, C], interleaved re/im.
//
// What bounds it on this card.  The solve reads only the lower triangle.
// In the rows layout that is C(C+1)/2 real rows and C(C-1)/2 imaginary rows
// of the 2C^2 per (block, bin), each a contiguous run over F, so the
// skipped rows cost no bytes; with the steering read and the weights
// written that is ~0.10 GB at config4, B = 512 (~0.03 ms at 3.35 TB/s),
// against ~0.1 GFLOP per source of solve arithmetic: memory-bound.  The
// complex layout is read as C(C+1)/2 float2 elements per (block, bin); at
// the block step's B = 1 (513 bins) the call is bound by its launch.
//
// Design.  One thread per (block, bin), consecutive threads on consecutive
// bins so every rows read and weight write is coalesced (a complex-layout
// thread reads its own 512-byte matrix: uncoalesced, but each 32-byte
// sector it touches is used).  C is a template parameter (only 8,
// config4's, is instantiated), so the loops unroll fully and the Cholesky
// factor lives in registers.  Every multiply, add and subtract is an
// explicitly rounded intrinsic that the compiler never contracts into an
// FMA: the loaded covariance of a near-rank-1 scene has a condition number
// in the thousands, which amplifies a one-ulp difference per operation into
// ~1e-3 of the weights, so the kernel performs exactly the IEEE operations
// of the plain version, in the same order.
#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The lower triangle (j <= i) of R for (block b, bin f), as (re, im); the
// imaginary part of the diagonal is never used and reads as 0.
template <int C>
struct RowsLayout {
  const float* rows;  // [B, 2C^2, F]
  int F;
  __device__ float2 operator()(int b, int f, int i, int j) const {
    const float* R = rows + (long long)b * 2 * C * C * F + f;
    return make_float2(R[(long long)(i * C + j) * F],
                       j < i ? R[(long long)(C * C + i * C + j) * F] : 0.0f);
  }
};

template <int C>
struct ComplexLayout {
  const float2* covs;  // [B, F, C, C]
  int F;
  __device__ float2 operator()(int b, int f, int i, int j) const {
    const float2 v = covs[(((long long)b * F + f) * C + i) * C + j];
    return make_float2(v.x, j < i ? v.y : 0.0f);
  }
};

template <int C, class Layout>
__global__ void __launch_bounds__(128) mvdr_solve_kernel(
    Layout cov, const float2* __restrict__ steer, float2* __restrict__ w,
    int B, int S, int F, float load_scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx % F);

  // Lower triangle of R (j <= i), factorised in place into L.
  float lr[C][C], li[C][C];
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float2 v = cov(b, f, i, j);
      lr[i][j] = v.x;
      li[i][j] = v.y;
    }

  float tr = lr[0][0];
#pragma unroll
  for (int j = 1; j < C; ++j) tr = add(tr, lr[j][j]);
  const float load = mul(load_scale, tr);
#pragma unroll
  for (int j = 0; j < C; ++j) lr[j][j] = add(lr[j][j], load);

  float linv[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const float piv = __fsqrt_rn(fmaxf(lr[j][j], 1e-30f));
    const float inv = __fdiv_rn(1.0f, piv);
    linv[j] = inv;
#pragma unroll
    for (int i = j + 1; i < C; ++i) {
      lr[i][j] = mul(lr[i][j], inv);
      li[i][j] = mul(li[i][j], inv);
    }
#pragma unroll
    for (int i = j + 1; i < C; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k) {
        // R[i,k] -= L[i,j] * conj(L[k,j])
        const float br = lr[i][j], bi = li[i][j];
        const float cr = lr[k][j], ci = li[k][j];
        lr[i][k] = sub(lr[i][k], add(mul(br, cr), mul(bi, ci)));
        li[i][k] = sub(li[i][k], sub(mul(bi, cr), mul(br, ci)));
      }
  }

  for (int s = 0; s < S; ++s) {
    const long long off = ((long long)b * S + s) * C * F + f;
    float dr[C], di[C], yr[C], yi[C], zr[C], zi[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float2 v = steer[off + (long long)k * F];
      dr[k] = v.x;
      di[k] = v.y;
    }
    // forward: L y = d
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float ar = dr[k], ai = di[k];
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const float br = lr[k][j], bi = li[k][j];
        ar = sub(ar, sub(mul(br, yr[j]), mul(bi, yi[j])));
        ai = sub(ai, add(mul(br, yi[j]), mul(bi, yr[j])));
      }
      yr[k] = mul(ar, linv[k]);
      yi[k] = mul(ai, linv[k]);
    }
    // adjoint: L^H z = y
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      float ar = yr[k], ai = yi[k];
#pragma unroll
      for (int j = k + 1; j < C; ++j) {
        // conj(L[j,k]) * z[j]
        const float br = lr[j][k], bi = li[j][k];
        ar = sub(ar, add(mul(br, zr[j]), mul(bi, zi[j])));
        ai = sub(ai, sub(mul(br, zi[j]), mul(bi, zr[j])));
      }
      zr[k] = mul(ar, linv[k]);
      zi[k] = mul(ai, linv[k]);
    }
    // denom = d^H z, guarded; w = z / denom
    float nr = 0.0f, ni = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      nr = add(nr, add(mul(dr[k], zr[k]), mul(di[k], zi[k])));
      ni = add(ni, sub(mul(dr[k], zi[k]), mul(di[k], zr[k])));
    }
    const bool ok = __fsqrt_rn(add(mul(nr, nr), mul(ni, ni))) > 1e-12f;
    nr = ok ? nr : 1e-12f;
    ni = ok ? ni : 0.0f;
    const float sc = __fdiv_rn(1.0f, add(mul(nr, nr), mul(ni, ni)));
#pragma unroll
    for (int k = 0; k < C; ++k)
      w[off + (long long)k * F] =
          make_float2(mul(add(mul(zr[k], nr), mul(zi[k], ni)), sc),
                      mul(sub(mul(zi[k], nr), mul(zr[k], ni)), sc));
  }
}

template <int C, class Layout>
int launch(const Layout& cov, const void* steer, void* w, int B, int S, int F,
           float load_scale, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)mcax::ceil_div((long long)B * F, threads);
  mvdr_solve_kernel<C, Layout><<<blocks, threads, 0, stream>>>(
      cov, static_cast<const float2*>(steer), static_cast<float2*>(w), B, S,
      F, load_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [B, 2C^2, F], steer complex64 [B, S, C, F], w complex64 [B, S, C, F];
// load_scale = float32(delta / C).  C must be 8.
MCAX_API int mcax_mvdr_solve_rows(const float* rows, const void* steer,
                                  void* w, int B, int S, int C, int F,
                                  float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8:
      return launch<8>(RowsLayout<8>{rows, F}, steer, w, B, S, F, load_scale,
                       st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// covs complex64 [B, F, C, C], steer and w as above.  C must be 8.
MCAX_API int mcax_mvdr_solve_complex(const void* covs, const void* steer,
                                     void* w, int B, int S, int C, int F,
                                     float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8:
      return launch<8>(
          ComplexLayout<8>{static_cast<const float2*>(covs), F}, steer, w, B,
          S, F, load_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
