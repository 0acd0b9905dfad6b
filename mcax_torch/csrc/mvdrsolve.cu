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
// reference's _solve_math operation for operation, in fp32.
//
// What bounds it on this card.  The solve reads only the lower triangle.
// In the rows layout that is C(C+1)/2 real rows and C(C-1)/2 imaginary rows
// of the 2C^2 per (block, bin), each a contiguous run over F, so the
// skipped rows cost no bytes; with the steering read and the weights
// written that is ~0.10 GB at config4, B = 512 (~0.03 ms at 3.35 TB/s),
// against ~0.1 GFLOP per source of solve arithmetic: memory-bound.  The
// complex layout at S = 64 streams is ~17 MB (~0.005 ms); at the block
// step's B = 1 (513 bins) the call is bound by its launch and by the
// solve's serial chain.
//
// Two designs, one arithmetic:
//   * the rows layout (kernel 4, mvdr_solve_kernel): one thread per
//     (block, bin), consecutive threads on consecutive bins so every rows
//     read and weight write is coalesced.  At C = 8 a thread's working set
//     lives in registers, the loops unrolled, 128 threads a block; at
//     C = 16 it does not fit (SolveShape below) and lives in shared memory
//     laid out [element][thread], the loops rolled, 32 threads a block.
//   * the complex layout (kernel 6, mvdr_group_kernel): a group of C lanes
//     per (block, bin), lane i holding row i of the lower triangle in
//     registers (2C floats), 32/C systems a warp, 128 threads a block.  The
//     group's C x C matrix is C^2 contiguous float2, so a warp stages its
//     systems with 16-byte coalesced loads through shared memory (rows
//     padded to 2C+2 floats: conflict-free 8-byte reads) before each lane
//     takes its row (ComplexRows, the loader, a template parameter so that
//     a rows-layout loader can take its place).  The trace is gathered by
//     __shfl_sync in the order j = 0..C-1.  For column j, lane j makes the
//     pivot and its reciprocal and broadcasts it, lanes i > j scale L[i,j],
//     and each lane i updates its own R[i,k], j < k <= i, with L[k,j]
//     fetched from lane k.  The forward substitution keeps lane k's
//     accumulator of y[k] and subtracts L[k,j] y[j] as lane j broadcasts
//     y[j], j ascending: the plain version's single accumulator and order.
//     The adjoint and d^H z form their per-term products in parallel, one
//     in each lane, and one lane (every lane, for d^H z) subtracts or adds
//     them in the plain version's order.  The steering reads and the weight
//     stores go through shared memory, so each is a run over F of the
//     block's 128/C systems in the [B, S, C, F] layout.
// Every multiply, add and subtract is an explicitly rounded intrinsic that
// the compiler never contracts into an FMA: the loaded covariance of a
// near-rank-1 scene has a condition number in the thousands, which
// amplifies a one-ulp difference per operation into ~1e-3 of the weights,
// so both kernels perform exactly the IEEE operations of the plain
// version, in the same order, wherever the factor is stored: bit-equal.
#include <type_traits>

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

// A thread's working set: the lower triangle (j <= i) of the factor, the
// reciprocal pivots, the steering vector d and the substitution vector,
// which holds y and then, in place, z (z[k] is written after y[k]'s last
// read).  In registers: every index must be a compile-time constant, so
// the loops unroll fully.
template <int C>
struct RegisterStore {
  float lr[C][C], li[C][C], inv[C], d_r[C], d_i[C], v_r[C], v_i[C];
  __device__ float& re(int i, int j) { return lr[i][j]; }
  __device__ float& im(int i, int j) { return li[i][j]; }
  __device__ float& linv(int j) { return inv[j]; }
  __device__ float& dr(int k) { return d_r[k]; }
  __device__ float& di(int k) { return d_i[k]; }
  __device__ float& yr(int k) { return v_r[k]; }
  __device__ float& yi(int k) { return v_i[k]; }
};

// The same in shared memory, laid out [element][thread] (element e of
// thread t at smem[e * blockDim.x + t], so each access is one
// conflict-free row of the block): any index may be a run-time value.
template <int C>
struct SharedStore {
  static constexpr int kTri = C * (C + 1) / 2;
  static constexpr int kFloats = 2 * kTri + 5 * C;  // per thread
  float* base;                                      // smem + threadIdx.x
  int stride;                                       // blockDim.x
  __device__ float& at(int e) { return base[e * stride]; }
  __device__ float& re(int i, int j) { return at(2 * (i * (i + 1) / 2 + j)); }
  __device__ float& im(int i, int j) {
    return at(2 * (i * (i + 1) / 2 + j) + 1);
  }
  __device__ float& linv(int j) { return at(2 * kTri + j); }
  __device__ float& dr(int k) { return at(2 * kTri + C + k); }
  __device__ float& di(int k) { return at(2 * kTri + 2 * C + k); }
  __device__ float& yr(int k) { return at(2 * kTri + 3 * C + k); }
  __device__ float& yi(int k) { return at(2 * kTri + 4 * C + k); }
};

// Where the C-channel solve keeps its working set, its threads a block and
// dynamic shared memory.  At C = 16 the working set (1408 bytes a thread)
// does not fit the 255 registers a thread may hold (fully unrolled, with
// only the factor in shared memory, ptxas reported 255 registers and ~1 KB
// of spill stores), so there it all lives in shared memory and the loops
// stay rolled: 32 threads, 45 056 bytes, under the 48 KB a launch gets
// without opting in.
template <int C>
struct SolveShape {
  static constexpr bool kShared = C > 8;
  static constexpr int kThreads = kShared ? 32 : 128;
  static constexpr int kSmemBytes =
      kShared ? SharedStore<C>::kFloats * kThreads * (int)sizeof(float) : 0;
  using Store =
      std::conditional_t<kShared, SharedStore<C>, RegisterStore<C>>;
};

template <int C, class Layout>
__global__ void __launch_bounds__(SolveShape<C>::kThreads)
mvdr_solve_kernel(
    Layout cov, const float2* __restrict__ steer, float2* __restrict__ w,
    int B, int S, int F, float load_scale, int c_runtime) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx % F);
  // The loops' count: the constant C unrolls them fully (registers); the
  // same value passed at run time keeps them rolled (shared memory).
  const int nc = SolveShape<C>::kShared ? c_runtime : C;

  // Lower triangle of R (j <= i), factorised in place into L.
  extern __shared__ float smem[];
  typename SolveShape<C>::Store L;
  if constexpr (SolveShape<C>::kShared) {
    L.base = smem + threadIdx.x;
    L.stride = blockDim.x;
  }
#pragma unroll
  for (int i = 0; i < nc; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float2 v = cov(b, f, i, j);
      L.re(i, j) = v.x;
      L.im(i, j) = v.y;
    }

  float tr = L.re(0, 0);
#pragma unroll
  for (int j = 1; j < nc; ++j) tr = add(tr, L.re(j, j));
  const float load = mul(load_scale, tr);
#pragma unroll
  for (int j = 0; j < nc; ++j) L.re(j, j) = add(L.re(j, j), load);

#pragma unroll
  for (int j = 0; j < nc; ++j) {
    const float piv = __fsqrt_rn(fmaxf(L.re(j, j), 1e-30f));
    const float inv = __fdiv_rn(1.0f, piv);
    L.linv(j) = inv;
#pragma unroll
    for (int i = j + 1; i < nc; ++i) {
      L.re(i, j) = mul(L.re(i, j), inv);
      L.im(i, j) = mul(L.im(i, j), inv);
    }
#pragma unroll
    for (int i = j + 1; i < nc; ++i)
#pragma unroll
      for (int k = j + 1; k <= i; ++k) {
        // R[i,k] -= L[i,j] * conj(L[k,j])
        const float br = L.re(i, j), bi = L.im(i, j);
        const float cr = L.re(k, j), ci = L.im(k, j);
        L.re(i, k) = sub(L.re(i, k), add(mul(br, cr), mul(bi, ci)));
        L.im(i, k) = sub(L.im(i, k), sub(mul(bi, cr), mul(br, ci)));
      }
  }

  for (int s = 0; s < S; ++s) {
    const long long off = ((long long)b * S + s) * C * F + f;
#pragma unroll
    for (int k = 0; k < nc; ++k) {
      const float2 v = steer[off + (long long)k * F];
      L.dr(k) = v.x;
      L.di(k) = v.y;
    }
    // forward: L y = d
#pragma unroll
    for (int k = 0; k < nc; ++k) {
      float ar = L.dr(k), ai = L.di(k);
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const float br = L.re(k, j), bi = L.im(k, j);
        const float yr = L.yr(j), yi = L.yi(j);
        ar = sub(ar, sub(mul(br, yr), mul(bi, yi)));
        ai = sub(ai, add(mul(br, yi), mul(bi, yr)));
      }
      L.yr(k) = mul(ar, L.linv(k));
      L.yi(k) = mul(ai, L.linv(k));
    }
    // adjoint: L^H z = y, z overwriting y from the last entry down
#pragma unroll
    for (int k = nc - 1; k >= 0; --k) {
      float ar = L.yr(k), ai = L.yi(k);
#pragma unroll
      for (int j = k + 1; j < nc; ++j) {
        // conj(L[j,k]) * z[j]
        const float br = L.re(j, k), bi = L.im(j, k);
        const float zr = L.yr(j), zi = L.yi(j);
        ar = sub(ar, add(mul(br, zr), mul(bi, zi)));
        ai = sub(ai, sub(mul(br, zi), mul(bi, zr)));
      }
      L.yr(k) = mul(ar, L.linv(k));
      L.yi(k) = mul(ai, L.linv(k));
    }
    // denom = d^H z, guarded; w = z / denom
    float nr = 0.0f, ni = 0.0f;
#pragma unroll
    for (int k = 0; k < nc; ++k) {
      const float dr = L.dr(k), di = L.di(k), zr = L.yr(k), zi = L.yi(k);
      nr = add(nr, add(mul(dr, zr), mul(di, zi)));
      ni = add(ni, sub(mul(dr, zi), mul(di, zr)));
    }
    const bool ok = __fsqrt_rn(add(mul(nr, nr), mul(ni, ni))) > 1e-12f;
    nr = ok ? nr : 1e-12f;
    ni = ok ? ni : 0.0f;
    const float sc = __fdiv_rn(1.0f, add(mul(nr, nr), mul(ni, ni)));
#pragma unroll
    for (int k = 0; k < nc; ++k) {
      const float zr = L.yr(k), zi = L.yi(k);
      w[off + (long long)k * F] =
          make_float2(mul(add(mul(zr, nr), mul(zi, ni)), sc),
                      mul(sub(mul(zi, nr), mul(zr, ni)), sc));
    }
  }
}

template <int C, class Layout>
int launch(const Layout& cov, const void* steer, void* w, int B, int S, int F,
           float load_scale, cudaStream_t stream) {
  const int threads = SolveShape<C>::kThreads;
  const unsigned blocks = (unsigned)mcax::ceil_div((long long)B * F, threads);
  mvdr_solve_kernel<C, Layout>
      <<<blocks, threads, SolveShape<C>::kSmemBytes, stream>>>(
      cov, static_cast<const float2*>(steer), static_cast<float2*>(w), B, S,
      F, load_scale, C);
  return (int)cudaGetLastError();
}

// ---- kernel 6: a group of C lanes per (block, bin) -------------------------

constexpr int GROUP_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// Lane k's value to every lane of its group of C.
template <int C>
__device__ __forceinline__ float from_lane(float v, int k) {
  return __shfl_sync(FULL, v, k, C);
}

// The loader of complex64 [systems, C, C]: a warp stages the C^2 float2 of
// each of its 32/C systems (contiguous, so 16-byte coalesced loads) in its
// own kWarpFloats of shared memory, rows padded to kStride floats, then lane
// i of group g takes row i of system sys0 + g: re[k], im[k] for k <= i (the
// imaginary part of the diagonal reads as 0), 0 for k > i.  Systems past
// the last read as zero.
template <int C>
struct ComplexRows {
  static constexpr int kStride = 2 * C + 2;
  static constexpr int kWarpFloats = 32 * kStride;
  const float4* covs;
  long long systems;
  __device__ void operator()(long long sys0, float* wsm, int g, int i,
                             float (&re)[C], float (&im)[C]) const {
    const int lane = threadIdx.x & 31;
    const long long base = sys0 * (C * C / 2);     // float4 index
    const long long end = systems * (C * C / 2);
#pragma unroll
    for (int r = 0; r < C / 2; ++r) {
      const int q = lane + 32 * r;                 // the warp's q-th float4
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (base + q < end) v = __ldg(covs + base + q);
      const int e = 2 * q;                         // its first float2
      float* d = wsm + (e / C) * kStride + 2 * (e % C);
      *reinterpret_cast<float2*>(d) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(d + 2) = make_float2(v.z, v.w);
    }
    __syncwarp();
    const float* src = wsm + (g * C + i) * kStride;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(src + 2 * k);
      re[k] = k <= i ? v.x : 0.0f;
      im[k] = k < i ? v.y : 0.0f;
    }
  }
};

// Dynamic shared memory of mvdr_group_kernel: each warp's staged matrices,
// then the steering and the weights of the block's systems, [C][DS] float2.
template <int C, class Loader>
struct GroupShape {
  static constexpr int kSystems = GROUP_THREADS / C;          // a block
  static constexpr int kDS = kSystems + (C == 8 ? 2 : 1);      // conflict-free
  static constexpr int kSteerFloats = 2 * C * kDS;
  static constexpr int kSmemBytes =
      ((GROUP_THREADS / 32) * Loader::kWarpFloats + 2 * kSteerFloats) *
      (int)sizeof(float);
};

template <int C, class Loader>
__global__ void __launch_bounds__(GROUP_THREADS)
mvdr_group_kernel(Loader cov, const float2* __restrict__ steer,
                  float2* __restrict__ w, int B, int S, int F,
                  float load_scale) {
  using Shape = GroupShape<C, Loader>;
  static_assert(32 % C == 0 && C % 2 == 0, "a group of C lanes in a warp");
  extern __shared__ __align__(16) float gsm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / C;                      // the lane's system in the warp
  const int i = lane % C;                      // its row
  const long long systems = (long long)B * F;
  const long long sys0 = (long long)blockIdx.x * Shape::kSystems;
  const int q = warp * (32 / C) + g;           // its system in the block
  float2* sd = reinterpret_cast<float2*>(
      gsm + (GROUP_THREADS / 32) * Loader::kWarpFloats);
  float2* sw = sd + C * Shape::kDS;

  // Row i of the lower triangle of R, factorised in place into row i of L.
  float re[C], im[C];
  cov(sys0 + warp * (32 / C), gsm + warp * Loader::kWarpFloats, g, i, re, im);

  float diag = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k == i) diag = re[k];
  float tr = from_lane<C>(diag, 0);
#pragma unroll
  for (int j = 1; j < C; ++j) tr = add(tr, from_lane<C>(diag, j));
  const float load = mul(load_scale, tr);
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k == i) re[k] = add(re[k], load);

  float linv = 0.0f;                           // 1 / L[i,i]
#pragma unroll
  for (int j = 0; j < C; ++j) {
    // lane j's re[j] is the updated pivot R[j,j]
    const float piv = __fsqrt_rn(fmaxf(re[j], 1e-30f));
    const float inv = from_lane<C>(__fdiv_rn(1.0f, piv), j);
    if (i == j) linv = inv;
    if (i > j) {
      re[j] = mul(re[j], inv);
      im[j] = mul(im[j], inv);
    }
#pragma unroll
    for (int k = j + 1; k < C; ++k) {
      // R[i,k] -= L[i,j] * conj(L[k,j]), for the lanes i >= k
      const float cr = from_lane<C>(re[j], k);
      const float ci = from_lane<C>(im[j], k);
      if (k <= i) {
        re[k] = sub(re[k], add(mul(re[j], cr), mul(im[j], ci)));
        im[k] = sub(im[k], sub(mul(im[j], cr), mul(re[j], ci)));
      }
    }
  }

  const int e = threadIdx.x;                   // one element a thread below
  const int ek = e / Shape::kSystems;          // its channel
  const long long esys = sys0 + e % Shape::kSystems;
  const bool eok = esys < systems;
  const long long eb = eok ? esys / F : 0;
  const long long ef = eok ? esys % F : 0;
  for (int s = 0; s < S; ++s) {
    const long long eoff = ((eb * S + s) * C + ek) * F + ef;
    sd[ek * Shape::kDS + e % Shape::kSystems] =
        eok ? steer[eoff] : make_float2(0.0f, 0.0f);
    __syncthreads();
    const float2 d = sd[i * Shape::kDS + q];

    // forward: L y = d; lane k's accumulator takes L[k,j] y[j], j ascending
    float ar = d.x, ai = d.y, yr = 0.0f, yi = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float vr = from_lane<C>(mul(ar, linv), j);
      const float vi = from_lane<C>(mul(ai, linv), j);
      if (i == j) {
        yr = vr;
        yi = vi;
      }
      if (i > j) {
        ar = sub(ar, sub(mul(re[j], vr), mul(im[j], vi)));
        ai = sub(ai, add(mul(re[j], vi), mul(im[j], vr)));
      }
    }
    // adjoint: L^H z = y, z[k] from the last entry down; lane j > k forms
    // conj(L[j,k]) z[j], lane k subtracts them with j ascending
    float zr = 0.0f, zi = 0.0f;
    ar = yr;
    ai = yi;
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      const float tr_ = add(mul(re[k], zr), mul(im[k], zi));
      const float ti_ = sub(mul(re[k], zi), mul(im[k], zr));
#pragma unroll
      for (int j = k + 1; j < C; ++j) {
        const float sr = from_lane<C>(tr_, j);
        const float si = from_lane<C>(ti_, j);
        if (i == k) {
          ar = sub(ar, sr);
          ai = sub(ai, si);
        }
      }
      if (i == k) {
        zr = mul(ar, linv);
        zi = mul(ai, linv);
      }
    }
    // denom = d^H z, its terms added with k ascending; w = z / denom
    const float ur = add(mul(d.x, zr), mul(d.y, zi));
    const float ui = sub(mul(d.x, zi), mul(d.y, zr));
    float nr = 0.0f, ni = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      nr = add(nr, from_lane<C>(ur, k));
      ni = add(ni, from_lane<C>(ui, k));
    }
    const bool ok = __fsqrt_rn(add(mul(nr, nr), mul(ni, ni))) > 1e-12f;
    nr = ok ? nr : 1e-12f;
    ni = ok ? ni : 0.0f;
    const float sc = __fdiv_rn(1.0f, add(mul(nr, nr), mul(ni, ni)));
    sw[i * Shape::kDS + q] =
        make_float2(mul(add(mul(zr, nr), mul(zi, ni)), sc),
                    mul(sub(mul(zi, nr), mul(zr, ni)), sc));
    __syncthreads();
    if (eok) w[eoff] = sw[ek * Shape::kDS + e % Shape::kSystems];
  }
}

template <int C>
int launch_group(const void* covs, const void* steer, void* w, int B, int S,
                 int F, float load_scale, cudaStream_t stream) {
  using L = ComplexRows<C>;
  const long long systems = (long long)B * F;
  const L loader{static_cast<const float4*>(covs), systems};
  const unsigned blocks = (unsigned)mcax::ceil_div(
      systems, GroupShape<C, L>::kSystems);
  mvdr_group_kernel<C, L><<<blocks, GROUP_THREADS,
                            GroupShape<C, L>::kSmemBytes, stream>>>(
      loader, static_cast<const float2*>(steer), static_cast<float2*>(w), B,
      S, F, load_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [B, 2C^2, F], steer complex64 [B, S, C, F], w complex64 [B, S, C, F];
// load_scale = float32(delta / C).  C must be 8 or 16.
MCAX_API int mcax_mvdr_solve_rows(const float* rows, const void* steer,
                                  void* w, int B, int S, int C, int F,
                                  float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8:
      return launch<8>(RowsLayout<8>{rows, F}, steer, w, B, S, F, load_scale,
                       st);
    case 16:
      return launch<16>(RowsLayout<16>{rows, F}, steer, w, B, S, F,
                        load_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// covs complex64 [B, F, C, C] (16-byte aligned), steer and w as above.
// C must be 8 or 16.
MCAX_API int mcax_mvdr_solve_complex(const void* covs, const void* steer,
                                     void* w, int B, int S, int C, int F,
                                     float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8:
      return launch_group<8>(covs, steer, w, B, S, F, load_scale, st);
    case 16:
      return launch_group<16>(covs, steer, w, B, S, F, load_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
