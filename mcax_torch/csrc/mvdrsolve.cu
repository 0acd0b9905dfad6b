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
// against ~0.1 GFLOP per source of solve arithmetic: memory-bound; config5
// (C = 16, S = 2) ~0.20 GB, ~0.06 ms.  The complex layout at S = 64
// streams is ~17 MB (~0.005 ms); at the block step's B = 1 (513 bins) the
// call is bound by its launch and by the solve's serial chain.
//
// Two bodies, one arithmetic:
//   * mvdr_solve_kernel (kernel 4 at C = 8): one thread per (block, bin)
//     from the rows layout, consecutive threads on consecutive bins so every
//     rows read and weight write is coalesced, the thread's working set in
//     registers, the loops unrolled, 128 threads a block.
//   * mvdr_group_kernel (kernel 6, and kernel 4 at C = 16 and 32): a group
//     of C lanes per (block, bin), lane i holding row i of the lower
//     triangle in registers (2C floats), 32/C systems a warp (one at C =
//     32), 128 threads a block.  A
//     loader, a template parameter, gives each lane its row:
//       - ComplexRows (kernel 6): the group's C x C matrix is C^2
//         contiguous float2, so a warp stages its systems with 16-byte
//         coalesced loads through shared memory (rows padded to 2C+2
//         floats: conflict-free 8-byte reads) before each lane takes its
//         row; a block is one pass of 128/C systems.
//       - RowsLoader (kernel 4 at C = 16 and 32): a block takes a run of
//         Run consecutive systems s = b*F + f (a run may cross from block
//         b to b+1) and stages the C^2 rows the solve reads (real (i, k),
//         k <= i, and imaginary (i, k), k < i) of those systems with
//         4-byte cp.async copies (zero past the last system).  Run is 32
//         at C = 16 (32 KB: a warp-wide 128-byte read of a row's 32 bins at
//         a time); at C = 32 a run of 32 would be 128 KB and one block (4
//         warps) an SM, so it is RUN32 = 8 systems (32 KB).  The rows sit
//         in shared memory column by column of the triangle, a row's run
//         XOR-swizzled by slot, so both the staging and the lanes' reads
//         (one k, the C rows of a column, 32/C systems) are
//         conflict-free.  The block then runs the body in Run / (128/C)
//         passes over the run.
//     The trace is gathered by __shfl_sync in the order j = 0..C-1.  For
//     column j, lane j makes the pivot and its reciprocal and broadcasts
//     it, lanes i > j scale L[i,j], and each lane i updates its own R[i,k],
//     j < k <= i, with L[k,j] fetched from lane k.  The forward
//     substitution keeps lane k's accumulator of y[k] and subtracts
//     L[k,j] y[j] as lane j broadcasts y[j], j ascending: the plain
//     version's single accumulator and order.  The adjoint and d^H z form
//     their per-term products in parallel, one in each lane, and one lane
//     (every lane, for d^H z) subtracts or adds them in the plain version's
//     order.  The steering reads and the weight stores go through shared
//     memory, so each is a run over F of a pass's 128/C systems in the
//     [B, S, C, F] layout.
//   At C = 16 one thread's working set (1408 bytes) does not fit its
//   registers; the group body keeps 2C floats a lane instead.  At C = 8 the
//   group body issues ~4x the warp instructions of one thread a system, so
//   kernel 4 keeps mvdr_solve_kernel there (mcax_mvdr_solve_rows_group runs
//   the group body at either C, for the comparison).
// Every multiply, add and subtract is an explicitly rounded intrinsic that
// the compiler never contracts into an FMA: the loaded covariance of a
// near-rank-1 scene has a condition number in the thousands, which
// amplifies a one-ulp difference per operation into ~1e-3 of the weights,
// so both bodies perform exactly the IEEE operations of the plain version,
// in the same order, wherever the factor is stored: bit-equal.
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

constexpr int SOLVE_THREADS = 128;

// One thread per (block, bin): the lower triangle (j <= i) of the factor,
// the reciprocal pivots, the steering vector d and the substitution vector,
// which holds y and then, in place, z (z[k] is written after y[k]'s last
// read), all in registers: every index is a compile-time constant, so the
// loops unroll fully.
template <int C, class Layout>
__global__ void __launch_bounds__(SOLVE_THREADS)
mvdr_solve_kernel(Layout cov, const float2* __restrict__ steer,
                  float2* __restrict__ w, int B, int S, int F,
                  float load_scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx % F);

  // Lower triangle of R (j <= i), factorised in place into L.
  float lr[C][C], li[C][C], linv[C], dr[C], di[C], vr[C], vi[C];
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
        ar = sub(ar, sub(mul(br, vr[j]), mul(bi, vi[j])));
        ai = sub(ai, add(mul(br, vi[j]), mul(bi, vr[j])));
      }
      vr[k] = mul(ar, linv[k]);
      vi[k] = mul(ai, linv[k]);
    }
    // adjoint: L^H z = y, z overwriting y from the last entry down
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      float ar = vr[k], ai = vi[k];
#pragma unroll
      for (int j = k + 1; j < C; ++j) {
        // conj(L[j,k]) * z[j]
        const float br = lr[j][k], bi = li[j][k];
        ar = sub(ar, add(mul(br, vr[j]), mul(bi, vi[j])));
        ai = sub(ai, sub(mul(br, vi[j]), mul(bi, vr[j])));
      }
      vr[k] = mul(ar, linv[k]);
      vi[k] = mul(ai, linv[k]);
    }
    // denom = d^H z, guarded; w = z / denom
    float nr = 0.0f, ni = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      nr = add(nr, add(mul(dr[k], vr[k]), mul(di[k], vi[k])));
      ni = add(ni, sub(mul(dr[k], vi[k]), mul(di[k], vr[k])));
    }
    const bool ok = __fsqrt_rn(add(mul(nr, nr), mul(ni, ni))) > 1e-12f;
    nr = ok ? nr : 1e-12f;
    ni = ok ? ni : 0.0f;
    const float sc = __fdiv_rn(1.0f, add(mul(nr, nr), mul(ni, ni)));
#pragma unroll
    for (int k = 0; k < C; ++k)
      w[off + (long long)k * F] =
          make_float2(mul(add(mul(vr[k], nr), mul(vi[k], ni)), sc),
                      mul(sub(mul(vi[k], nr), mul(vr[k], ni)), sc));
  }
}

// ---- a group of C lanes per (block, bin) ------------------------------------

constexpr int GROUP_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// Lane k's value to every lane of its group of C.
template <int C>
__device__ __forceinline__ float from_lane(float v, int k) {
  return __shfl_sync(FULL, v, k, C);
}

// The loader of complex64 [systems, C, C]: a block is one pass of 128/C
// systems, each warp staging the C^2 float2 of its 32/C systems
// (contiguous, so 16-byte coalesced loads) in its own kWarpFloats of shared
// memory, rows padded to kStride floats; then lane i of group g takes row
// i of system sysw + g: re[k], im[k] for k <= i (the imaginary part of the
// diagonal reads as 0), 0 for k > i.  Systems past the last read as zero.
template <int C>
struct ComplexRows {
  static constexpr int kStride = 2 * C + 2;
  static constexpr int kWarpFloats = 32 * kStride;
  static constexpr int kSystems = GROUP_THREADS / C;           // a block
  static constexpr int kSmemFloats = (GROUP_THREADS / 32) * kWarpFloats;
  const float4* covs;
  long long systems;
  __device__ void stage(long long, float*) const {}
  __device__ void operator()(long long sysw, int, float* sm, int g, int i,
                             float (&re)[C], float (&im)[C]) const {
    const int lane = threadIdx.x & 31;
    float* wsm = sm + (threadIdx.x >> 5) * kWarpFloats;
    const long long base = sysw * (C * C / 2);     // float4 index
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

// The loader of the covariance-prefix rows [B, 2C^2, F]: a block takes a
// run of kSystems = Run consecutive systems s = b*F + f (32; RUN32 at C =
// 32).  ``stage`` copies the C^2 rows the solve reads into shared
// memory, one slot a row: real (i, k), k <= i, in slots 0..kTri-1 and
// imaginary (i, k), k < i, after them, each part column by column of the
// triangle.  Thread t takes system j = t % Run of the slots t / Run,
// t / Run + kStep, ... (kStep = 128 / Run) of each part: 4-byte cp.async
// copies, so a warp instruction copies 32/Run slots' runs (at Run = 32 one
// 128-byte read of a row's run; a run that crosses a block reads two
// pieces), zero past the last system.  System j of slot t sits at t*Run +
// (j ^ swz(t)), swz(t) = ((t*32/C) / (32/Run)) mod Run: the staging writes
// 32/Run consecutive slots' runs (32 consecutive words, the runs permuted
// within), and a lanes' read takes, for one k, the consecutive slots of a
// column for the warp's 32/C systems (j differing below 32/C): both
// conflict-free at Run = 32 (C = 8, 16, 32) and at Run = 8 or 16 (C = 32,
// one system a warp: t mod 32 -> bank is one to one).
template <int C, int Run = 32>
struct RowsLoader {
  static_assert(Run == 32 || (C == 32 && (Run == 8 || Run == 16)),
                "runs of 32 systems, or of 8 or 16 at C = 32");
  static constexpr int kSystems = Run;
  static constexpr int kStep = GROUP_THREADS / Run;
  static constexpr int kTri = C * (C + 1) / 2;
  static constexpr int kSmemFloats = C * C * kSystems;
  const float* rows;
  long long systems;
  int F;
  __device__ static int at(int slot, int j) {
    return slot * kSystems +
           (j ^ (((slot * (32 / C)) / (32 / Run)) & (kSystems - 1)));
  }
  __device__ static int re_slot(int i, int k) {
    return k * C - k * (k - 1) / 2 + (i - k);
  }
  __device__ static int im_slot(int i, int k) {
    return kTri + k * (C - 1) - k * (k - 1) / 2 + (i - k - 1);
  }
  __device__ void stage(long long run0, float* sm) const {
    const int first = threadIdx.x / Run;
    const int j = threadIdx.x % Run;
    const long long s = run0 + j;
    const int bytes = s < systems ? 4 : 0;
    const float* src = rows;                       // read nothing past the end
    if (bytes) {
      const long long b = s / F;
      src = rows + b * 2 * C * C * F + (s - b * F);
    }
    // real (i, k): column k holds i = k..C-1
    for (int slot = first, i = first, k = 0; slot < kTri; slot += kStep) {
      mcax::cp_async4(sm + at(slot, j), src + (long long)(i * C + k) * F,
                      bytes);
      for (i += kStep; k < C && i >= C; ++k) i -= C - k - 1;
    }
    // imaginary (i, k): column k holds i = k+1..C-1
    for (int t = first, i = first + 1, k = 0; t < C * C - kTri; t += kStep) {
      mcax::cp_async4(sm + at(kTri + t, j),
                      src + (long long)(C * C + i * C + k) * F, bytes);
      for (i += kStep; k < C && i >= C; ++k) i -= C - k - 2;
    }
    mcax::cp_async_commit();
    mcax::cp_async_wait<0>();
    __syncthreads();
  }
  __device__ void operator()(long long, int jw, float* sm, int g, int i,
                             float (&re)[C], float (&im)[C]) const {
    const int j = jw + g;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      re[k] = k <= i ? sm[at(re_slot(i, k), j)] : 0.0f;
      im[k] = k < i ? sm[at(im_slot(i, k), j)] : 0.0f;
    }
  }
};

// The run of kernel 4's rows loader at C = 32: 8 systems (32 KB, five
// blocks an SM by registers) solve em32's B = 512 in 6.5 ms, against
// 9.3-10.6 ms at 16 and 23.0 ms at 32 (128 KB of rows: one block, 4 warps,
// an SM), bit-equal.
constexpr int RUN32 = 8;
template <int C>
constexpr int kRowsRun = C == 32 ? RUN32 : 32;

// Dynamic shared memory of mvdr_group_kernel: the loader's, then the
// steering and the weights of a pass's systems, [C][DS] float2.
template <int C, class Loader>
struct GroupShape {
  static constexpr int kPass = GROUP_THREADS / C;             // systems a pass
  static constexpr int kPasses = Loader::kSystems / kPass;
  static constexpr int kDS = kPass + (C == 8 ? 2 : 1);         // conflict-free
  static constexpr int kSteerFloats = 2 * C * kDS;
  static constexpr int kSmemBytes =
      (Loader::kSmemFloats + 2 * kSteerFloats) * (int)sizeof(float);
  static_assert(Loader::kSystems % kPass == 0, "whole passes a block");
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
  const long long run0 = (long long)blockIdx.x * Loader::kSystems;
  const int q = warp * (32 / C) + g;           // its system in the pass
  float2* sd = reinterpret_cast<float2*>(gsm + Loader::kSmemFloats);
  float2* sw = sd + C * Shape::kDS;
  cov.stage(run0, gsm);

  for (int pass = 0; pass < Shape::kPasses; ++pass) {
    const long long sys0 = run0 + pass * Shape::kPass;
    if (sys0 >= systems) break;                // the same for the whole block
    // Row i of the lower triangle of R, factorised in place into row i of L.
    float re[C], im[C];
    cov(sys0 + warp * (32 / C), pass * Shape::kPass + warp * (32 / C), gsm, g,
        i, re, im);

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

    float linv = 0.0f;                         // 1 / L[i,i]
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

    const int e = threadIdx.x;                 // one element a thread below
    const int ek = e / Shape::kPass;           // its channel
    const long long esys = sys0 + e % Shape::kPass;
    const bool eok = esys < systems;
    const long long eb = eok ? esys / F : 0;
    const long long ef = eok ? esys % F : 0;
    for (int s = 0; s < S; ++s) {
      const long long eoff = ((eb * S + s) * C + ek) * F + ef;
      sd[ek * Shape::kDS + e % Shape::kPass] =
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
      if (eok) w[eoff] = sw[ek * Shape::kDS + e % Shape::kPass];
    }
  }
}

template <int C, class Loader>
int launch_group(const Loader& loader, long long systems, const void* steer,
                 void* w, int B, int S, int F, float load_scale,
                 cudaStream_t stream) {
  static_assert(GroupShape<C, Loader>::kSmemBytes <= 48 * 1024,
                "within a block's default dynamic shared memory");
  const unsigned blocks =
      (unsigned)mcax::ceil_div(systems, Loader::kSystems);
  mvdr_group_kernel<C, Loader><<<blocks, GROUP_THREADS,
                                 GroupShape<C, Loader>::kSmemBytes, stream>>>(
      loader, static_cast<const float2*>(steer), static_cast<float2*>(w), B,
      S, F, load_scale);
  return (int)cudaGetLastError();
}

template <int C>
int launch_rows_group(const float* rows, const void* steer, void* w, int B,
                      int S, int F, float load_scale, cudaStream_t stream) {
  const long long systems = (long long)B * F;
  return launch_group<C>(RowsLoader<C, kRowsRun<C>>{rows, systems, F},
                         systems, steer, w, B, S, F, load_scale, stream);
}

template <int C>
int launch_complex_group(const void* covs, const void* steer, void* w, int B,
                         int S, int F, float load_scale, cudaStream_t stream) {
  const long long systems = (long long)B * F;
  return launch_group<C>(
      ComplexRows<C>{static_cast<const float4*>(covs), systems}, systems,
      steer, w, B, S, F, load_scale, stream);
}

}  // namespace

// rows [B, 2C^2, F], steer complex64 [B, S, C, F], w complex64 [B, S, C, F];
// load_scale = float32(delta / C).  C must be 8 (one thread a system), 16
// or 32 (the group body).
MCAX_API int mcax_mvdr_solve_rows(const float* rows, const void* steer,
                                  void* w, int B, int S, int C, int F,
                                  float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8: {
      const unsigned blocks =
          (unsigned)mcax::ceil_div((long long)B * F, SOLVE_THREADS);
      mvdr_solve_kernel<8, RowsLayout<8>><<<blocks, SOLVE_THREADS, 0, st>>>(
          RowsLayout<8>{rows, F}, static_cast<const float2*>(steer),
          static_cast<float2*>(w), B, S, F, load_scale);
      return (int)cudaGetLastError();
    }
    case 16:
      return launch_rows_group<16>(rows, steer, w, B, S, F, load_scale, st);
    case 32:
      return launch_rows_group<32>(rows, steer, w, B, S, F, load_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same arguments, always on the group body (C = 8, 16 or 32): the
// comparison of the two bodies at C = 8.
MCAX_API int mcax_mvdr_solve_rows_group(const float* rows, const void* steer,
                                        void* w, int B, int S, int C, int F,
                                        float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8: return launch_rows_group<8>(rows, steer, w, B, S, F, load_scale, st);
    case 16:
      return launch_rows_group<16>(rows, steer, w, B, S, F, load_scale, st);
    case 32:
      return launch_rows_group<32>(rows, steer, w, B, S, F, load_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// covs complex64 [B, F, C, C] (16-byte aligned), steer and w as above.
// C must be 8, 16 or 32.
MCAX_API int mcax_mvdr_solve_complex(const void* covs, const void* steer,
                                     void* w, int B, int S, int C, int F,
                                     float load_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 8:
      return launch_complex_group<8>(covs, steer, w, B, S, F, load_scale, st);
    case 16:
      return launch_complex_group<16>(covs, steer, w, B, S, F, load_scale, st);
    case 32:
      return launch_complex_group<32>(covs, steer, w, B, S, F, load_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
