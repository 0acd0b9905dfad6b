// PHAT-weighted cross-power spectra, from gathered pair spectra or with the
// pair gather in the kernel.
//
// Replaces: mcax/kernels/cps.py, _cps_phat_pallas (the Pallas kernel
// _cps_phat_kernel), which cps_phat_pairs and cps_phat call: GCC-PHAT's
// whitening step (config1) and the materialised SRP's CPS (srp="matmul").
//
// What it computes.  For each mic pair (i, j) and bin,
//     g = X_i * conj(X_j),   out = g / (|g| + eps)
// in the reference kernel's order: gr = ar*br + ai*bi, gi = ai*br - ar*bi,
// w = 1 / (sqrt(gr^2 + gi^2) + eps), out = (gr*w, gi*w).
//
// Two kernels, one arithmetic:
//   * cps_phat_kernel (mcax_cps_phat, cps_phat_pairs): the pair spectra
//     a = X_i, b = X_j already gathered by the caller, n elements in any
//     layout; one thread an element, one float2 load per operand, one
//     float2 store.  Two complex64 reads and one write an element: memory
//     bound (config1, B = 512: ~50 MB, ~0.015 ms at 3.35 TB/s).
//   * cps_gather_kernel (mcax_cps_phat_gather, cps_phat_gather, the
//     pipelines' path): the spectra [L, C, M, F] (strides of the leading,
//     channel and frame axes given, bins contiguous) and the pairs [P, 2].
//     Gathering outside (two index_selects) writes and re-reads both
//     [M, P, F] pair copies, so every channel's spectrum crosses device
//     memory 1 + 2(C-1) times; here each is read once.  A CTA takes nf
//     consecutive frames (of the L*M) and a tile of ft bins (the plan of
//     kernels/cps.py, gather_plan: one tile of all F bins where the C
//     channels fit, several frames a CTA where a frame is little work, so
//     that a CTA's loads are enough to cover their latency): it stages the
//     C channels' bins of the tile of all its frames in shared memory at
//     once (nf * C * ft float2, at most 48 KB: config4's one frame of
//     8 x 513 bins is 32.8 KB, config1's 2 frames of 2 x 257 bins 8.2 KB),
//     then writes the nf x P x ft outputs with consecutive threads on
//     consecutive (frame, pair, bin) elements, so every store is
//     coalesced; for frames-major output [L*M, P, F] one frame's P*F
//     outputs are one contiguous run.  The bound is the function's bytes, the spectra read
//     once and the CPS written once: config4 srp="matmul", B = 512 (C = 8,
//     P = 28, M = 12 288, F = 513) 0.40 GB in, 1.41 GB out, 0.542 ms at
//     3.35 TB/s.  Out-of-range pair indices trap (as index_select's device
//     assert does); the plans that hold the pairs check them when made.
// Every operation is an explicitly rounded intrinsic (no contracted FMA,
// IEEE sqrt and divide), so both kernels perform the plain version's IEEE
// operations exactly: bit-equal to it.
#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float2 phat(float2 x, float2 y, float eps) {
  const float gr = add(mul(x.x, y.x), mul(x.y, y.y));
  const float gi = sub(mul(x.y, y.x), mul(x.x, y.y));
  const float w =
      __fdiv_rn(1.0f, add(__fsqrt_rn(add(mul(gr, gr), mul(gi, gi))), eps));
  return make_float2(mul(gr, w), mul(gi, w));
}

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) cps_phat_kernel(
    const float2* __restrict__ a, const float2* __restrict__ b,
    float2* __restrict__ g, long long n, float eps) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  g[i] = phat(a[i], b[i], eps);
}

// ---- the pair gather in the kernel ----------------------------------------

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_SMEM = 48 * 1024;   // dynamic shared memory, no opt-in
constexpr int GATHER_LOADS = 4;          // loads a thread keeps in flight

// shared memory: the pairs, then each frame's source and output offsets,
// then the frames' staged bins (all 16-byte aligned)
__host__ __device__ inline int pairs_bytes(int P) {
  return (P * 8 + 15) / 16 * 16;
}
__host__ __device__ inline int offsets_bytes(int nf) {
  return (nf * 16 + 15) / 16 * 16;
}

struct GatherShape {
  int L, C, M, F, P;
  long long sl, sc, sm;  // spectra strides (float2): leading, channel, frame
  long long ol, om, op;  // output strides (float2): leading, frame, pair
  int ft, nf;            // bins a tile, frames a CTA
};

// A thread's walk over flat elements (frame k, row r of R, bin f of nb),
// GATHER_THREADS at a step: after f grows, carry it into r and r into k,
// one subtract where nb >= GATHER_THREADS (the walks of config4 and
// config1), a division where it is smaller.
__device__ __forceinline__ void carry(int& k, int& r, int& f, int nb, int R) {
  if (f < nb) return;
  if (nb >= GATHER_THREADS) {
    f -= nb;
    ++r;
  } else {
    const int d = f / nb;
    r += d;
    f -= d * nb;
  }
  if (r >= R) {
    const int d = r / R;
    k += d;
    r -= d * R;
  }
}

__global__ void __launch_bounds__(GATHER_THREADS) cps_gather_kernel(
    const float2* __restrict__ spec, const int2* __restrict__ pairs,
    float2* __restrict__ out, GatherShape s, float eps) {
  extern __shared__ __align__(16) unsigned char gsm[];
  int2* sp = reinterpret_cast<int2*>(gsm);                           // [P]
  long long* src_off = reinterpret_cast<long long*>(gsm + pairs_bytes(s.P));
  long long* dst_off = src_off + s.nf;                               // [nf]
  float2* sx = reinterpret_cast<float2*>(gsm + pairs_bytes(s.P) +
                                         offsets_bytes(s.nf));  // [nf][C][nb]
  const int f0 = blockIdx.y * s.ft;
  const int nb = min(s.ft, s.F - f0);          // this tile's bins
  const long long fr0 = (long long)blockIdx.x * s.nf;
  const int nfr = (int)min((long long)s.nf, (long long)s.L * s.M - fr0);
  for (int p = threadIdx.x; p < s.P; p += GATHER_THREADS) {
    const int2 q = pairs[p];
    if ((unsigned)q.x >= (unsigned)s.C || (unsigned)q.y >= (unsigned)s.C)
      __trap();
    sp[p] = q;
  }
  if (threadIdx.x < nfr) {
    const long long fr = fr0 + threadIdx.x;
    const long long l = fr / s.M, m = fr - l * s.M;
    src_off[threadIdx.x] = l * s.sl + m * s.sm + f0;
    dst_off[threadIdx.x] = l * s.ol + m * s.om + f0;
  }
  __syncthreads();
  // every frame's C channels' bins of the tile, packed [frame][c][nb],
  // GATHER_LOADS loads in flight a thread
  int k = 0, c = 0, f = threadIdx.x;
  carry(k, c, f, nb, s.C);
  while (k < nfr) {
    float2 v[GATHER_LOADS];
    int at[GATHER_LOADS];
#pragma unroll
    for (int u = 0; u < GATHER_LOADS; ++u) {
      at[u] = -1;
      if (k < nfr) {
        v[u] = __ldg(spec + src_off[k] + c * s.sc + f);
        at[u] = (k * s.C + c) * nb + f;
      }
      f += GATHER_THREADS;
      carry(k, c, f, nb, s.C);
    }
#pragma unroll
    for (int u = 0; u < GATHER_LOADS; ++u)
      if (at[u] >= 0) sx[at[u]] = v[u];
  }
  __syncthreads();
  // the frames' P x nb outputs, consecutive threads on consecutive
  // (frame, pair, bin) elements
  int p = 0;
  k = 0;
  f = threadIdx.x;
  carry(k, p, f, nb, s.P);
  for (; k < nfr; f += GATHER_THREADS, carry(k, p, f, nb, s.P)) {
    const int2 q = sp[p];
    const float2* x = sx + k * s.C * nb;
    out[dst_off[k] + p * s.op + f] =
        phat(x[q.x * nb + f], x[q.y * nb + f], eps);
  }
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

// spec complex64 [L, C, M, F], element (l, c, m, f) at l*sl + c*sc + m*sm + f
// (strides in complex elements); pairs int32 [P, 2] on the card, each index
// < C; out complex64, element (l, m, p, f) at l*ol + m*om + p*op + f, not
// aliasing spec; ft bins a tile and nf frames a CTA (kernels/cps.py,
// gather_plan).  Returns cudaErrorInvalidValue when the nf frames' C x ft
// bins and the pairs do not fit the kernel's 48 KB of shared memory.
MCAX_API int mcax_cps_phat_gather(const void* spec, const void* pairs,
                                  void* out, int L, int C, int M, int F, int P,
                                  long long sl, long long sc, long long sm,
                                  long long ol, long long om, long long op,
                                  int ft, int nf, float eps, void* stream) {
  if ((long long)L * M == 0 || F == 0 || P == 0) return 0;
  const long long smem =
      pairs_bytes(P) + offsets_bytes(nf) + 8LL * C * ft * nf;
  if (C <= 0 || ft <= 0 || ft > F || nf <= 0 || nf > GATHER_THREADS ||
      smem > GATHER_SMEM)
    return (int)cudaErrorInvalidValue;
  const GatherShape s{L, C, M, F, P, sl, sc, sm, ol, om, op, ft, nf};
  const dim3 grid((unsigned)mcax::ceil_div((long long)L * M, nf),
                  (unsigned)mcax::ceil_div(F, ft));
  cps_gather_kernel<<<grid, GATHER_THREADS, (int)smem,
                      (cudaStream_t)stream>>>(
      static_cast<const float2*>(spec), static_cast<const int2*>(pairs),
      static_cast<float2*>(out), s, eps);
  return (int)cudaGetLastError();
}
