// Per-block prefix covariances of the recursive spatial covariance.
//
// Replaces: mcax/kernels/covprefix.py, block_prefixes_rows (the Pallas
// kernel _kernel).
//
// What it computes.  For spectra X [C, B*T, F] (complex64) and a seed
// covariance cov0 [F, C, C] (float re/im planes [F, C, C, 2], or none):
//     covs[b] = lam^T covs[b-1] + sum_t (1-lam) lam^(T-1-t) x_t x_t^H,
//     covs[-1] = cov0,
// for every bin, written in the rows layout [B, 2C^2, F]: row i*C+j is
// Re R[i,j] and row C^2+i*C+j is Im R[i,j].  The MVDR solve reads these rows
// directly; the last block's rows become the streaming state.
//
// What bounds it on this card.  ~3.2 GFLOP against ~0.4 GB of spectra read
// and ~0.13 GB of rows written at config4, B = 512 (~0.16 ms at
// 3.35 TB/s): memory-bound.
//
// Design: per-block partials in parallel over (bin tile, chunk of blocks),
// then a scan over the chunks.  The Python planner (kernels/covprefix.py,
// plan_chunks) cuts the B blocks into K chunks of L consecutive blocks
// (the last may be shorter) so that the grid fills the card.
//   1. cov_partials_kernel, grid (bin tiles, K).  A CTA of 256 threads owns
//      FB = 256/KC bins and one chunk; thread (row i, bin) of KC = 8, 16 or
//      32 rows (C <= KC) keeps the C elements (i, 0..C-1) of its bin's
//      partial and running prefix in registers.  The chunk's frames stream
//      through shared memory in slabs of SLAB frames x C channels x FB bins,
//      STAGES slabs in flight by cp.async (8-byte copies: F is odd at every
//      configuration, so a row of bins is not 16-byte aligned); each frame's
//      C spectra are read from device memory once, and the C threads of a
//      bin read x_j as one broadcast, so the C^2-fold re-read of the
//      one-thread-an-element design is gone.  The frame weights
//      (1-lam) lam^(T-1-t) are made once a CTA in fp64 and rounded to fp32.
//      Within the chunk the recursion runs from zero (chunk 0 from cov0), a
//      block's partial summed over its T frames in frame order and added as
//      prefix = decay * prefix + partial; each block's prefix rows go
//      through shared memory to coalesced stores of FB bins a row.  These
//      are the local prefixes, final for chunk 0.
//   2. cov_carries_kernel, one thread per (row, bin): the serial pass over
//      the chunks' last local prefixes,
//          carry_0 = local_end_0,  carry_k = decay^L carry_{k-1} + local_end_k,
//      into a scratch [K-1, 2C^2, F] the wrapper allocates.
//   3. cov_fixup_kernel, grid (row-bin tiles, K-1): the rows of chunk k >= 1
//      read and rewritten, prefix_b = local_b + decay^(b-start+1) carry_{k-1}.
//   That is option (i) of the redesign: ~0.80 GB at config4 B = 512 (the
//   spectra and the rows once, the rows of chunks 1..K-1 read and written
//   again), ~0.24 ms at 3.35 TB/s, 1.5x the function's floor, in exchange
//   for three simple launches and no inter-CTA waiting.  Every sum is taken
//   in a fixed order, so two calls are bit-equal; the powers of decay are
//   made by repeated fp32 multiplication (1 * decay * decay ...), in the
//   carries and the fix-up with explicitly rounded operations, as the CPU
//   replay (tests/test_torch_covprefix_scan.py) makes them.  decay = 1
//   (lam = 1) and decay underflowing to 0 take the same path.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // a CTA of cov_partials_kernel
constexpr int SLAB = 4;        // frames a pipeline stage holds
constexpr int STAGES = 3;      // stages in the cp.async ring
constexpr int FIX_THREADS = 256;

// The thread layout for KC rows: FB bins a CTA; XS, the float2 stride of a
// channel's bins in a staged frame, and OS, the float stride of a row of the
// output staging, padded so that the CTA's shared-memory accesses are free
// of bank conflicts.
template <int KC>
struct Tile {
  static constexpr int FB = THREADS / KC;
  static constexpr int XS = FB + (KC == 8 ? 2 : 1);
  static constexpr int OS = FB + 32 / KC;
};

using mcax::cp_async8;
using mcax::cp_async_commit;
using mcax::cp_async_wait;

// Dynamic shared memory of cov_partials_kernel: the slab ring, the output
// staging and the T frame weights.
template <int KC>
size_t partials_smem_bytes(int C, int T) {
  using Tl = Tile<KC>;
  return (size_t)STAGES * SLAB * C * Tl::XS * sizeof(float2) +
         (size_t)2 * C * C * Tl::OS * sizeof(float) + (size_t)T * sizeof(float);
}

// CC = C when it is known at compile time (8 and 16, the presets'), so
// that every index into the slabs and the staging is constant arithmetic;
// CC = 0 takes C from c_arg (any C <= KC).
template <int KC, int CC>
__global__ void __launch_bounds__(THREADS)
cov_partials_kernel(const float2* __restrict__ spec,
                    const float* __restrict__ cov0, float* __restrict__ out,
                    int c_arg, int B, int T, int F, float lam, float decay,
                    int chunk_len) {
  using Tl = Tile<KC>;
  const int C = CC ? CC : c_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* xs = reinterpret_cast<float2*>(smem_raw);
  float* os = reinterpret_cast<float*>(xs + STAGES * SLAB * C * Tl::XS);
  float* wts = os + 2 * C * C * Tl::OS;

  const int tid = threadIdx.x;
  const int i = tid % KC;
  const int bin = tid / KC;
  const int f0 = blockIdx.x * Tl::FB;
  const int f = f0 + bin;
  const int b0 = blockIdx.y * chunk_len;
  const int nb = min(chunk_len, B - b0);
  const int nframes = nb * T;
  const long long M = (long long)B * T;

  for (int t = tid; t < T; t += THREADS)
    wts[t] = (float)((1.0 - (double)lam) *
                     pow((double)lam, (double)(T - 1 - t)));

  // A slab is SLAB frames x C channels x FB bins; thread tid < C*FB copies
  // channel lc's bin lb of each of its frames (a warp: a run of bins).
  const int lc = tid / Tl::FB;
  const int lb = tid % Tl::FB;
  const bool loader = lc < C;
  const bool lb_ok = f0 + lb < F;
  const float2* lsrc = spec + ((long long)(loader ? lc : 0) * M +
                               (long long)b0 * T) * F + f0 + lb;
  float2* ldst = xs + lc * Tl::XS + lb;
  auto load_slab = [&](int s, int stage) {
    if (!loader) return;
#pragma unroll
    for (int fr = 0; fr < SLAB; ++fr) {
      const int ft = s * SLAB + fr;
      const bool ok = lb_ok && ft < nframes;
      cp_async8(ldst + (stage * SLAB + fr) * C * Tl::XS,
                ok ? lsrc + (long long)ft * F : spec, ok ? 8 : 0);
    }
  };

  float pr[KC], pi[KC], ar[KC], ai[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    pr[j] = pi[j] = ar[j] = ai[j] = 0.0f;
    if (blockIdx.y == 0 && cov0 != nullptr && i < C && f < F && j < C) {
      const float* c0 = cov0 + (((long long)f * C + i) * C + j) * 2;
      ar[j] = c0[0];
      ai[j] = c0[1];
    }
  }
  const int ic = i < C ? i : 0;   // rows past C compute on row 0, unstored
  const int cc = C * C;

  const int nslabs = (nframes + SLAB - 1) / SLAB;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslabs) load_slab(s, s);
    cp_async_commit();
  }
  int b = b0;                     // the block being summed
  int t = 0;                      // its frame
  for (int s = 0; s < nslabs; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nslabs)
      load_slab(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    const float2* slab = xs + (s % STAGES) * SLAB * C * Tl::XS + bin;
    const int nfr = min(SLAB, nframes - s * SLAB);
    for (int fr = 0; fr < nfr; ++fr) {
      const float2* xf = slab + fr * C * Tl::XS;
      const float2 xi = xf[ic * Tl::XS];
      const float wr = wts[t] * xi.x;
      const float wi = wts[t] * xi.y;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j < C) {
          const float2 xj = xf[j * Tl::XS];
          pr[j] += wr * xj.x + wi * xj.y;   // Re x_i conj(x_j)
          pi[j] += wi * xj.x - wr * xj.y;   // Im x_i conj(x_j)
        }
      }
      if (++t < T) continue;
      // block b done: prefix = decay * prefix + partial, staged by
      // (element j*C+i) so the C threads of a bin write distinct banks
      t = 0;
      if (i < C) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (j < C) {
            ar[j] = decay * ar[j] + pr[j];
            ai[j] = decay * ai[j] + pi[j];
            pr[j] = pi[j] = 0.0f;
            os[(j * C + i) * Tl::OS + bin] = ar[j];
            os[(cc + j * C + i) * Tl::OS + bin] = ai[j];
          }
        }
      }
      __syncthreads();
      float* ob = out + (long long)b * 2 * cc * F + f0;
      for (int e = tid; e < 2 * cc * Tl::FB; e += THREADS) {
        const int r = e / Tl::FB;            // staged row part*C^2 + j*C + i
        const int bb = e % Tl::FB;
        if (f0 + bb < F) {
          const int part = r / cc;
          const int q = r - part * cc;
          const int row = part * cc + (q % C) * C + q / C;
          ob[(long long)row * F + bb] = os[r * Tl::OS + bb];
        }
      }
      __syncthreads();
      ++b;
    }
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// decay^n by repeated multiplication from 1, as the CPU replay makes it.
__device__ __forceinline__ float decay_pow(float decay, int n) {
  float p = 1.0f;
  for (int r = 0; r < n; ++r) p = mul(p, decay);
  return p;
}

// carry_0 = local_end_0, carry_k = decay^L carry_{k-1} + local_end_k for
// k < K-1; E = 2C^2 F elements a block, chunks 0..K-2 all L blocks long.
__global__ void cov_carries_kernel(const float* __restrict__ rows,
                                   float* __restrict__ carry, long long E,
                                   int L, int K, float decay) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const float pl = decay_pow(decay, L);
  float c = rows[(long long)(L - 1) * E + e];
  carry[e] = c;
  for (int k = 1; k < K - 1; ++k) {
    c = add(mul(pl, c), rows[((long long)(k + 1) * L - 1) * E + e]);
    carry[(long long)k * E + e] = c;
  }
}

// rows of chunk k = blockIdx.y + 1: local_b + decay^(b-start+1) carry_{k-1}.
__global__ void cov_fixup_kernel(float* __restrict__ rows,
                                 const float* __restrict__ carry, long long E,
                                 int B, int L, float decay) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int k = blockIdx.y + 1;
  const int b0 = k * L;
  const int nb = min(L, B - b0);
  const float c = carry[(long long)(k - 1) * E + e];
  float p = 1.0f;
  float* r = rows + (long long)b0 * E + e;
#pragma unroll 4
  for (int q = 0; q < nb; ++q) {
    p = mul(p, decay);
    r[q * E] = add(r[q * E], mul(p, c));
  }
}

template <int KC, int CC>
int launch_partials(const void* spec, const float* cov0, float* out, int C,
                    int B, int T, int F, float lam, float decay,
                    int chunk_len, int chunks, cudaStream_t stream) {
  const size_t smem = partials_smem_bytes<KC>(C, T);
  cudaError_t e = cudaFuncSetAttribute(
      cov_partials_kernel<KC, CC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)mcax::ceil_div(F, Tile<KC>::FB), (unsigned)chunks);
  cov_partials_kernel<KC, CC><<<grid, THREADS, smem, stream>>>(
      static_cast<const float2*>(spec), cov0, out, C, B, T, F, lam, decay,
      chunk_len);
  return (int)cudaGetLastError();
}

template <int KC, int CC>
int layout(int C, int T, int* out) {
  const size_t smem = partials_smem_bytes<KC>(C, T);
  cudaError_t e = cudaFuncSetAttribute(
      cov_partials_kernel<KC, CC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cov_partials_kernel<KC, CC>, THREADS, smem);
  out[0] = Tile<KC>::FB;
  out[1] = per_sm;
  return (int)e;
}

// The instantiation for C channels: exact at 8, 16 and 32 (em32's 32
// capsules: 8.17 against 12.58 ms at B = 512, bit-equal), else the smallest
// KC >= C with C at run time.
#define MCAX_COV_DISPATCH(fn, ...)                          \
  (C == 8    ? fn<8, 8>(__VA_ARGS__)                        \
   : C == 16 ? fn<16, 16>(__VA_ARGS__)                      \
   : C == 32 ? fn<32, 32>(__VA_ARGS__)                      \
   : C < 8   ? fn<8, 0>(__VA_ARGS__)                        \
   : C < 16  ? fn<16, 0>(__VA_ARGS__)                       \
             : fn<32, 0>(__VA_ARGS__))

}  // namespace

// The partials kernel's layout for C channels and T frames a block:
// out[0] = bins a CTA, out[1] = CTAs an SM can hold (0: it does not fit).
MCAX_API int mcax_cov_prefix_layout(int C, int T, int* out) {
  if (C < 1 || C > 32 || T < 1) return (int)cudaErrorInvalidValue;
  return MCAX_COV_DISPATCH(layout, C, T, out);
}

// spec complex64 [C, B*T, F], cov0 [F, C, C, 2] or NULL, out [B, 2C^2, F],
// carry scratch [chunks-1, 2C^2, F] (NULL when chunks = 1); decay = lam^T;
// the B blocks in `chunks` chunks of chunk_len (the last may be shorter).
// The wrapper guarantees 1 <= C <= 32 and 0 < lam <= 1.
MCAX_API int mcax_cov_prefixes(const void* spec, const float* cov0,
                               float* out, float* carry, int C, int B, int T,
                               int F, float lam, float decay, int chunk_len,
                               int chunks, void* stream) {
  if (C < 1 || C > 32 || B < 1 || T < 1 || F < 1 || chunk_len < 1 ||
      chunks != (int)mcax::ceil_div(B, chunk_len) || chunks > 65535 ||
      (chunks > 1 && carry == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int code = MCAX_COV_DISPATCH(launch_partials, spec, cov0, out, C, B,
                                     T, F, lam, decay, chunk_len, chunks, st);
  if (code != 0 || chunks == 1) return code;
  const long long E = 2LL * C * C * F;
  const unsigned tiles = (unsigned)mcax::ceil_div(E, FIX_THREADS);
  cov_carries_kernel<<<tiles, FIX_THREADS, 0, st>>>(out, carry, E, chunk_len,
                                                    chunks, decay);
  cov_fixup_kernel<<<dim3(tiles, (unsigned)(chunks - 1)), FIX_THREADS, 0,
                     st>>>(out, carry, E, B, chunk_len, decay);
  return (int)cudaGetLastError();
}
