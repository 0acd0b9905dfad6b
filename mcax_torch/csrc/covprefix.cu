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
// Design.  One thread per (bin, element (i, j) of the C x C matrix), all C^2
// elements computed independently from their own seed as the reference
// does (no Hermitian shortcut), looping serially over the B blocks and,
// inside each block, over its T frames.  A warp covers 32 consecutive bins
// of one element, so every load and store is coalesced; the C warps of a
// block share row channel i, so x_i comes from L1 and the C blocks of one
// bin range run side by side and share x_j through L2.  The frame weights
// are made once per block in shared memory.  The serial B loop leaves few
// warps in flight (F/32 * C^2 warps in all), so each thread issues the
// loads of 8 frames before it uses any of them, to keep that many memory
// requests in flight; a split into per-block partials plus a scan over B
// is later work.
#include "common.cuh"

namespace {

constexpr int GATHER = 8;  // frames whose loads are issued together

__global__ void cov_prefixes_kernel(const float2* __restrict__ spec,
                                    const float* __restrict__ cov0,
                                    float* __restrict__ out, int C, int B,
                                    int T, int F, float lam, float decay) {
  extern __shared__ float wts[];  // [T]: (1-lam) lam^(T-1-t)
  const int lane = threadIdx.x + threadIdx.y * blockDim.x;
  for (int t = lane; t < T; t += blockDim.x * blockDim.y)
    wts[t] = (float)((1.0 - (double)lam) *
                     pow((double)lam, (double)(T - 1 - t)));
  __syncthreads();

  const int i = blockIdx.x;
  const int j = threadIdx.y;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (f >= F) return;

  const long long M = (long long)B * T;
  const float2* xi = spec + (long long)i * M * F + f;
  const float2* xj = spec + (long long)j * M * F + f;
  float ar = 0.0f, ai = 0.0f;
  if (cov0 != nullptr) {
    const float* c0 = cov0 + (((long long)f * C + i) * C + j) * 2;
    ar = c0[0];
    ai = c0[1];
  }
  const long long cc = (long long)C * C;
  float* o_re = out + (i * C + j) * (long long)F + f;
  float* o_im = out + (cc + i * C + j) * (long long)F + f;
  const long long o_step = 2 * cc * F;

  for (int b = 0; b < B; ++b) {
    const long long base = (long long)b * T * F;
    float pr = 0.0f, pi = 0.0f;
    for (int t0 = 0; t0 < T; t0 += GATHER) {
      // issue the group's loads before any use: GATHER frames in flight
      float2 u[GATHER], v[GATHER];
#pragma unroll
      for (int k = 0; k < GATHER; ++k) {
        if (t0 + k < T) {
          u[k] = xi[base + (long long)(t0 + k) * F];
          v[k] = xj[base + (long long)(t0 + k) * F];
        }
      }
#pragma unroll
      for (int k = 0; k < GATHER; ++k) {
        if (t0 + k < T) {
          const float wr = wts[t0 + k] * u[k].x;
          const float wi = wts[t0 + k] * u[k].y;
          pr += wr * v[k].x + wi * v[k].y;  // Re x_i conj(x_j)
          pi += wi * v[k].x - wr * v[k].y;  // Im x_i conj(x_j)
        }
      }
    }
    ar = decay * ar + pr;
    ai = decay * ai + pi;
    o_re[b * o_step] = ar;
    o_im[b * o_step] = ai;
  }
}

}  // namespace

// spec complex64 [C, B*T, F], cov0 [F, C, C, 2] or NULL, out [B, 2C^2, F];
// decay = lam^T.  The wrapper guarantees 1 <= C <= 32 and 0 < lam <= 1.
MCAX_API int mcax_cov_prefixes(const void* spec, const float* cov0,
                               float* out, int C, int B, int T, int F,
                               float lam, float decay, void* stream) {
  const dim3 block(32, C);
  const dim3 grid(C, (unsigned)mcax::ceil_div(F, 32));
  cov_prefixes_kernel<<<grid, block, T * sizeof(float),
                        (cudaStream_t)stream>>>(
      static_cast<const float2*>(spec), cov0, out, C, B, T, F, lam, decay);
  return (int)cudaGetLastError();
}
