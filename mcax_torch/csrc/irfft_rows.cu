// Inverse real FFT of spectra rows with the synthesis window.
//
// Replaces: mcax/kernels/fft.py, _irdft_pallas (the Pallas kernel
// _irdft_kernel: kfft.irfft, every synthesis chain's inverse DFT) for
// frames of a power of two from 32 to 4096 samples.  Other frames, and
// GCC's lag selection (a few columns of the synthesis matrix), stay on the
// DFT-as-GEMM kernel (dft.cu's mcax_irdft_rows); the wrapper picks the
// kernel from the shape before the launch.
//
// What it computes.  Row r of the spectra y complex64 [rows, H + 1] is the
// half spectrum X of a real frame of N = 2H samples; out[r, :], float32
// [rows, N], is
//     x[t] = w[t] / N * (X[0] + 2 sum_{0<k<H} Re(X[k] e^{2 pi j k t / N})
//                        + X[H] (-1)^t)
// with the imaginary parts of X[0] and X[H] ignored, as the synthesis
// matrix (kernels/fft.py, _inv_matrices) and torch.fft.irfft ignore them
// (the MVDR beamformer's output has them nonzero).
//
// What bounds it on this card.  Its bytes: every bin read once, every
// sample written once (config4, B = 512: 12 288 rows, ~0.1 GB, ~0.03 ms at
// 3.35 TB/s); a real FFT's ~2.5 N log2 N operations a frame lie far under
// them.
//
// Design: the forward real FFT of rfft.cuh run backwards, on its passes
// and twiddle table (kfft.fft_operand: the synthesis window, then
// e^{-2 pi j k / N} for k < N).  A block takes a run of SPAN / H
// consecutive rows:
//   1. Load: the run's (H + 1)-bin rows are contiguous, read as float2 (a
//      row of an odd bin count is only 8-byte aligned) into the second
//      FFT buffer.
//   2. Pre-pass, the post-pass of rfft.cuh inverted: with Im X[0] and
//      Im X[H] set to 0,
//          E[k] = (X[k] + conj X[H-k]) / 2,
//          O[k] = (X[k] - conj X[H-k]) e^{+2 pi j k / N} / 2
//      (the conjugate of the table's entry k), and Z[k] = E[k] + j O[k]
//      for k < H, written conjugated into the first buffer.
//   3. The H-point inverse FFT as conj(FFT(conj Z)) / H: fft_frames, the
//      forward passes unchanged.
//   4. Unpack: x[2n] = Re z[n], x[2n+1] = Im z[n], times the window (1/H
//      folded into it: a power of two, exact), two values a thread as one
//      16-byte store (N >= 32, the rows contiguous, out 16-byte aligned).
#include "rfft.cuh"

namespace {

using namespace mcax::rfft;

// Grid: one block per run of SPAN >> lh rows (the last run may be short).
__global__ void __launch_bounds__(THREADS) irfft_rows_kernel(
    const float2* __restrict__ y, const float* __restrict__ op,
    float* __restrict__ out, long long rows, int lh) {
  extern __shared__ __align__(16) float2 buf[];   // [2][PADDED]
  const int H = 1 << lh;
  const int N = 2 << lh;
  const int F = H + 1;
  const int fr = SPAN >> lh;                      // rows a block
  const long long r0 = (long long)blockIdx.x * fr;
  const long long left = rows - r0;
  const int nf = (int)(left < fr ? left : fr);
  const float* win = op;                          // [N]
  const float2* tw = reinterpret_cast<const float2*>(op + N);

  float2* bins = buf + PADDED;                    // [nf, F], unpadded
  const float2* src = y + r0 * F;
  for (int i = threadIdx.x; i < nf * F; i += THREADS) bins[i] = src[i];
  __syncthreads();

  for (int i = threadIdx.x; i < nf << lh; i += THREADS) {
    const int f = i >> lh;
    const int k = i & (H - 1);
    float2 a = bins[f * F + k];
    float2 b = bins[f * F + H - k];
    if (k == 0) {                                 // Im X[0], Im X[H]
      a.y = 0.0f;
      b.y = 0.0f;
    }
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 d = make_float2(0.5f * (a.x - b.x), 0.5f * (a.y + b.y));
    const float2 t = __ldg(tw + k);               // O = d * conj(t)
    const float2 o = make_float2(d.x * t.x + d.y * t.y, d.y * t.x - d.x * t.y);
    // conj(Z) = conj(E + j O)
    buf[pad(i)] = make_float2(e.x - o.y, -(e.y + o.x));
  }
  __syncthreads();
  const float2* z = fft_frames(buf, lh, tw);      // FFT(conj Z)

  const float inv_h = 1.0f / (float)H;
  float* dst = out + r0 * N;
  for (int i = threadIdx.x; i < nf << (lh - 1); i += THREADS) {
    const int n = 2 * i;                          // z index, frame-major
    const int t = (n & (H - 1)) * 2;              // sample in the frame
    const float2 u0 = z[pad(n)];
    const float2 u1 = z[pad(n + 1)];
    const float4 wv = __ldg(reinterpret_cast<const float4*>(win + t));
    *reinterpret_cast<float4*>(dst + 2 * n) =
        make_float4(u0.x * (wv.x * inv_h), -u0.y * (wv.y * inv_h),
                    u1.x * (wv.z * inv_h), -u1.y * (wv.w * inv_h));
  }
}

}  // namespace

// y complex64 [rows, N/2 + 1], op [3N] (the synthesis window [N], then
// e^{-2 pi j k / N} for k < N as (re, im) pairs; 16-byte-aligned base),
// out float32 [rows, N] (16-byte-aligned base); N a power of two in
// [32, 4096].
MCAX_API int mcax_irfft_rows(const void* y, const float* op, float* out,
                             long long rows, int N, void* stream) {
  int lh = 0;                                     // log2 H, H = N/2
  while ((2 << lh) < N) ++lh;
  const long long blocks = mcax::ceil_div(rows, SPAN >> lh);
  if ((2 << lh) != N || lh < 4 || lh > 11 || rows <= 0 ||
      blocks > 0x7fffffffLL || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(op) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      irfft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  irfft_rows_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(static_cast<const float2*>(y),
                                              op, out, rows, lh);
  return (int)cudaGetLastError();
}
