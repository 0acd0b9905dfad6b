// Windowed real FFT of strided frame rows cut from contiguous signals.
//
// Replaces: mcax/kernels/stft_fused.py, stft_fused_planes (the Pallas kernel
// _kernel: the block step's analysis, frame = 2*hop) and mcax/kernels/fft.py,
// _rdft_pallas (the Pallas kernel _rdft_kernel: the analysis at any other
// overlap, and the DFT of materialised frames), for frames of a power of
// two from 32 to 4096 samples.  Other frames stay on the DFT-as-GEMM
// kernels (stft_fused.cu's mcax_stft_planes, dft.cu's mcax_rdft_rows); the
// wrappers pick the kernel from the frame before the launch.
//
// What it computes.  Frame row r of S signals x [S, N] starts at
//     x + (r / T)*N + (r % T)*hop
// and holds L = 2H samples; out[r, :], complex64 [S*T, H + 1], is its real
// spectrum with the analysis window w folded in:
//     X[r, k] = sum_p w[p] x_r[p] e^{-2 pi j k p / L}.
// Kernel 5 is hop = H (T = N/hop - 1); kernel 8 is any hop >= 1 (config3 at
// hop 128: L = 4*hop; a materialised [rows, L] tensor: T = 1, N = L).
//
// What bounds it on this card.  Its bytes: every input sample read once,
// every bin written once (kernel 5 at config4 S = 64: 12 288 frames, ~76 MB,
// ~0.023 ms at 3.35 TB/s; kernel 8 at config3 hop 128, B = 512: ~0.34 GB,
// ~0.10 ms).  A real FFT's ~2.5 L log2 L operations a frame lie far under
// them; a DFT as a GEMM does 4*L*F a frame, ~17x the byte floor at config4.
//
// Design, on rfft.cuh (the packing, the Stockham passes, the real post-pass
// and the store are the STFT-from-blocks kernel's own, so the same samples
// give the same bits):
//   * One block per run of fr = 2048 / H consecutive frames t0 .. t0+nf-1
//     of one signal (nf = fr but in a signal's last run), on a 1-D grid of
//     (signal, run); offsets are 64-bit.
//   * Each input sample is read once by the block.  When frames overlap
//     (hop < L) the block reads the stretch [t0*hop, (t0+nf-1)*hop + L)
//     once; when they do not (hop >= L) it reads its nf frames and never
//     the gaps.  Loads are 16 bytes wide when every row start is 16-byte
//     aligned (x, N and hop multiples of 4 floats; a group of 4 samples
//     then never straddles a frame's edge), scalar otherwise.  Each
//     sample, windowed in registers, goes to every frame of the run that
//     holds it (L / hop frames when the hop divides L): position p' =
//     q - f*hop of frame f is the real part of z[p'/2] when p' is even,
//     the imaginary part when odd.
//   * T = 1 (materialised rows, each its own signal) is launched as one
//     signal of `rows` frames at hop N, so a block still takes fr frames.
//   * Rows are [S*T, F] in row order, so a run's frames are contiguous in
//     the output and store_bins writes them with coalesced 8-byte stores.
#include "rfft.cuh"

namespace {

using namespace mcax::rfft;

// Sample v at run offset q (hop < L) into frames f_lo .. f_hi.
__device__ __forceinline__ void scatter1(float* zf, int q, float v,
                                         const float* __restrict__ win,
                                         int hop, int f_lo, int f_hi,
                                         int lh) {
  for (int f = f_lo; f <= f_hi; ++f) {
    const int p = q - f * hop;
    zf[2 * pad((f << lh) + (p >> 1)) + (p & 1)] = __ldg(win + p) * v;
  }
}

// Grid: (S signals) x (runs a signal), flattened; see the design note.
__global__ void __launch_bounds__(THREADS) fft_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ op,
    float2* __restrict__ out, long long N, long long hop, long long T,
    long long runs, int lh, int vec) {
  extern __shared__ __align__(16) float2 buf[];   // [2][PADDED]
  float* zf = reinterpret_cast<float*>(buf);
  const int L = 2 << lh;
  const int fr = SPAN >> lh;                      // frames a block
  const long long s = blockIdx.x / runs;
  const long long t0 = (blockIdx.x - s * runs) * fr;
  const long long left = T - t0;
  const int nf = (int)(left < fr ? left : fr);
  const float* src = x + s * N + t0 * hop;
  const float* win = op;                          // [L]
  const float2* tw = reinterpret_cast<const float2*>(op + L);

  if (hop < L) {
    // overlapping frames: the run's stretch, each sample once
    const int h = (int)hop;
    const int len = (nf - 1) * h + L;
    if (vec) {
      for (int i = threadIdx.x; i < len >> 2; i += THREADS) {
        const int q = 4 * i;
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
        const int f_hi = min(nf - 1, q / h);
        const int f_lo = q < L ? 0 : (q - L) / h + 1;
        for (int f = f_lo; f <= f_hi; ++f) {
          const int p = q - f * h;
          pack4(buf, (f << lh) + (p >> 1),
                __ldg(reinterpret_cast<const float4*>(win + p)), v);
        }
      }
    } else {
      for (int q = threadIdx.x; q < len; q += THREADS)
        scatter1(zf, q, __ldg(src + q), win, h, q < L ? 0 : (q - L) / h + 1,
                 min(nf - 1, q / h), lh);
    }
  } else if (vec) {
    // disjoint frames: each frame's samples, the gaps never read
    const int l4 = lh - 1;                        // log2(L / 4)
    for (int i = threadIdx.x; i < nf << l4; i += THREADS) {
      const int f = i >> l4;
      const int p = (i & ((1 << l4) - 1)) << 2;
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(src + f * hop + p));
      pack4(buf, (f << lh) + (p >> 1),
            __ldg(reinterpret_cast<const float4*>(win + p)), v);
    }
  } else {
    for (int i = threadIdx.x; i < nf << (lh + 1); i += THREADS) {
      const int f = i >> (lh + 1);
      const int p = i & (L - 1);
      zf[2 * pad((f << lh) + (p >> 1)) + (p & 1)] =
          __ldg(win + p) * __ldg(src + f * hop + p);
    }
  }
  __syncthreads();
  const float2* z = fft_frames(buf, lh, tw);
  store_bins(z, out + (s * T + t0) * ((L >> 1) + 1), nf, lh, tw);
}

}  // namespace

// x: the signals' base; out complex64 [rows, L/2 + 1]; op [3L] (the window
// [L], then e^{-2 pi j k / L} for k < L as (re, im) pairs); rows = S*T
// frames, frame r at x + (r / T)*N + (r % T)*hop, L a power of two in
// [32, 4096], (T - 1)*hop + L <= N (the wrapper checks).  vec != 0 asserts
// that x, N and hop keep every row start 16-byte aligned; op's base is
// 16-byte aligned.
MCAX_API int mcax_fft_rows(const float* x, const float* op, void* out,
                           long long rows, long long N, long long hop,
                           long long T, int L, int vec, void* stream) {
  int lh = 0;                                     // log2 H, H = L/2
  while ((2 << lh) < L) ++lh;
  if ((2 << lh) != L || lh < 4 || lh > 11 || rows <= 0 || T <= 0 ||
      rows % T || hop < 1 || (T - 1) * hop + L > N)
    return (int)cudaErrorInvalidValue;
  if (T == 1) {                  // rows r at x + r*N: one signal at hop N
    hop = N;
    T = rows;
  }
  const long long runs = mcax::ceil_div(T, SPAN >> lh);
  const long long blocks = rows / T * runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  fft_rows_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                    (cudaStream_t)stream>>>(
      x, op, static_cast<float2*>(out), N, hop, T, runs, lh, vec);
  return (int)cudaGetLastError();
}
