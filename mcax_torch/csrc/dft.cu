// Matmul-form real DFT and inverse real DFT of rows, windows folded in.
//
// Replaces: mcax/kernels/fft.py, _rdft_pallas (the Pallas kernel
// _rdft_kernel: kfft.rfft, the analysis of any overlap other than frame =
// 2*hop) for frames that are not a power of two from 32 to 4096 (those
// take fft_rows.cu's FFT), and _irdft_pallas (the Pallas kernel
// _irdft_kernel: kfft.irfft) for the inverses that are not a full
// synthesis of such a frame: a synthesis of any other frame length, and
// GCC's lag correlation, a selection of W = 13 of the synthesis matrix's
// columns (a full synthesis of a power-of-two frame takes irfft_rows.cu's
// FFT).  kfft.rdft_rows and kfft.irdft_rows pick the kernel from the shape
// before the launch.
//
// What it computes.
//   * rdft_rows: frame row r of a real signal starts at
//         x + (r / T)*N + (r % T)*hop
//     and holds L samples (T frames of hop per signal of N samples; a
//     materialised [rows, L] frame tensor is T = 1, N = L).  Its spectrum is
//         X[r, :] = frame_r @ (Wr + j Wi)
//     with the analysis window folded into w2 [L, ldw] (column 2f = Re, 2f+1
//     = Im, zero past 2F), so the product's rows are complex64 [rows, F].
//   * irdft_rows: spectra y complex64 [rows, F], read as 2F floats per row,
//     times a2 [2F, N] (row 2k = Ar[k], 2k+1 = Ai[k], synthesis window
//     folded into the columns) gives the frames x float32 [rows, N].
//
// What bounds it on this card.  A full transform needs only its bytes (a
// real FFT's operations are fewer); this design, a DFT as a GEMM, does
// 4*rows*F*N fp32 operations, so it is compute-bound, as the TPU kernel it
// replaces was on the MXU.  GCC's lags need 4*rows*F*W operations for W
// columns, fewer than a full transform's bytes and FFT when W is small
// (config1: W = 13 of N = 512).
//
// Design.  The SGEMM body of gemm_rows.cuh with two row loaders (kernel 7's,
// ComplexRows, and its real-rows epilogue are in the header).  Neither
// operand is padded at run time: the DFT matrices are padded at plan time
// to whole 16-row x 128-column tiles (kfft.analysis_matrix,
// kfft.synthesis_matrix), and the loaders zero-fill the K tail (L may be any
// length, 2F is 1026 or 514).  Spectra rows are 2F floats long, so only
// 8-byte aligned: kernel 7 reads them as float2.  Kernel 8 reads float4
// where every row start is 16-byte aligned (hop and N multiples of 4) and
// scalars otherwise.  Kernel 7's output may have an odd width (GCC's
// lag-folded W = 13): its epilogue stores scalars unless N is even.
#include "gemm_rows.cuh"

namespace {

// Frame rows of a signal: row r at x + (r / T)*N + (r % T)*hop, K = L.
struct StridedRows {
  using Row = const float*;
  const float* x;
  long long N;
  int hop, T, L;
  bool vec;  // every row start 16-byte aligned
  __device__ Row row(long long r) const {
    const long long s = r / T;
    return x + s * N + (r - s * T) * (long long)hop;
  }
  __device__ void load8(const Row& p, int k0, int ak, float (&v)[8]) const {
    const int k = k0 + ak;
    if (vec && k + 8 <= L) {
      const float4 a0 = *reinterpret_cast<const float4*>(p + k);
      const float4 a1 = *reinterpret_cast<const float4*>(p + k + 4);
      v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
      v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = k + i < L ? p[k + i] : 0.0f;
    }
  }
};

}  // namespace

// x: the signals' base, out complex64 [rows, F] (as [rows, 2F] floats),
// w2 [>= ceil(L/16)*16 readable rows, ldw] (ldw a multiple of 128, zero
// past 2F).  vec != 0 asserts that x, N and hop keep every row start
// 16-byte aligned.
MCAX_API int mcax_rdft_rows(const float* x, const float* w2, float* out,
                            long long rows, long long N, int hop, int T,
                            int L, int F, int ldw, int vec, void* stream) {
  return mcax::gemm::launch_gemm_rows(
      StridedRows{x, N, hop, T, L, vec != 0}, rows, L, w2, ldw, 2 * F,
      mcax::gemm::ComplexRowsOut{out, rows, 2 * F}, stream);
}

// y complex64 [rows, F], a2 [>= ceil(2F/16)*16 readable rows, lda] (lda a
// multiple of 128, covering N), out float32 [rows, N].
MCAX_API int mcax_irdft_rows(const void* y, const float* a2, float* out,
                             long long rows, int F, int N, int lda,
                             void* stream) {
  return mcax::gemm::launch_gemm_rows(
      mcax::gemm::ComplexRows{static_cast<const float*>(y), 2 * F}, rows,
      2 * F, a2, lda, N, mcax::gemm::RealRowsOut{out, rows, N}, stream);
}
