// Windowed real DFT of frame = 2*hop, the frames gathered on the fly.
//
// Replaces: mcax/kernels/stft_fused.py, stft_fused_from_blocks (the Pallas
// kernel _kern: the batched pipeline's analysis) and stft_fused_planes (the
// Pallas kernel _kernel: the block step's analysis of a contiguous signal).
//
// What it computes.  Every frame is two hop-sized slabs [lo | hi] of a
// signal, and its spectrum is
//     X[row, :] = [lo | hi] @ (Wr + j Wi)
// with the analysis window folded into the DFT matrices.  The matrices
// arrive interleaved as w2 [2*hop, ldw]: column 2f is Re, 2f+1 is Im, zero
// past 2F, so the product's rows ARE complex64 output rows.  The two entry
// points differ only in where a row's slabs lie:
//   * from blocks: samples [B, C, L] hold B consecutive blocks of C
//     channels, L = T*hop.  Slab j of channel c is samples[j / T, c,
//     (j % T)*hop : +hop] for j >= 0 and the streaming carry[c] for j = -1.
//     Row (c, m), m in [0, B*T), is [slab m-1 | slab m]; out [C, B*T, F].
//   * planes: x [R, N] holds R contiguous signals, N % hop == 0.  Row
//     (r, t), t in [0, N/hop - 1), is [slab t | slab t+1] of signal r;
//     out [R, T, F].
//
// What bounds it on this card.  The function itself needs only its bytes
// (config4, B = 512: ~0.6 GB, ~0.18 ms at 3.35 TB/s): a real FFT's
// operations are far fewer.  This design, a DFT as a GEMM, does
// 4*rows*N*F fp32 operations (~207 GFLOP at config4, B = 512: ~3.1 ms at
// 67 TFLOP/s on the CUDA cores), so the design is compute-bound, at ~17x
// the function's floor, while fp32 stays off the tensor cores.  A config4
// block (8 x 24 rows) fills 2 x 9 of the card's 132 SMs: that call is
// bound by its launch, not by either.
//
// Design.  A classic register-tiled SGEMM whose A operand is gathered on
// the fly: a 128x128 output tile per block of 256 threads, 8x8 fp32 FMA
// accumulators per thread, K = 2*hop walked in 16-deep slices through
// shared memory.  Each thread resolves its A row's two slab pointers once,
// through the entry point's row functor, so the [rows, 2*hop] frame tensor
// never exists.  No TF32: every product is an fp32 FMA, which holds the
// 3e-6 (scaled) parity bound.  Tensor-core (3xTF32) tiles are later work.
#include "common.cuh"

namespace {

constexpr int BM = 128;  // frame rows per block
constexpr int BN = 128;  // output float columns per block (64 complex bins)
constexpr int BK = 16;   // K slice held in shared memory
constexpr int THREADS = 256;

// Row m of channel c from the blocked input: [slab m-1 | slab m].
struct BlocksRows {
  const float* samples;  // [B, C, L]
  const float* carry;    // [C, hop]
  int C, L, hop, T;
  long long M;           // B*T frames per channel
  __device__ void operator()(long long r, const float*& lo,
                             const float*& hi) const {
    const int c = (int)(r / M);
    const long long m = r % M;
    hi = samples + ((m / T) * C + c) * (long long)L + (m % T) * hop;
    if (m == 0) {
      lo = carry + (long long)c * hop;
    } else {
      const long long mp = m - 1;
      lo = samples + ((mp / T) * C + c) * (long long)L + (mp % T) * hop;
    }
  }
};

// Row t of signal r of a contiguous [R, N] input: [slab t | slab t+1].
struct PlanesRows {
  const float* x;
  int N, hop, T;
  __device__ void operator()(long long r, const float*& lo,
                             const float*& hi) const {
    const long long s = r / T;
    lo = x + s * N + (r - s * T) * hop;
    hi = lo + hop;
  }
};

template <class Rows>
__global__ void __launch_bounds__(THREADS, 2) stft_gemm_kernel(
    Rows rows_of, long long rows, const float* __restrict__ w2,
    float* __restrict__ out, int hop, int F, int ldw) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int ncol = 2 * F;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // A loader: thread -> (row tid/2, k offset 8*(tid&1)), two float4 a slice.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const long long r = row0 + a_row;
  const bool row_ok = r < rows;
  const float* lo_ptr = w2;
  const float* hi_ptr = w2;
  if (row_ok) rows_of(r, lo_ptr, hi_ptr);
  // B loader: thread -> (k row tid/16, 8 columns at 8*(tid&15)).
  const int b_k = tid >> 4;
  const int b_c = (tid & 15) * 8;

  // Compute mapping: 16x16 threads; rows ty*4+{0..3} and 64+ty*4+{0..3},
  // columns tx*4+{0..3} and 64+tx*4+{0..3}.
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int K = 2 * hop;
  for (int k0 = 0; k0 < K; k0 += BK) {
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    if (row_ok) {
      const float* src = (k0 < hop ? lo_ptr + k0 : hi_ptr + (k0 - hop)) + a_k;
      a0 = *reinterpret_cast<const float4*>(src);
      a1 = *reinterpret_cast<const float4*>(src + 4);
    }
    As[a_k + 0][a_row] = a0.x;
    As[a_k + 1][a_row] = a0.y;
    As[a_k + 2][a_row] = a0.z;
    As[a_k + 3][a_row] = a0.w;
    As[a_k + 4][a_row] = a1.x;
    As[a_k + 5][a_row] = a1.y;
    As[a_k + 6][a_row] = a1.z;
    As[a_k + 7][a_row] = a1.w;
    const float* bsrc = w2 + (long long)(k0 + b_k) * ldw + col0 + b_c;
    *reinterpret_cast<float4*>(&Bs[b_k][b_c]) =
        *reinterpret_cast<const float4*>(bsrc);
    *reinterpret_cast<float4*>(&Bs[b_k][b_c + 4]) =
        *reinterpret_cast<const float4*>(bsrc + 4);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 x0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 y0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 y1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = x0.x; a[1] = x0.y; a[2] = x0.z; a[3] = x0.w;
      a[4] = x1.x; a[5] = x1.y; a[6] = x1.z; a[7] = x1.w;
      b[0] = y0.x; b[1] = y0.y; b[2] = y0.z; b[3] = y0.w;
      b[4] = y1.x; b[5] = y1.y; b[6] = y1.z; b[7] = y1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Store: column pairs (2f, 2f+1) are one complex64 bin -> float2 stores;
  // ncol is even and every column group starts even, so c < ncol covers
  // the pair (the ragged F edge).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= rows) continue;
    float* orow = out + row * ncol;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < ncol)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[i][j], acc[i][j + 1]);
    }
  }
}

template <class Rows>
int launch(const Rows& rows_of, long long rows, const float* w2, float* out,
           int hop, int F, int ldw, void* stream) {
  const dim3 grid((unsigned)mcax::ceil_div(2 * F, BN),
                  (unsigned)mcax::ceil_div(rows, BM));
  stft_gemm_kernel<Rows><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows_of, rows, w2, out, hop, F, ldw);
  return (int)cudaGetLastError();
}

}  // namespace

// samples [B, C, L], carry [C, hop], w2 [2*hop, ldw] (ldw a multiple of BN,
// zero past 2F), out [C, B*L/hop, 2F] (complex64 [C, M, F]).  The wrapper
// guarantees hop % BK == 0, L % hop == 0 and 16-byte-aligned bases.
MCAX_API int mcax_stft_from_blocks(const float* samples, const float* carry,
                                   const float* w2, float* out, int B, int C,
                                   int L, int hop, int F, int ldw,
                                   void* stream) {
  const int T = L / hop;
  const long long M = (long long)B * T;
  const BlocksRows rows_of{samples, carry, C, L, hop, T, M};
  return launch(rows_of, (long long)C * M, w2, out, hop, F, ldw, stream);
}

// x [R, N], w2 as above, out [R, N/hop - 1, 2F] (complex64 [R, T, F]).  The
// wrapper guarantees hop % BK == 0, N % hop == 0, N >= 2*hop and a
// 16-byte-aligned base.
MCAX_API int mcax_stft_planes(const float* x, const float* w2, float* out,
                              long long R, int N, int hop, int F, int ldw,
                              void* stream) {
  const int T = N / hop - 1;
  const PlanesRows rows_of{x, N, hop, T};
  return launch(rows_of, R * T, w2, out, hop, F, ldw, stream);
}
