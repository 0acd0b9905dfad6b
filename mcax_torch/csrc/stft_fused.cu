// Windowed real DFT of frames read straight from the blocked input.
//
// Replaces: mcax/kernels/stft_fused.py, stft_fused_from_blocks (the Pallas
// kernel _kern): the batched pipeline's analysis for frame = 2*hop.
//
// What it computes.  samples [B, C, L] hold B consecutive blocks of C
// channels, L = T*hop.  Slab j of channel c is samples[j / T, c, (j % T)*hop
// : +hop] for j >= 0 and the streaming carry[c] for j = -1.  Frame (c, m),
// m in [0, B*T), is [slab m-1 | slab m], and its spectrum is
//     X[c, m, :] = frame @ (Wr + j Wi)
// with the analysis window folded into the DFT matrices.  The matrices
// arrive interleaved as w2 [2*hop, ldw]: column 2f is Re, 2f+1 is Im, zero
// past 2F, so the product's rows ARE the complex64 output rows [C, M, F].
//
// What bounds it on this card.  The function itself needs only its ~0.6 GB
// of traffic (~0.18 ms at 3.35 TB/s): a real FFT's operations are far
// fewer.  This design, a DFT as a GEMM, does 4*(C*B*T)*N*F fp32 operations
// (~207 GFLOP at config4, B = 512: ~3.1 ms at 67 TFLOP/s on the CUDA
// cores), so the design is compute-bound, at ~17x the function's floor,
// while fp32 stays off the tensor cores.
//
// Design.  A classic register-tiled SGEMM whose A operand is gathered on
// the fly: a 128x128 output tile per block of 256 threads, 8x8 fp32 FMA
// accumulators per thread, K = 2*hop walked in 16-deep slices through
// shared memory.  Each thread resolves its A row's two slab pointers once
// (the carry for the dispatch's first frame, the previous block's last slab
// for a frame that straddles a block boundary), so the [C, M, 2*hop] frame
// tensor never exists.  No TF32: every product is an fp32 FMA, which holds
// the 3e-6 (scaled) parity bound.  Tensor-core (3xTF32) tiles are later
// work.
#include "common.cuh"

namespace {

constexpr int BM = 128;  // frame rows per block
constexpr int BN = 128;  // output float columns per block (64 complex bins)
constexpr int BK = 16;   // K slice held in shared memory
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS, 2) stft_from_blocks_kernel(
    const float* __restrict__ samples, const float* __restrict__ carry,
    const float* __restrict__ w2, float* __restrict__ out, int B, int C,
    int L, int hop, int F, int ldw) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int T = L / hop;
  const long long M = (long long)B * T;
  const long long rows = (long long)C * M;
  const int ncol = 2 * F;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // A loader: thread -> (row tid/2, k offset 8*(tid&1)), two float4 a slice.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const long long r = row0 + a_row;
  const bool row_ok = r < rows;
  const float* lo_ptr = carry;
  const float* hi_ptr = carry;
  if (row_ok) {
    const int c = (int)(r / M);
    const long long m = r % M;
    hi_ptr = samples + ((m / T) * C + c) * (long long)L + (m % T) * hop;
    if (m == 0) {
      lo_ptr = carry + (long long)c * hop;
    } else {
      const long long mp = m - 1;
      lo_ptr = samples + ((mp / T) * C + c) * (long long)L + (mp % T) * hop;
    }
  }
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

}  // namespace

// samples [B, C, L], carry [C, hop], w2 [2*hop, ldw] (ldw a multiple of BN,
// zero past 2F), out [C, B*L/hop, 2F] (complex64 [C, M, F]).  The wrapper
// guarantees hop % BK == 0, L % hop == 0 and 16-byte-aligned bases.
MCAX_API int mcax_stft_from_blocks(const float* samples, const float* carry,
                                   const float* w2, float* out, int B, int C,
                                   int L, int hop, int F, int ldw,
                                   void* stream) {
  const long long rows = (long long)C * B * (L / hop);
  const dim3 grid((unsigned)mcax::ceil_div(2 * F, BN),
                  (unsigned)mcax::ceil_div(rows, BM));
  stft_from_blocks_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      samples, carry, w2, out, B, C, L, hop, F, ldw);
  return (int)cudaGetLastError();
}
