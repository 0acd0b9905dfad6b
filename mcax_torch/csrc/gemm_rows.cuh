// The register-tiled fp32 GEMM body shared by the DFT kernels.
//
//     out[row, :] = A[row, 0:K] @ B[0:K, :]
//
// with the rows of A gathered by the caller's row loader and the product
// written by the caller's epilogue, so one body serves the STFT of frame =
// 2*hop (stft_fused.cu: a row is two hop-sized slabs), the windowed real DFT
// of strided frame rows and the inverse real DFT of complex spectra rows
// (dft.cu).
//
// Design.  A 128x128 output tile per block of 256 threads, 8x8 fp32 FMA
// accumulators per thread, K walked in 16-deep slices through shared memory.
// Each thread owns one A row of the tile (row tid/2, K offset 8*(tid&1)) and
// loads 8 consecutive K values of it per slice; the loader zero-fills a K
// tail and rows past the end.  B is dense, row-major with leading dimension
// ldb: the caller guarantees that ceil(K/16)*16 rows of ldb floats are
// readable, ldb is a multiple of 4 and covers every column tile the grid
// touches (the wrappers pad B to whole 16 x 128 tiles at plan time), and a
// 16-byte-aligned base.  Every product is an fp32 FMA in a fixed order over
// k = 0, 1, ..., so an element's value does not depend on the row count or
// the tile it falls in.  No TF32.
//
// A row loader is a type with
//     struct Row;                                   (trivially copyable)
//     __device__ Row row(long long r) const;        (called for r < rows)
//     __device__ void load8(const Row&, int k0, int ak, float (&v)[8]) const;
// where load8 fills v with A[r, k0+ak .. k0+ak+7] (zero past K).  An
// epilogue is a type with
//     __device__ void operator()(long long row, int col, float v0, float v1)
// called for every even column pair (col, col+1) of the tile, in range or
// not: the epilogue checks its own bounds.
#pragma once

#include "common.cuh"

namespace mcax {
namespace gemm {

constexpr int BM = 128;  // A rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 16;   // K slice held in shared memory
constexpr int THREADS = 256;

template <class ARows, class Epilogue>
__global__ void __launch_bounds__(THREADS, 2) gemm_rows_kernel(
    ARows a_rows, long long rows, int K, const float* __restrict__ b,
    int ldb, Epilogue epilogue) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // A loader: thread -> (row tid/2, k offset 8*(tid&1)), 8 floats a slice.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const long long r = row0 + a_row;
  const bool row_ok = r < rows;
  typename ARows::Row arow{};
  if (row_ok) arow = a_rows.row(r);
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

  for (int k0 = 0; k0 < K; k0 += BK) {
    float av[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row_ok) a_rows.load8(arow, k0, a_k, av);
#pragma unroll
    for (int i = 0; i < 8; ++i) As[a_k + i][a_row] = av[i];
    const float* bsrc = b + (long long)(k0 + b_k) * ldb + col0 + b_c;
    *reinterpret_cast<float4*>(&Bs[b_k][b_c]) =
        *reinterpret_cast<const float4*>(bsrc);
    *reinterpret_cast<float4*>(&Bs[b_k][b_c + 4]) =
        *reinterpret_cast<const float4*>(bsrc + 4);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], bb[8];
      const float4 x0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 y0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 y1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = x0.x; a[1] = x0.y; a[2] = x0.z; a[3] = x0.w;
      a[4] = x1.x; a[5] = x1.y; a[6] = x1.z; a[7] = x1.w;
      bb[0] = y0.x; bb[1] = y0.y; bb[2] = y0.z; bb[3] = y0.w;
      bb[4] = y1.x; bb[5] = y1.y; bb[6] = y1.z; bb[7] = y1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      epilogue(row, col, acc[i][j], acc[i][j + 1]);
    }
  }
}

// Row loader: dense complex64 rows read as K = 2 * (complex count) floats
// (re, im interleaved), row r at y + r*K; rows only 8-byte aligned, so
// float2 loads.  K is even: a pair never straddles the K tail.
struct ComplexRows {
  using Row = const float*;
  const float* y;
  int K;
  __device__ Row row(long long r) const { return y + r * K; }
  __device__ void load8(const Row& p, int k0, int ak, float (&v)[8]) const {
    const int k = k0 + ak;
    if (k + 8 <= K) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(p + k + 2 * i);
        v[2 * i] = a.x;
        v[2 * i + 1] = a.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = k + i < K ? p[k + i] : 0.0f;
    }
  }
};

// Epilogue: real rows [rows, ncol]: float2 stores when ncol is even (every
// pair then lies wholly in range and 8-byte aligned), guarded scalars
// otherwise.
struct RealRowsOut {
  float* out;
  long long rows;
  int ncol;
  __device__ void operator()(long long row, int col, float v0,
                             float v1) const {
    if (row >= rows || col >= ncol) return;
    float* o = out + row * ncol + col;
    if ((ncol & 1) == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (col + 1 < ncol) o[1] = v1;
    }
  }
};

// Epilogue: complex64 rows [rows, ncol / 2].  Column pairs (2f, 2f+1) are
// one bin -> float2 stores; ncol is even and every column pair starts even,
// so col < ncol covers the pair (the ragged F edge).
struct ComplexRowsOut {
  float* out;  // [rows, ncol]
  long long rows;
  int ncol;
  __device__ void operator()(long long row, int col, float v0,
                             float v1) const {
    if (row < rows && col < ncol)
      *reinterpret_cast<float2*>(out + row * ncol + col) =
          make_float2(v0, v1);
  }
};

// Launch over `rows` A rows and `ncol` output columns; returns
// cudaGetLastError() (cudaErrorInvalidValue past the grid's row limit).
template <class ARows, class Epilogue>
int launch_gemm_rows(const ARows& a_rows, long long rows, int K,
                     const float* b, int ldb, int ncol,
                     const Epilogue& epilogue, void* stream) {
  const long long row_tiles = ceil_div(rows, BM);
  if (rows <= 0 || row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(ncol, BN), (unsigned)row_tiles);
  gemm_rows_kernel<ARows, Epilogue>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(a_rows, rows, K, b, ldb,
                                                    epilogue);
  return (int)cudaGetLastError();
}

}  // namespace gemm
}  // namespace mcax
