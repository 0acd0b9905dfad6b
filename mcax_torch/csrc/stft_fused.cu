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
// Design.  The register-tiled SGEMM body of gemm_rows.cuh (128x128 output
// tiles, 8x8 fp32 FMA accumulators per thread, K = 2*hop in 16-deep slices)
// with its A operand gathered on the fly: each thread resolves its A row's
// two slab pointers once, through the entry point's row functor, so the
// [rows, 2*hop] frame tensor never exists.  No TF32: every product is an
// fp32 FMA, which holds the 3e-6 (scaled) parity bound.  Tensor-core
// (3xTF32) tiles are later work.
#include "gemm_rows.cuh"

namespace {

// A frame row's two slabs; a K slice of 16 never straddles them (hop % 16
// == 0), so a slice starting below hop lies wholly in the first.
struct Slabs {
  const float* lo;
  const float* hi;
};

__device__ __forceinline__ void load_slabs(const Slabs& s, int hop, int k0,
                                           int ak, float (&v)[8]) {
  const float* src = (k0 < hop ? s.lo + k0 : s.hi + (k0 - hop)) + ak;
  const float4 a0 = *reinterpret_cast<const float4*>(src);
  const float4 a1 = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
  v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
}

// Row m of channel c from the blocked input: [slab m-1 | slab m].
struct BlocksRows {
  using Row = Slabs;
  const float* samples;  // [B, C, L]
  const float* carry;    // [C, hop]
  int C, L, hop, T;
  long long M;           // B*T frames per channel
  __device__ Row row(long long r) const {
    const int c = (int)(r / M);
    const long long m = r % M;
    Row s;
    s.hi = samples + ((m / T) * C + c) * (long long)L + (m % T) * hop;
    if (m == 0) {
      s.lo = carry + (long long)c * hop;
    } else {
      const long long mp = m - 1;
      s.lo = samples + ((mp / T) * C + c) * (long long)L + (mp % T) * hop;
    }
    return s;
  }
  __device__ void load8(const Row& s, int k0, int ak, float (&v)[8]) const {
    load_slabs(s, hop, k0, ak, v);
  }
};

// Row t of signal r of a contiguous [R, N] input: [slab t | slab t+1].
struct PlanesRows {
  using Row = Slabs;
  const float* x;
  int N, hop, T;
  __device__ Row row(long long r) const {
    const long long s = r / T;
    Row out;
    out.lo = x + s * N + (r - s * T) * hop;
    out.hi = out.lo + hop;
    return out;
  }
  __device__ void load8(const Row& s, int k0, int ak, float (&v)[8]) const {
    load_slabs(s, hop, k0, ak, v);
  }
};

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
  const long long rows = (long long)C * M;
  return mcax::gemm::launch_gemm_rows(
      BlocksRows{samples, carry, C, L, hop, T, M}, rows, 2 * hop, w2, ldw,
      2 * F, mcax::gemm::ComplexRowsOut{out, rows, 2 * F}, stream);
}

// x [R, N], w2 as above, out [R, N/hop - 1, 2F] (complex64 [R, T, F]).  The
// wrapper guarantees hop % BK == 0, N % hop == 0, N >= 2*hop and a
// 16-byte-aligned base.
MCAX_API int mcax_stft_planes(const float* x, const float* w2, float* out,
                              long long R, int N, int hop, int F, int ldw,
                              void* stream) {
  const int T = N / hop - 1;
  return mcax::gemm::launch_gemm_rows(
      PlanesRows{x, N, hop, T}, R * T, 2 * hop, w2, ldw, 2 * F,
      mcax::gemm::ComplexRowsOut{out, R * T, 2 * F}, stream);
}
