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
// ~2.5 N log2 N operations a frame lie far under them.  A DFT as a GEMM
// does 4*rows*N*F fp32 operations instead (~207 GFLOP at config4, B = 512:
// ~3.1 ms at 67 TFLOP/s, 17x the byte floor), so no GEMM can approach it.
//
// Design.
//   * From blocks, power-of-two frames of 32 to 4096 (every preset's):
//     mcax_stft_fft_from_blocks, a shared-memory real FFT (rfft.cuh).  A
//     block takes 2048 / hop consecutive frames of one channel and reads
//     their hop-sized slabs once (the carry for slab -1) with 16-byte
//     loads: a sample feeds both frames it falls in from registers, so it
//     is read once, not twice.  It windows the slab as it packs each frame
//     into hop complex values, runs the Stockham passes in shared memory,
//     and writes every frame's F bins with coalesced 8-byte stores straight
//     into [C, B*T, F].  Window and twiddles come in one operand made on
//     the host in float64 (kernels/fft.py, fft_operand).
//   * Planes, power-of-two frames: fft_rows.cu's strided-rows FFT, on the
//     same rfft.cuh packing, passes and store (the wrapper launches it).
//   * Both entry points, any other frame with hop % 16 == 0 (--set
//     stft.frame_len=640, say): the register-tiled SGEMM body of
//     gemm_rows.cuh (128x128 output tiles, 8x8 fp32 FMA accumulators per
//     thread, K = 2*hop in 16-deep slices) with its A operand gathered on
//     the fly: each thread resolves its A row's two slab pointers once,
//     through the entry point's row functor, so the [rows, 2*hop] frame
//     tensor never exists.  Every product is an fp32 FMA.
// The wrapper picks the route from the frame before the launch; both hold
// the 3e-6 (scaled) parity bound.
#include "rfft.cuh"
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

namespace {

// Grid (ceil(M / frames a block), C); see the design note above.
__global__ void __launch_bounds__(mcax::rfft::THREADS) stft_fft_blocks_kernel(
    const float* __restrict__ samples, const float* __restrict__ carry,
    const float* __restrict__ op, float2* __restrict__ out, int C, int L,
    int T, long long M, int lh) {
  using namespace mcax::rfft;
  extern __shared__ __align__(16) float2 buf[];   // [2][PADDED]
  const int hop = 1 << lh;                        // = H, the FFT's points
  const int fr = SPAN >> lh;                      // frames a block
  const int c = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * fr;
  const float* win = op;                          // [2*hop]
  const float2* tw = reinterpret_cast<const float2*>(op + 2 * hop);

  // Slabs m0-1 .. m0+fr-1: their addresses once each (the only divisions),
  // then float4 u of slab i feeds the hi half of frame m0+i-1 and the lo
  // half of frame m0+i.
  __shared__ const float* slab[SPAN / 16 + 1];
  for (int i = threadIdx.x; i <= fr; i += THREADS) {
    const long long s = m0 - 1 + i;
    slab[i] = s < 0 ? carry + (long long)c * hop
              : s >= M ? nullptr
                       : samples + ((s / T) * C + c) * (long long)L +
                             (s % T) * hop;
  }
  __syncthreads();
  const int lq4 = lh - 2;
  for (int idx = threadIdx.x; idx < (fr + 1) << lq4; idx += THREADS) {
    const int i = idx >> lq4;
    const int u = idx & ((1 << lq4) - 1);
    const float* src = slab[i];
    if (src == nullptr) continue;
    const float4 x = __ldg(reinterpret_cast<const float4*>(src) + u);
    if (i >= 1)
      pack4(buf, ((i - 1) << lh) + (hop >> 1) + 2 * u,
            __ldg(reinterpret_cast<const float4*>(win + hop) + u), x);
    if (i < fr && slab[i + 1] != nullptr)
      pack4(buf, (i << lh) + 2 * u,
            __ldg(reinterpret_cast<const float4*>(win) + u), x);
  }
  __syncthreads();
  const float2* z = fft_frames(buf, lh, tw);

  // each frame's F bins, contiguous in the output
  const long long left = M - m0;
  store_bins(z, out + ((long long)c * M + m0) * (hop + 1),
             (int)(left < fr ? left : fr), lh, tw);
}

}  // namespace

// samples [B, C, L], carry [C, hop], op [3 * 2*hop] (the window [2*hop],
// then e^{-2 pi j k / (2*hop)} for k < 2*hop as (re, im) pairs), out
// complex64 [C, B*L/hop, hop + 1].  hop is a power of two in [16, 2048], L
// % hop == 0, bases 16-byte aligned (the wrapper checks).
MCAX_API int mcax_stft_fft_from_blocks(const float* samples,
                                       const float* carry, const float* op,
                                       void* out, int B, int C, int L,
                                       int hop, void* stream) {
  int lh = 0;
  while ((1 << lh) < hop) ++lh;
  if ((1 << lh) != hop || lh < 4 || lh > 11 || B <= 0 || C <= 0 ||
      C > 65535 || L % hop)
    return (int)cudaErrorInvalidValue;
  const int T = L / hop;
  const long long M = (long long)B * T;
  const long long blocks = mcax::ceil_div(M, mcax::rfft::SPAN >> lh);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stft_fft_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mcax::rfft::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  stft_fft_blocks_kernel<<<dim3((unsigned)blocks, (unsigned)C),
                           mcax::rfft::THREADS, mcax::rfft::SMEM_BYTES,
                           (cudaStream_t)stream>>>(
      samples, carry, op, static_cast<float2*>(out), C, L, T, M, lh);
  return (int)cudaGetLastError();
}

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
