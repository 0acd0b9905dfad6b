// Steered response power from a materialised PHAT cross-power spectrum.
//
// Replaces: mcax/kernels/steer.py, _srp_power_pallas (the Pallas kernel
// _steer_kernel: srp_power_flat under MCAX_SRP=matmul, which srp_surface's
// materialised branch and ShardedPipeline's pair-sharded SRP reach).
//
// What it computes.
//     power[m, g] = sum_k Re(cps[m, k]) E_re[k, g] - Im(cps[m, k]) E_im[k, g]
// with cps complex64 [M, K] (K = P*F: the PHAT cross-power of every pair
// and bin of frame m, as kernel 9 writes it) and the steering phases E
// [K, G].  The complex row is read as 2K interleaved floats, and the two
// products and the subtraction become ONE product with the stacked operand
//     B' [2K, G]:  B'[2k] = E_re[k],  B'[2k+1] = -E_im[k]
// (kernels/steer.py builds it at plan time), so the subtraction falls into
// the accumulation, as in the reference's kernel, and no re/im planes are
// copied out.  Every product is an fp32 FMA; no TF32.
//
// What bounds it on this card.  4*M*K*G fp32 operations: at config4, B =
// 512 (M = 12 288 frames, K = 28 * 513 = 14 364, G = 360) 254 GFLOP, 3.79 ms
// at 67 TFLOP/s on the CUDA cores, against 1.47 GB of bytes (the CPS is
// 1.41 GB), 0.44 ms at 3.35 TB/s: bound by operations.  At one block (M =
// 24) it moves 44 MB (mostly B') for 0.5 GFLOP: bound by bytes, 0.013 ms.
//
// Design.  The register-tiled SGEMM body of gemm_rows.cuh (128 x 128 output
// tiles, 8 x 8 accumulators a thread, K in 16-deep slices through shared
// memory) with the dense complex-row loader (float2 loads: a row is only
// 8-byte aligned when K is odd) and the plain real-rows store epilogue,
// both shared with kernel 7.  B' is padded to whole 16 x 128 tiles at plan
// time (kfft.pad_to_tiles), so the body reads it without bounds checks.  At
// few rows (one block's 24 frames) the grid is 3 tiles wide and 1 deep,
// each walking all of 2K: split-K would fill the card, and is later work.
#include "gemm_rows.cuh"

// cps complex64 [M, K] (as [M, 2K] floats), b2 [>= ceil(2K/16)*16 readable
// rows, ldb] (ldb a multiple of 128 covering G, zero past G), out float32
// [M, G].
MCAX_API int mcax_srp_power_cps(const void* cps, const float* b2, float* out,
                                long long M, int K, int G, int ldb,
                                void* stream) {
  return mcax::gemm::launch_gemm_rows(
      mcax::gemm::ComplexRows{static_cast<const float*>(cps), 2 * K}, M,
      2 * K, b2, ldb, G, mcax::gemm::RealRowsOut{out, M, G}, stream);
}
