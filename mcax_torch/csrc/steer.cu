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
// the accumulation, as in the reference's kernel.
//
// What bounds it on this card.  4*M*K*G operations: at config4, B = 512
// (M = 12 288 frames, K = 28 * 513 = 14 364, G = 360) 254 GFLOP, 3.79 ms at
// 67 TFLOP/s in fp32 on the CUDA cores, and 3 x 254 GFLOP of TF32 on the
// tensor cores for this design, 1.54 ms at 495 TFLOP/s; its bytes (the CPS
// is 1.41 GB) take 0.44 ms at 3.35 TB/s.  At one block (M = 24) it moves
// 44 MB (mostly B') for 0.5 GFLOP: bound by bytes, 0.013 ms.
//
// Design (gemm_tc.cuh).  3xTF32 on the tensor cores (mma.sync m16n8k8,
// every operand split into two TF32 halves: about fp32's accuracy at up to
// 3x the CUDA cores' rate), 64 x 128 output tiles, a 3-stage cp.async ring,
// and a split of 2K into S chunks chosen by kernels/steer.py's planner
// (split_k_plan), whose partials a second launch sums in a fixed order:
//   * M = 24: 1 x 3 tiles cannot fill 132 SMs; S = 82 chunks of 11 slices
//     of 32 (898 slices in 2K = 28 728) give 246 blocks, one wave of the
//     264 slots (two blocks an SM), each walking 352 of 2K instead of all;
//   * M = 12 288: 192 x 3 = 576 tiles are 2.18 waves of 264 slots, so
//     unsplit the last wave is 18 % full; S = 5 makes 2 880 blocks, 10.9
//     waves, for 88 MB of partials (0.05 ms of traffic).  On an H100 SXM
//     (chip_smoke.py's unsplit_ms beside kernel_ms) S = 5 reads 5.46 ms
//     against S = 1's 6.20, and at M = 24 S = 82 reads 0.046 ms against
//     1.46.
// Why not wgmma and TMA yet: a TF32 wgmma reads both operands K-major from
// shared memory, which needs a transposed B' [G, 2K] built at plan time, and
// TMA needs 16-byte row strides, which an odd K does not give the CPS rows.
// That is the next step if mma.sync leaves the kernel short of half its
// bound.
#include "gemm_tc.cuh"

// cps complex64 [M, K] (as [M, 2K] floats), b2 [2K, ldb] (ldb a multiple of
// 4 covering ceil(G/128)*128 columns, zero past G), scratch float32 [S, M,
// G] (unused, may be NULL, when S == 1), out float32 [M, G]; chunk = floats
// of 2K a split, a multiple of 32.
MCAX_API int mcax_srp_power_cps(const void* cps, const float* b2,
                                float* scratch, float* out, long long M, int K,
                                int G, int ldb, int splits, int chunk,
                                void* stream) {
  return mcax::tc::launch_gemm_3xtf32(static_cast<const float*>(cps), M,
                                      2 * K, b2, ldb, G, splits, chunk,
                                      scratch, out, stream);
}

// The tiles kernels/steer.py's planner assumes: BM, BN, BK and the blocks an
// SM holds, written to tiles[0..3] (checked at the first launch).
MCAX_API int mcax_gemm_tc_tiles(int* tiles) {
  tiles[0] = mcax::tc::BM;
  tiles[1] = mcax::tc::BN;
  tiles[2] = mcax::tc::BK;
  tiles[3] = mcax::tc::BLOCKS_PER_SM;
  return 0;
}
