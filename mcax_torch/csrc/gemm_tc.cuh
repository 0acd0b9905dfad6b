// A 3xTF32 tensor-core GEMM body with an optional split of K, shared by
// the steered power of kernel 10 (steer.cu) and the fused SRP of kernel 2
// (srp_fused.cu):
//
//     part[s, row, :] = A[row, k in chunk s] @ B[k in chunk s, :]
//
// The body (mma_slice, store_tile) takes a 32-deep slice of its operand
// tiles from shared memory, whoever made them: kernel 10's cp.async loader
// (gemm_3xtf32_kernel below) copies them from device memory, kernel 2's
// generator makes them on chip.
//
// Kernel 10's operands.  A is [rows, K] fp32 with rows only 8-byte aligned
// (a complex64 row read as floats: K = 2 * complex count, so K is even but
// K/2 may be odd); B is [K, ldb] fp32, row-major, ldb a multiple of 4
// covering every column tile the grid touches, 16-byte-aligned base.
// Nothing past K is read: loads beyond a chunk's end are zero-filled by
// cp.async, so B needs no padded rows.
//
// Precision.  Every operand x is split as big = tf32(x) (cvt.rna.tf32.f32:
// round to nearest, ties away from zero, to 10 mantissa bits) and small =
// x - big, which the tensor cores read truncated to TF32, and each product
// is accumulated as small*big + big*small + big*big on mma.sync.m16n8k8
// with fp32 accumulators.  The dropped small*small term and small's
// truncation are ~2^-21 of the product, so the products keep about
// fp32's accuracy (plain TF32 keeps ~3 digits and would miss the 1e-4 bound
// of the power's argmax).  The tensor cores' own fp32 accumulation does not
// round to nearest: carried over all of 2K = 28 728 in one accumulator it
// drifted 2e-4 of the peak power on the card, as one-sided as truncation.
// So each 32-deep slice is summed by the tensor cores from zero (12 MMAs a
// tile) and added into the running sum by an IEEE fp32 add.  Every chunk's
// sum runs over k in one fixed order and the partials are added in a fixed
// order by a second launch (no atomics), so two calls on the same inputs
// are bit-equal.
//
// Tiles.  A 64 x 128 output tile per block of 256 threads (8 warps as 2 x 4,
// each warp 32 x 32: 2 x 4 m16n8 accumulator tiles, 32 fp32 a thread for
// the sum and 32 for the slice).  Kernel 10 brings K in 32-deep slices
// through a 3-stage cp.async ring in dynamic shared memory (80 KB: two
// blocks an SM).  A is copied 8 bytes at a time (its rows are only 8-byte
// aligned), B 16 bytes.  Rows are padded (A by 8 floats, B by 4) so that
// the fragment loads of a warp hit 32 distinct banks: A's 8-byte loads at
// (8*group + 2*(lane%4)) for each half warp, B at (8*(lane%4) + group)
// and, a row on, 4 banks further.
#pragma once

#include "common.cuh"

namespace mcax {
namespace tc {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;   // __launch_bounds__: <= 128 registers
constexpr int A_LD = BK + 8;   // floats a row of the A slice in shared memory
constexpr int B_LD = BN + 4;   // floats a row of the B slice
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;

// the cp.async helpers of common.cuh, as members of this namespace for the
// sources that use it
using mcax::cp_async16;
using mcax::cp_async8;
using mcax::cp_async_commit;
using mcax::cp_async_wait;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small): big = tf32(x), small = x - big exactly, handed to the
// tensor cores as it is (they read a .tf32 operand's top 19 bits, so small
// is truncated to TF32 there: one instruction fewer than rounding it).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's place in the block's 64 x 128 tile.
struct WarpTile {
  int wm, wn, grp, tig;   // rows wm*32, columns wn*32; the lane's group
  __device__ WarpTile() {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    wm = warp >> 2;
    wn = warp & 3;
    grp = lane >> 2;
    tig = lane & 3;
  }
};

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// The MMA body: acc += (the 32-deep slice as [BM][A_LD] at as times the
// slice as [BK][B_LD] at bs, both in shared memory), the slice summed by
// the tensor cores from zero and added into acc by IEEE fp32 adds.
__device__ __forceinline__ void mma_slice(const float* __restrict__ as,
                                          const float* __restrict__ bs,
                                          const WarpTile& w,
                                          float (&acc)[2][4][4]) {
  as += (w.wm * 32) * A_LD;
  bs += w.wn * 32;
  float part[2][4][4];
  zero(part);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    // The fragment's k columns (tig, tig + 4) are taken as the slice's
    // k = (2 tig, 2 tig + 1), in A and in B alike (a sum does not care
    // which k is which), so a thread's two A values of a row are one
    // 8-byte load.  A's halves stay in registers for the 8-deep step;
    // B's are made one column tile at a time (fewer live registers).
    uint32_t ab[2][4], asm_[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = as + (mi * 16 + w.grp) * A_LD + kk + 2 * w.tig;
      const float2 lo = *reinterpret_cast<const float2*>(p);
      const float2 hi = *reinterpret_cast<const float2*>(p + 8 * A_LD);
      split_tf32(lo.x, ab[mi][0], asm_[mi][0]);
      split_tf32(hi.x, ab[mi][1], asm_[mi][1]);
      split_tf32(lo.y, ab[mi][2], asm_[mi][2]);
      split_tf32(hi.y, ab[mi][3], asm_[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      uint32_t bb[2], bsm[2];
      const float* p = bs + (kk + 2 * w.tig) * B_LD + ni * 8 + w.grp;
      split_tf32(p[0], bb[0], bsm[0]);
      split_tf32(p[B_LD], bb[1], bsm[1]);
      // the two row tiles' products interleaved: no MMA waits on the
      // one just issued
      mma_tf32(part[0][ni], asm_[0], bb);
      mma_tf32(part[1][ni], asm_[1], bb);
      mma_tf32(part[0][ni], ab[0], bsm);
      mma_tf32(part[1][ni], ab[1], bsm);
      mma_tf32(part[0][ni], ab[0], bb);
      mma_tf32(part[1][ni], ab[1], bb);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// The block's tile at (row0, col0) of dst fp32 [rows, ncol], its edge
// masked; 8-byte stores when ncol is even.
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4],
                                           const WarpTile& w,
                                           float* __restrict__ dst,
                                           long long rows, int ncol,
                                           long long row0, int col0) {
  const bool pairs = (ncol & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = col0 + w.wn * 32 + ni * 8 + w.tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + w.wm * 32 + mi * 16 + w.grp + h * 8;
        if (row >= rows || col >= ncol) continue;
        float* o = dst + row * ncol + col;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (col + 1 < ncol) o[1] = v1;
        }
      }
    }
}

// Kernel 10's block: output tile (blockIdx.x % col_tiles, blockIdx.x /
// col_tiles), K chunk blockIdx.y = [s * chunk, min((s + 1) * chunk, K))
// floats (chunk a multiple of BK), its slices copied from device memory by
// cp.async.  Writes fp32 [rows, ncol] at out + s * rows * ncol.
// (The kernels and their launchers are static: every source that includes
// this header, steer.cu and srp_fused.cu, builds its own copy.)
static __global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gemm_3xtf32_kernel(
    const float* __restrict__ a, long long rows, int K,
    const float* __restrict__ b, int ldb, int ncol, int col_tiles, int chunk,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][A_LD]
  float* Bs = smem + STAGES * A_STAGE;       // [STAGES][BK][B_LD]

  const int tid = threadIdx.x;
  const WarpTile w;
  const int col0 = (blockIdx.x % col_tiles) * BN;
  const long long row0 = (long long)(blockIdx.x / col_tiles) * BM;
  const int kbeg = blockIdx.y * chunk;
  const int kend = min(kbeg + chunk, K);
  const int nk = (kend - kbeg + BK - 1) / BK;

  // Loader: A as 8-byte pairs (16 a row of the slice, 4 a thread), B as
  // 16-byte quads (32 a row, 4 a thread).
  auto load_stage = [&](int stage, int k0) {
    float* as = As + stage * A_STAGE;
    float* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * THREADS;
      const int r = id >> 4;
      const int kc = (id & 15) * 2;
      const long long gr = row0 + r;
      const bool ok = gr < rows && k0 + kc < kend;
      const float* src = ok ? a + gr * K + k0 + kc : a;
      cp_async8(as + r * A_LD + kc, src, ok ? 8 : 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * THREADS;
      const int kr = id >> 5;
      const int cc = (id & 31) * 4;
      const bool ok = k0 + kr < kend;
      const float* src = ok ? b + (long long)(k0 + kr) * ldb + col0 + cc : b;
      cp_async16(bs + kr * B_LD + cc, src, ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kbeg + s * BK);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // every warp is past slice it-1, so its stage may be refilled
    const int pre = it + STAGES - 1;
    if (pre < nk) load_stage(pre % STAGES, kbeg + pre * BK);
    cp_async_commit();
    mma_slice(As + (it % STAGES) * A_STAGE, Bs + (it % STAGES) * B_STAGE, w,
              acc);
  }
  cp_async_wait<0>();
  store_tile(acc, w, out + (long long)blockIdx.y * rows * ncol, rows, ncol,
             row0, col0);
}

// out[i] = part[0][i] + part[1][i] + ... + part[S-1][i], in that order.
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           int S, long long n,
                                           float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = part[i];
    for (int s = 1; s < S; ++s) v += part[s * n + i];
    out[i] = v;
  }
}

// The second launch of a split product: out [n] = the sum of part [S, n]
// in split order.  Returns cudaGetLastError().
static inline int launch_sum_partials(const float* part, int splits,
                                      long long n, float* out,
                                      cudaStream_t stream) {
  const long long blocks = ceil_div(n, 256) < 4096 ? ceil_div(n, 256) : 4096;
  sum_partials_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, splits, n,
                                                            out);
  return (int)cudaGetLastError();
}

// Launch: with splits == 1 the product goes straight to out; otherwise the
// chunks' partials go to scratch [splits, rows, ncol] and a second launch
// sums them into out.  chunk (floats of K per split) is a multiple of BK
// and covers K in `splits` pieces.  Returns cudaGetLastError().
static inline int launch_gemm_3xtf32(const float* a, long long rows, int K,
                                     const float* b, int ldb, int ncol,
                                     int splits, int chunk, float* scratch,
                                     float* out, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long col_tiles = ceil_div(ncol, BN);
  const long long tiles = ceil_div(rows, BM) * col_tiles;
  if (rows <= 0 || ncol <= 0 || splits < 1 || splits > 65535 ||
      chunk % BK || (long long)splits * chunk < K ||
      (long long)(splits - 1) * chunk >= K || tiles > 0x7fffffffLL ||
      (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_3xtf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  float* dst = splits == 1 ? out : scratch;
  gemm_3xtf32_kernel<<<dim3((unsigned)tiles, (unsigned)splits), THREADS,
                       SMEM_BYTES, stream>>>(a, rows, K, b, ldb, ncol,
                                             (int)col_tiles, chunk, dst);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_sum_partials(scratch, splits, rows * ncol, out, stream);
}

}  // namespace tc
}  // namespace mcax
