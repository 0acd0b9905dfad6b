// Hopper's warpgroup MMA (wgmma) in TF32 with both operands in shared
// memory, the mbarriers of shared-memory rings and the bulk copies (TMA)
// that fill them: the product body of
// kernel 2 (srp_fused.cu; kernel 10 keeps gemm_tc.cuh's mma.sync body).
// track.cu's particle_scan takes only the mbarriers, for its ring of
// blocks.
//
// wgmma.mma_async.m64nNk8.f32.tf32.tf32 is issued by a warpgroup (4 warps,
// 128 threads) and runs asynchronously on the SM's tensor cores:
//   D[64, N] (+)= A[64, 8] B[8, N]
// D in registers, N / 2 fp32 a thread: warp w of the group rows 16 w ..
// 16 w + 15; thread (g = lane / 4, t = lane % 4) holds d[4 j + e] at row g
// (e < 2) or g + 8 (e >= 2), column 8 j + 2 t + (e & 1).  A and B are read
// through descriptors: .tf32 operands are K-major only, each stored as core
// matrices of 8 rows (m of A, n of B) x 16 bytes (4 k) laid out as 128
// contiguous bytes, the two core matrices of an 8-deep step `lbo` bytes
// apart and the groups of 8 rows `sbo` bytes apart, no swizzle.  The tensor
// cores read a .tf32 operand's top 19 bits: a value that is not TF32 is
// truncated.  scale_d = 0 makes D = A B, ignoring D's old contents.
// (A from registers was tried: the issuing warps' own ALU work, the CPS,
// then ran at a fraction of its speed beside their products.)
//
// The rules kept by the caller: wgmma.fence before the first wgmma that
// reads registers written since (D's); D untouched between the wgmma and
// the wait that retires it; shared memory written by the generic proxy
// made visible to the async proxy (fence.proxy.async) before the wgmma
// that reads it is released to.
#pragma once

#include "common.cuh"

namespace mcax {
namespace wg {

// The descriptor of a K-major B operand at shared address `addr` (16-byte
// aligned), no swizzle.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, uint32_t lbo,
                                                 uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of a register across the wgmma
// instructions (their asm does not tell it when D is read and written).
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared memory written by this thread's generic stores, made visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for a finite x (to nearest, ties away from zero): half
// a TF32 ulp added to the magnitude's bits and the 13 bits below cleared,
// two instructions against the conversion's four.  Bit-equal to cvt.rna.tf32.f32 on every finite x,
// subnormals and an overflow to infinity near FLT_MAX included (card test
// test_tf32_rna_is_cvt_rna); an infinity stays one, a NaN may become -0 or
// an infinity (a split's small = x - big is NaN all the same).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Register reallocation across warpgroups (sm_90a): every warp of the
// group executes it, in one branch of the kernel that never rejoins.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// mbarriers in shared memory: init (one thread, then a fence and a block
// barrier), arrive (release), and the test of a phase by its parity
// (acquire).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// An arrival that also tells the barrier to expect `bytes` more of
// transactions (a bulk copy's) before its phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// An L2 eviction policy for a copy's reads: its lines evicted first (data
// read once, that should not push out what the next kernels read) or as
// any other line.
__device__ __forceinline__ uint64_t l2_policy(bool evict_first) {
  uint64_t p;
  if (evict_first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(p));
  return p;
}
// One bulk copy (the TMA unit, no tensor map) of `bytes` from device memory
// to shared memory, both 16-byte aligned and `bytes` a multiple of 16, its
// reads under the L2 `policy`; its completion counts `bytes` of
// transactions on `bar`.  Issued by one thread; the copy writes through the
// async proxy, as wgmma reads.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}
// true once the phase of `parity` has completed (a bounded wait in the
// hardware; the caller loops).
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// D (+)= A B, m64n120k8, fp32 from TF32, both operands read through their
// descriptors (the asm names every register of D).
__device__ __forceinline__ void mma_n120(float (&d)[60], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, %60, %61, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(a), "l"(b), "r"(scale_d));
}

}  // namespace wg
}  // namespace mcax
