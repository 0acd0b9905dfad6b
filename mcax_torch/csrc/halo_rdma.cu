// Ring push to the right neighbour by a store into its peer-mapped memory.
//
// Replaces: mcax/dist/halo_rdma.py:55, ring_push_right (the Pallas kernel
// that starts pltpu.make_async_remote_copy into the right ring neighbour's
// output and waits on its send and receive DMA semaphores): the halo and
// the overlap-add spill of the sharded pipeline (MCAX_HALO=rdma in mcax).
//
// What it computes.  Each rank of a ring of n processes along one mesh axis
// holds a payload of `nbytes` (the left halo [C_l, frame_len - hop] or the
// OLA spill, fp32, a few KiB); after one push every rank holds its LEFT
// neighbour's payload (rank 0 receives rank n-1's: the ring wraps).
//
// What bounds it on this card.  The payload crosses the link once: nbytes
// over NVLink's 450 GB/s one way (a few ns for 8 KiB), so a push is all
// latency — two launches, the fences, and the wait for the peer to arrive.
// On ONE card shared by several processes (no MPS) the contexts time-slice,
// and a wait only ends when the peer's context gets its slice: that time is
// the scheduler's, not the kernel's.
//
// Design.  Every rank allocates one receive buffer with cudaMalloc (an IPC
// handle names a whole allocation, so not torch's caching allocator) and
// shares it with cudaIpcGetMemHandle; each rank maps its right neighbour's
// (to store the payload and publish it) and its left neighbour's (to
// acknowledge) with cudaIpcOpenMemHandle.  Layout of a buffer:
//
//   [slot 0: slot_bytes][slot 1: slot_bytes][flag u64 | pad | ack u64 | pad]
//
// `flag` is written by the left neighbour (the last epoch it stored here),
// `ack` by the right neighbour (the last epoch it consumed from the slot this
// rank stored into it).  Push number e (epochs count from 1, per buffer):
//
//   put  (one block): wait until own ack >= e - 2 (the right neighbour has
//        consumed the slot's previous payload: the reuse hazard of one rank
//        running ahead), store the payload into the right neighbour's slot
//        e % 2, __threadfence_system(), then publish e into its flag with a
//        system-scope release store;
//   wait (one block): poll own flag with acquire loads and __nanosleep
//        back-off until it reads >= e, copy slot e % 2 into the output
//        (cache-volatile loads), then acknowledge e into the left
//        neighbour's ack with a system-scope release store.
//
// Both launch on the caller's stream, one after the other, with no host
// synchronisation.  Every spin is bounded by the global nanosecond timer
// (wall time, which keeps running while another context holds the card): on
// timeout the kernel writes an error code into a word of host-mapped memory,
// which the wrapper reads without synchronising and raises on, and a failed
// wait fills its output with NaN.  Once the word is set every later launch
// on the ring returns at once, so a lost peer costs one timeout, not one per
// push.
#include "common.cuh"

#include <cuda/atomic>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CTRL_BYTES = 256;   // flag at +0, ack at +128

using SysU64 = cuda::atomic_ref<unsigned long long, cuda::thread_scope_system>;
using SysInt = cuda::atomic_ref<int, cuda::thread_scope_system>;

__device__ __forceinline__ unsigned long long* flag_of(char* base,
                                                       long long slot_bytes) {
  return reinterpret_cast<unsigned long long*>(base + 2 * slot_bytes);
}

__device__ __forceinline__ unsigned long long* ack_of(char* base,
                                                      long long slot_bytes) {
  return reinterpret_cast<unsigned long long*>(base + 2 * slot_bytes + 128);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 only: spin until *word >= want.  False, with `code` in *err, on
// timeout; false at once if an earlier launch on the ring already failed.
__device__ bool spin_until(unsigned long long* word, unsigned long long want,
                           int* err, int code, long long timeout_ns) {
  SysInt e(*err);
  if (e.load(cuda::memory_order_relaxed) != 0) return false;
  SysU64 w(*word);
  const unsigned long long t0 = now_ns();
  unsigned ns = 32;
  while (w.load(cuda::memory_order_acquire) < want) {
    if ((long long)(now_ns() - t0) > timeout_ns) {
      e.store(code, cuda::memory_order_release);
      return false;
    }
    __nanosleep(ns);
    if (ns < 4096) ns *= 2;
  }
  return true;
}

// The block copies nbytes (a multiple of 4; both pointers 16-byte aligned):
// 16 bytes a thread while they last, then 4.  `fresh` reads past the caches
// (the slot was written by another process since this SM last looked).
template <bool fresh>
__device__ void copy_block(const char* src, char* dst, long long nbytes) {
  const long long n16 = nbytes / 16;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (long long i = threadIdx.x; i < n16; i += THREADS)
    d4[i] = fresh ? __ldcv(s4 + i) : s4[i];
  const unsigned* s1 = reinterpret_cast<const unsigned*>(src + 16 * n16);
  unsigned* d1 = reinterpret_cast<unsigned*>(dst + 16 * n16);
  for (long long i = threadIdx.x; i < (nbytes - 16 * n16) / 4; i += THREADS)
    d1[i] = fresh ? __ldcv(s1 + i) : s1[i];
}

__global__ void __launch_bounds__(THREADS) ring_put(
    const char* __restrict__ src, char* right, char* local, long long nbytes,
    long long slot_bytes, unsigned long long epoch, int* err,
    long long timeout_ns) {
  __shared__ int go;
  if (threadIdx.x == 0) {
    // slot epoch % 2 of the right neighbour is free once it acked epoch - 2
    go = spin_until(ack_of(local, slot_bytes), epoch > 2 ? epoch - 2 : 0,
                    err, 1, timeout_ns);
  }
  __syncthreads();
  if (!go) return;
  copy_block<false>(src, right + (epoch & 1) * slot_bytes, nbytes);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0)
    SysU64(*flag_of(right, slot_bytes)).store(epoch,
                                              cuda::memory_order_release);
}

__global__ void __launch_bounds__(THREADS) ring_wait(
    char* local, char* left, char* __restrict__ out, long long nbytes,
    long long slot_bytes, unsigned long long epoch, int* err,
    long long timeout_ns) {
  __shared__ int go;
  if (threadIdx.x == 0)
    go = spin_until(flag_of(local, slot_bytes), epoch, err, 2, timeout_ns);
  __syncthreads();
  if (!go) {
    unsigned* o = reinterpret_cast<unsigned*>(out);
    for (long long i = threadIdx.x; i < nbytes / 4; i += THREADS)
      o[i] = 0x7fc00000u;                            // NaN: nothing arrived
    return;
  }
  copy_block<true>(local + (epoch & 1) * slot_bytes, out, nbytes);
  __syncthreads();                                   // every read is done
  if (threadIdx.x == 0) {
    __threadfence_system();
    SysU64(*ack_of(left, slot_bytes)).store(epoch, cuda::memory_order_release);
  }
}

}  // namespace

// One rank's receive buffer: two slots of slot_bytes (a multiple of 256)
// and the control words, zeroed; its IPC handle (64 bytes) into `handle`.
// A host entry point: it synchronises the device.
MCAX_API int mcax_ring_alloc(long long slot_bytes, void** buf, void* handle) {
  const size_t bytes = (size_t)(2 * slot_bytes + CTRL_BYTES);
  cudaError_t e = cudaMalloc(buf, bytes);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaMemset(*buf, 0, bytes)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceSynchronize()) != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  if ((e = cudaIpcGetMemHandle(&h, *buf)) != cudaSuccess) return (int)e;
  memcpy(handle, &h, sizeof h);
  return 0;
}

// Map another process's buffer (its 64-byte handle) into this one.
MCAX_API int mcax_ring_open(const void* handle, void** buf) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(buf, h, cudaIpcMemLazyEnablePeerAccess);
}

MCAX_API int mcax_ring_close(void* buf) {
  return (int)cudaIpcCloseMemHandle(buf);
}

MCAX_API int mcax_ring_free(void* buf) { return (int)cudaFree(buf); }

// The error word: host-mapped memory, zeroed; `host` for the wrapper's
// reads, `dev` for the kernels' writes.
MCAX_API int mcax_ring_error_alloc(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, 64, cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  memset(*host, 0, 64);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

MCAX_API int mcax_ring_error_free(void* host) {
  return (int)cudaFreeHost(host);
}

// One push: the put into `right` (the right neighbour's mapped buffer),
// then the wait on `local` into `out`, acknowledged into `left`.  src and
// out: nbytes (a multiple of 4), 16-byte aligned; epoch >= 1, one more than
// the ring's previous push.
MCAX_API int mcax_ring_push(const void* src, void* out, void* local,
                            void* right, void* left, long long nbytes,
                            long long slot_bytes, unsigned long long epoch,
                            void* err, long long timeout_ns, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ring_put<<<1, THREADS, 0, s>>>(
      static_cast<const char*>(src), static_cast<char*>(right),
      static_cast<char*>(local), nbytes, slot_bytes, epoch,
      static_cast<int*>(err), timeout_ns);
  ring_wait<<<1, THREADS, 0, s>>>(
      static_cast<char*>(local), static_cast<char*>(left),
      static_cast<char*>(out), nbytes, slot_bytes, epoch,
      static_cast<int*>(err), timeout_ns);
  return (int)cudaGetLastError();
}
