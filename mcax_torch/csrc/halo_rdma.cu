// Ring push to the right neighbour by a store into its peer-mapped memory.
//
// Replaces: mcax/dist/halo_rdma.py:55, ring_push_right (the Pallas kernel
// that starts pltpu.make_async_remote_copy into the right ring neighbour's
// output and waits on its send and receive DMA semaphores): the halo and
// the overlap-add spill of the sharded pipeline (MCAX_HALO=rdma in mcax).
//
// What it computes.  Each rank of a ring of n processes along one mesh axis
// holds an fp32 payload of `rows` x `row_elems` elements, row r starting
// r * row_stride elements after the first (the left halo, the strided
// [C_l, frame_len - hop] tail of a [C_l, N] shard, read in place; or the
// OLA spill), a few KiB; after one push every rank holds its LEFT
// neighbour's payload, contiguous (rank 0 receives rank n-1's: the ring
// wraps).
//
// What bounds it on this card.  The payload crosses NVLink once, its bytes
// over 450 GB/s one way: 1.8e-5 ms for config4 2 x 2's 8 KiB halo.  A push
// is all latency, and its design floor is one store's one-way trip over
// NVLink, measured by mcax_ring_pingpong below (a word bounced between two
// cards, half the round trip).  On ONE card shared by several processes
// (no MPS) the contexts time-slice, and a wait ends only when the peer's
// context gets its slice: that time is the scheduler's, not the kernel's.
//
// Design: one launch a push, one block, no fence on the data path.
// Every rank allocates one receive buffer with cudaMalloc (an IPC handle
// names a whole allocation, so not torch's caching allocator) and shares it
// with cudaIpcGetMemHandle; each rank maps its right neighbour's (to store
// the payload) and its left neighbour's (to acknowledge) with
// cudaIpcOpenMemHandle.  Layout of a buffer:
//
//   [slot 0: slot_bytes][slot 1: slot_bytes][ack | pad | epoch | pad | ping]
//
// A slot holds one 8-byte word a payload element: the element's 32 bits
// low, the push's epoch (its low 32 bits) high, as NCCL's LL protocol tags
// its lines.  `ack` is written by the right neighbour (the last epoch it
// consumed from the slot this rank stores into); `epoch` is this rank's own
// count of pushes on the ring, kept on the card, so every push of a ring
// launches with the same arguments and can be captured in a CUDA graph;
// `ping` is the ping-pong's word.  Push number e (epochs count from 1):
//
//   thread 0 reads e - 1 from `epoch` (a plain load: the ring's previous
//   launch, on the same stream, wrote it) and waits until its own `ack` >=
//   e - 2 (the right neighbour has consumed the slot's previous payload;
//   only push e + 2 waits on push e's acknowledgement, so it stays off the
//   critical path).  Then every thread reads its elements (4 bytes a
//   thread, in place from the strided rows) and stores each, tagged, into
//   the right neighbour's slot e % 2 with one aligned 8-byte relaxed store
//   at system scope; no fence and no flag follow.  Every thread then polls
//   its own words of its own slot e % 2 (relaxed 8-byte loads at system
//   scope, 8 in flight a thread) until their tags read e, and writes their
//   data to `out`.  After the block's reads (__syncthreads) thread 0
//   acknowledges e into the left neighbour's `ack` with a system-scope
//   release store and bumps `epoch`.
//
// The tag makes each word its own flag: this relies on the card writing an
// aligned 8-byte store over NVLink as one transaction, so a reader never
// sees a new tag beside old data, as NCCL's LL protocol does.  Buffers are
// zeroed and epochs start at 1, so a stale word (tag e - 2, or 0) never
// matches.  `out` is a fresh tensor, never a slot: slot e % 2 is rewritten
// by push e + 2 while the caller may still hold push e's result.
//
// Polling sleeps a fixed 32 ns between rounds (one block spins; no back-off
// that could leave a landed payload unread for microseconds), and every
// wait is bounded by the global nanosecond timer (wall time, which keeps
// running while another context holds the card), one timeout a push: on
// timeout the kernel writes an error code into a word of host-mapped
// memory, which the wrapper reads without synchronising and raises on, and
// fills `out` with NaN.  Once the word is set every later launch on the ring
// returns at once (NaN), so a lost peer costs one timeout, not one per push.
#include "common.cuh"

#include <cuda/atomic>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WORDS = 8;                // words a thread polls at once
constexpr long long CTRL_BYTES = 256;   // ack +0, epoch +64, ping +128
constexpr int ACK = 0, EPOCH = 64, PING = 128;
constexpr unsigned SLEEP_NS = 32;
constexpr unsigned NAN_BITS = 0x7fc00000u;

using SysU64 = cuda::atomic_ref<unsigned long long, cuda::thread_scope_system>;
using SysInt = cuda::atomic_ref<int, cuda::thread_scope_system>;

__host__ __device__ inline unsigned long long* ctrl_word(char* base,
                                                         long long slot_bytes,
                                                         int offset) {
  return reinterpret_cast<unsigned long long*>(base + 2 * slot_bytes +
                                               offset);
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool late(unsigned long long t0,
                                     long long timeout_ns) {
  return (long long)(now_ns() - t0) > timeout_ns;
}

// One aligned 8-byte store, and load, at system scope, relaxed: one
// transaction each, over NVLink when the address is a peer's.
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__global__ void __launch_bounds__(THREADS) ring_push(
    const float* __restrict__ src, long long rows, long long row_elems,
    long long row_stride, unsigned* __restrict__ out, char* local,
    char* right, char* left, long long slot_bytes, int* err,
    long long timeout_ns) {
  __shared__ unsigned long long s_epoch, s_t0;
  __shared__ int s_go, s_failed;
  const long long n = rows * row_elems;
  if (threadIdx.x == 0) {
    const unsigned long long e = *ctrl_word(local, slot_bytes, EPOCH) + 1;
    const unsigned long long t0 = now_ns();
    SysInt error(*err);
    int go = error.load(cuda::memory_order_relaxed) == 0;
    // slot e % 2 of the right neighbour is free once it acked e - 2
    SysU64 ack(*ctrl_word(local, slot_bytes, ACK));
    while (go && ack.load(cuda::memory_order_acquire) + 2 < e) {
      if (late(t0, timeout_ns)) {
        error.store(1, cuda::memory_order_relaxed);
        go = 0;
      } else {
        __nanosleep(SLEEP_NS);
      }
    }
    s_epoch = e;
    s_t0 = t0;
    s_go = go;
    s_failed = !go;
  }
  __syncthreads();
  const unsigned long long e = s_epoch;
  if (s_go) {
    const unsigned long long tag = (e & 0xffffffffull) << 32;
    unsigned long long* to =
        reinterpret_cast<unsigned long long*>(right + (e & 1) * slot_bytes);
    for (long long i = threadIdx.x; i < n; i += THREADS) {
      const long long r = i / row_elems;
      store_word(to + i, tag | __float_as_uint(
                                   src[r * row_stride + (i - r * row_elems)]));
    }
    const unsigned long long* slot =
        reinterpret_cast<const unsigned long long*>(local +
                                                    (e & 1) * slot_bytes);
    const unsigned long long t0 = s_t0;
    bool ok = true;
    for (long long i0 = threadIdx.x; ok && i0 < n;
         i0 += (long long)WORDS * THREADS) {
      unsigned pending = 0;
#pragma unroll
      for (int k = 0; k < WORDS; ++k)
        if (i0 + (long long)k * THREADS < n) pending |= 1u << k;
      while (pending) {
        unsigned long long w[WORDS];
#pragma unroll
        for (int k = 0; k < WORDS; ++k)
          w[k] = (pending >> k & 1) ? load_word(slot + i0 + k * THREADS) : 0;
#pragma unroll
        for (int k = 0; k < WORDS; ++k)
          if ((pending >> k & 1) && (w[k] & ~0xffffffffull) == tag) {
            out[i0 + k * THREADS] = (unsigned)w[k];
            pending &= ~(1u << k);
          }
        if (!pending) break;
        if (late(t0, timeout_ns)) {
          ok = false;
        } else {
          __nanosleep(SLEEP_NS);
        }
        if (!ok) break;
      }
    }
    if (!ok) {
      SysInt(*err).store(2, cuda::memory_order_relaxed);
      s_failed = 1;
    }
  }
  __syncthreads();                                   // every read is done
  if (s_failed) {
    for (long long i = threadIdx.x; i < n; i += THREADS)
      out[i] = NAN_BITS;                             // nothing (whole) came
  } else if (threadIdx.x == 0) {
    SysU64(*ctrl_word(left, slot_bytes, ACK))
        .store(e, cuda::memory_order_release);
  }
  if (threadIdx.x == 0) *ctrl_word(local, slot_bytes, EPOCH) = e;
}

// One thread bounces a word with the peer n times: the server stores
// base + i into the peer's word and waits for its own to read it back, the
// other waits and answers.  No sleep: the spin is the measurement.
__global__ void ring_pingpong(unsigned long long* mine,
                              unsigned long long* theirs, long long n,
                              int serve, unsigned long long base, int* done,
                              long long timeout_ns) {
  const unsigned long long t0 = now_ns();
  long long i = 0;
  for (; i < n; ++i) {
    const unsigned long long v = base + i + 1;
    if (serve) store_word(theirs, v);
    bool gone = false;
    while (!gone && load_word(mine) < v) gone = late(t0, timeout_ns);
    if (gone) break;
    if (!serve) store_word(theirs, v);
  }
  *done = (int)i;
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

// One push, one launch: src's rows (rows x row_elems fp32, row r at
// r * row_stride elements) tagged into `right` (the right neighbour's
// mapped buffer), the left neighbour's payload from `local` into `out`
// (rows * row_elems, contiguous), acknowledged into `left`.
MCAX_API int mcax_ring_push(const void* src, long long rows,
                            long long row_elems, long long row_stride,
                            void* out, void* local, void* right, void* left,
                            long long slot_bytes, void* err,
                            long long timeout_ns, void* stream) {
  ring_push<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(src), rows, row_elems, row_stride,
      static_cast<unsigned*>(out), static_cast<char*>(local),
      static_cast<char*>(right), static_cast<char*>(left), slot_bytes,
      static_cast<int*>(err), timeout_ns);
  return (int)cudaGetLastError();
}

// The link's latency floor: `n` bounces of one word between this rank's
// buffer (`local`) and a neighbour's mapped one (`remote`), both of a ring
// with slots of `slot_bytes`; `serve` starts them; `base` is the count of
// earlier bounces on these words; the bounces completed go to `done` (an
// int on the card).  For measurement only: no pipeline path launches it.
MCAX_API int mcax_ring_pingpong(void* local, void* remote,
                                long long slot_bytes, long long n, int serve,
                                unsigned long long base, void* done,
                                long long timeout_ns, void* stream) {
  ring_pingpong<<<1, 1, 0, (cudaStream_t)stream>>>(
      ctrl_word(static_cast<char*>(local), slot_bytes, PING),
      ctrl_word(static_cast<char*>(remote), slot_bytes, PING), n, serve,
      base, static_cast<int*>(done), timeout_ns);
  return (int)cudaGetLastError();
}
