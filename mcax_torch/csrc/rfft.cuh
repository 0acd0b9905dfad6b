// A shared-memory real FFT of frames N = 2H points long (H a power of two,
// 16 <= H <= 2048), for the STFT from blocks (stft_fused.cu).
//
// A frame's N real samples x, windowed, are packed as H complex values
//     z[n] = w[2n] x[2n] + j w[2n+1] x[2n+1],
// transformed by an H-point complex FFT, and the real spectrum's F = H + 1
// bins follow from Z by the usual post-pass
//     X[k] = (Z[k] + conj Z[H-k]) / 2 - j e^{-2 pi j k / N} (Z[k] - conj Z[H-k]) / 2
// (Z[H] = Z[0]).  The complex FFT is Stockham's autosort form in shared
// memory: radix-8 passes, after one radix-2 or radix-4 pass when log2 H is
// not a multiple of 3:
// pass (R, Ns) reads butterfly j's R inputs at j + r H/R, multiplies input r
// by e^{-2 pi j r (j mod Ns) / (Ns R)}, and writes its outputs to
// (j / Ns) Ns R + (j mod Ns) + r Ns; after the passes Z is in natural order
// (kernels/fft.py's fft_passes gives the same schedule, and the CPU
// tests emulate it).  Every twiddle is read from a table made on the host
// in float64 and stored in fp32, e^{-2 pi j k / N} for k < N: the pass
// twiddle above is entry r (j mod Ns) N / (Ns R), the post-pass's entry k.
//
// A block holds SPAN = 2048 complex values: 2048 / H consecutive frames of
// one signal, in two padded SPAN buffers (36 KB of dynamic shared memory,
// so 6 blocks an SM) that the passes ping-pong between.  A butterfly's R
// values live in registers, 8 at most, so a 512-point FFT makes 3 trips
// through shared memory.
//
// Two kernels are built on it, and differ only in where a frame's samples
// lie: the STFT from blocks (stft_fused.cu: [B, C, L] blocks and a carry)
// and the FFT of strided frame rows (fft_rows.cu: frames cut from
// contiguous signals at any hop).  Both pack with pack4, run fft_frames
// and write with store_bins, so the same samples give the same bits.
#pragma once

#include "common.cuh"

namespace mcax {
namespace rfft {

constexpr int SPAN = 2048;
constexpr int THREADS = 256;
// One float2 of padding after every 8, so that a pass's strided stores
// (8 j + r at Ns = 1) fall in distinct banks.
constexpr int PADDED = SPAN + SPAN / 8;
constexpr int SMEM_BYTES = 2 * PADDED * (int)sizeof(float2);

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// In place: (u0, u1, u2, u3) -> their 4-point DFT.
__device__ __forceinline__ void dft4(float2& u0, float2& u1, float2& u2,
                                     float2& u3) {
  const float2 a0 = cadd(u0, u2);
  const float2 a1 = csub(u0, u2);
  const float2 a2 = cadd(u1, u3);
  const float2 a3 = make_float2(u1.y - u3.y, u3.x - u1.x);   // -j (u1 - u3)
  u0 = cadd(a0, a2);
  u1 = cadd(a1, a3);
  u2 = csub(a0, a2);
  u3 = csub(a1, a3);
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    // even and odd 4-point DFTs, then W8^k = e^{-j pi k / 4} on the odd
    constexpr float C = 0.70710678118654752f;
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4(e0, e1, e2, e3);
    dft4(o0, o1, o2, o3);
    o1 = make_float2(C * (o1.x + o1.y), C * (o1.y - o1.x));
    o2 = make_float2(o2.y, -o2.x);
    o3 = make_float2(C * (o3.y - o3.x), -C * (o3.x + o3.y));
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// One radix-R pass over every frame of the block: src -> dst, frame f at
// f * H (padded).  lh = log2 H, lns = log2 Ns, tw = the table (N = 2H
// entries).
template <int R>
__device__ __forceinline__ void stockham_pass(const float2* __restrict__ src,
                                              float2* __restrict__ dst,
                                              int lh, int lns,
                                              const float2* __restrict__ tw) {
  constexpr int LR = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int lq = lh - LR;                    // log2(H / R)
  const int tshift = lh + 1 - lns - LR;      // log2(N / (Ns R))
  const int ns_mask = (1 << lns) - 1;
  for (int bi = threadIdx.x; bi < SPAN / R; bi += THREADS) {
    const int base = (bi >> lq) << lh;
    const int j = bi & ((1 << lq) - 1);
    const int jm = j & ns_mask;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[pad(base + j + (r << lq))];
    if (lns > 0) {                           // the first pass's are 1
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], __ldg(tw + ((r * jm) << tshift)));
    }
    dft<R>(v);
    const int d = base + ((j >> lns) << (lns + LR)) + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad(d + (r << lns))] = v[r];
  }
}

// Runs the passes on buf[0:PADDED] (packed frames) with buf[PADDED:] as the
// other buffer; returns the buffer holding Z.  Ends with __syncthreads.
__device__ __forceinline__ float2* fft_frames(float2* buf, int lh,
                                              const float2* __restrict__ tw) {
  float2* src = buf;
  float2* dst = buf + PADDED;
  int lns = 0;
  if (lh % 3) {
    if (lh % 3 == 1) {
      stockham_pass<2>(src, dst, lh, 0, tw);
    } else {
      stockham_pass<4>(src, dst, lh, 0, tw);
    }
    float2* t = src; src = dst; dst = t;
    lns = lh % 3;
    __syncthreads();
  }
  for (; lns < lh; lns += 3) {
    stockham_pass<8>(src, dst, lh, lns, tw);
    float2* t = src; src = dst; dst = t;
    __syncthreads();
  }
  return src;
}

// Bin k of the real spectrum of the frame at `base` in z (H complex values
// in natural order, padded).
__device__ __forceinline__ float2 real_bin(const float2* z, int base, int k,
                                           int lh,
                                           const float2* __restrict__ tw) {
  const int hm = (1 << lh) - 1;
  const float2 a = z[pad(base + (k & hm))];
  const float2 b = z[pad(base + (((1 << lh) - k) & hm))];
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 od = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
  const float2 t = __ldg(tw + k);
  return make_float2(e.x + (t.x * od.x - t.y * od.y),
                     e.y + (t.x * od.y + t.y * od.x));
}

// Four windowed samples x * w (p' = e*2 .. e*2+3 of a frame, p' % 4 == 0)
// as the two packed values z[e], z[e+1].
__device__ __forceinline__ void pack4(float2* buf, int e, float4 w,
                                      float4 x) {
  buf[pad(e)] = make_float2(w.x * x.x, w.y * x.y);
  buf[pad(e + 1)] = make_float2(w.z * x.z, w.w * x.w);
}

// The real spectra of the block's first nf frames (z from fft_frames), F =
// H + 1 bins each, to out [nf, F] contiguous: one flat loop over the nf*F
// bins, so consecutive threads make coalesced 8-byte stores.
__device__ __forceinline__ void store_bins(const float2* z,
                                           float2* __restrict__ out, int nf,
                                           int lh,
                                           const float2* __restrict__ tw) {
  const int F = (1 << lh) + 1;
  for (int idx = threadIdx.x; idx < nf * F; idx += THREADS) {
    const int f = idx / F;
    const int k = idx - f * F;
    out[idx] = real_bin(z, f << lh, k, lh, tw);
  }
}

}  // namespace rfft
}  // namespace mcax
