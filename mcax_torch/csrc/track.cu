// The trackers' scan over blocks: config5's EMA tracker (track_scan) and
// particle smoother (particle_scan), each one launch a call.
//
// Replaces: the jax.lax.scan of mcax/pipeline.py:331-338 over
// mcax/algos/tracking.py:150 (track_block) and of mcax/pipeline.py:321-329
// over mcax/algos/tracking.py:101 (particle_track_block).  The reference
// leaves the scan to XLA inside its one compiled program; it is no Pallas
// kernel.  In PyTorch the same recursion is a loop of a few dozen tiny
// launches a block (~58 for the EMA tracker, ~45 for the particle filter).
//
// One CTA a stream (a row of R).
//
// track_scan, for each chunk of up to CHUNK blocks:
//   a. the S peaks of every surface of the chunk, a warp a surface
//      (surface_peaks: an argmax over G with the lowest index winning a
//      tie, the value read out, the +-sup circular neighbourhood set to
//      -FLT_MAX; S times), staged in shared memory;
//   b. the greedy peak -> track association and the EMA update over the
//      chunk's blocks in order, on one thread (S = 2: a few dozen scalar
//      operations a block);
//   c. the nearest grid point of every [block, source] angle, a warp each.
//
// particle_scan: S cloud warps and PRODUCERS producer warps, which hand
// each block over through a ring of D slots in shared memory (D = min(B,
// the slots the card's shared memory holds beside the clouds); a full and
// an empty mbarrier a slot, wgmma.cuh's).  The greedy association gives
// each block's S peaks one to one to the S clouds, so a cloud's
// rival-masked surface (every other peak's neighbourhood at the surface's
// floor, amin(power)) depends on the clouds only through which peak is its
// own: S variants a block, known before the recursion reaches it.
//   producers (warp p: blocks p, p + PRODUCERS, ...): the surface into the
//      slot, its floor, its S peaks (surface_peaks' argmax), a byte a bin
//      of the peaks within sup of it, and for each peak k den = the
//      population std of variant k (double, each lane's bins in order,
//      then warp_sum's tree: the order the clouds used when each masked
//      its own surface, so the same bits) + eps;
//   clouds (a warp a source cloud, its N particles in the warp's registers,
//      PPL a lane, its angles and cumulative weights in shared memory), a
//      block: the slot's wait; one named barrier over the cloud warps (the
//      previous block's estimates); the association of the slot's peaks to
//      the estimates (own peak); predict with the noise each lane copied
//      into shared memory a block ahead (cp.async); update (the gather at
//      round((wrap(a) - a0) / da) clamped, at the floor where the bin's
//      byte names a peak but not its own, minus the max, expf over the own
//      variant's den, normalise); the slot's release; ESS, systematic
//      resample (inclusive cumsum, searchsorted left, clamped to N - 1)
//      where ESS / N < threshold, and the estimate that gives doa and
//      confidence;
//   and the producers, between fills and after the last, the nearest grid
//      point of every [block, source] doa the clouds have published (the
//      count of blocks done, stored with release after each block's
//      barrier), a warp each.
// ring_waits counts a stream's blocks at which a cloud warp found its slot
// not yet full (the producers behind).
//
// Numerics.  track_scan is bit-equal to its plain version (torch
// elementwise kernels, kernels/track.py) on the card: every float
// operation is an explicitly rounded intrinsic (no FMA contraction), the
// constants are the float32 roundings of the plain version's Python
// scalars (passed in), the floored remainder is fmodf then + b where the
// signs differ (torch.remainder), the integer bin distance uses a floored
// modulo, and argmax / argmin take torch's order (NaN first, then the
// lowest index).  particle_scan's sums cannot follow torch's reduction
// order; they are taken in double in one fixed order that depends on N
// only (a lane's PPL particles in order, then a shfl_down tree over the
// lanes; the std of a surface over G likewise), never on B or R, so B
// blocks in one call equal B calls of one block bit for bit.  The plain
// version's cumsum and std accumulate in float64 too (torch's CPU kernels
// do so for float32 already), so they agree up to the float sums' last
// bits.
//
// Bound.  Bytes: config5 at B = 512 reads 0.74 MB of surfaces (both
// kernels) and 1.05 MB of noise (particle_scan): well under a
// microsecond at 3.35 TB/s.  The design floor is the serial chain over B
// blocks: track_scan's association's wraps; particle_scan's cloud warps'
// recursion alone (five warp-wide reductions of five shuffle rounds each,
// the named barrier, the resample's searches), the producers' work off it
// while they keep ahead (ring_waits near 0).  chip_smoke.py prints both
// floors beside the measured time.
#include <cfloat>
#include <climits>
#include <cmath>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = mcax::wg;

constexpr int WARP = 32;
// MAX_SOURCES, WARP * 32 particles and particle_smem are restated in
// kernels/track.py, whose wrappers check them
constexpr int MAX_SOURCES = 8;     // tracks / clouds a stream
constexpr int CHUNK = 512;         // blocks whose peaks are staged at once
constexpr int TRACK_THREADS = 512;
constexpr int PRODUCERS = 2;       // particle_scan's producer warps
constexpr int PARTICLE_THREADS = (MAX_SOURCES + PRODUCERS) * WARP;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct TrackConsts {     // float32 roundings of the plain version's scalars
  float pi, two_pi;      // math.pi, 2 math.pi (also an unset track's distance)
  float keep;            // 1 - smooth
  float cs, cs1;         // conf_smooth 0.8, 1 - 0.8
};

struct ParticleConsts {
  float pi, two_pi;
  float step;            // step_std_rad
  float thr;             // resample_threshold
  float eps;             // 1e-12
  float inv_n;           // 1.0f / N (torch scales by a scalar's reciprocal)
  float w_reset;         // float32(1.0 / N)
};

// fmodf's general path, out of line: it is long, and rarely taken
__device__ __noinline__ float fmod_general(float a, float b) {
  return fmodf(a, b);
}

// torch.remainder on floats: fmod, then + b where the signs differ.  fmod
// is exact: a itself for |a| < |b|, and a -+ |b| (exact by Sterbenz's
// lemma, the sign a's) for |b| <= |a| < 2|b|, every wrap's case here; only
// other arguments take fmodf's general loop.
__device__ __forceinline__ float floor_mod(float a, float b) {
  const float aa = fabsf(a), ab = fabsf(b);
  float m;
  if (aa < ab)
    m = a;
  else if (aa < 2.0f * ab)
    m = copysignf(__fsub_rn(aa, ab), a);
  else
    m = fmod_general(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

// remainder(a + pi, 2 pi) - pi: (-pi, pi]
__device__ __forceinline__ float wrap(float a, float pi, float two_pi) {
  return __fsub_rn(floor_mod(__fadd_rn(a, pi), two_pi), pi);
}

// |remainder(o - k + g // 2, g) - g // 2| for grid indices o, k in
// [0, g): the argument lies in [-g, 2g), where the floored remainder is one
// conditional add or subtract
__device__ __forceinline__ int bin_dist(int o, int k, int g) {
  int t = o - k + g / 2;
  if (t >= g)
    t -= g;
  else if (t < 0)
    t += g;
  return abs(t - g / 2);
}

// torch.argmax's order: (a, ia) before (b, ib)
__device__ __forceinline__ bool max_first(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a > b;
}

// torch.argmin's order
__device__ __forceinline__ bool min_first(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a < b;
}

// (value, index) of the whole warp under an order; INT_MAX marks none.
// The order is total, so the result does not depend on the tree.
template <bool MAX>
__device__ __forceinline__ void warp_arg(float& v, int& i) {
#pragma unroll
  for (int off = WARP / 2; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (oi != INT_MAX &&
        (i == INT_MAX || (MAX ? max_first(ov, oi, v, i)
                              : min_first(ov, oi, v, i)))) {
      v = ov;
      i = oi;
    }
  }
}

// A sum in a fixed order: a shfl_down tree over the lanes, lane 0's total
// broadcast to the warp.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = WARP / 2; off; off >>= 1)
    v += __shfl_down_sync(FULL, v, off);
  return __shfl_sync(FULL, v, 0);
}

// torch.amin / amax: NaN propagates, otherwise exact
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = WARP / 2; off; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    if (isnan(o) || o < v) v = o;
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = WARP / 2; off; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    if (isnan(o) || o > v) v = o;
  }
  return v;
}

// The s peaks of one surface p[g], strongest first, on one warp (every
// lane returns them): extract_peaks of kernels/track.py.
__device__ void surface_peaks(const float* __restrict__ p, int g, int s,
                              int sup, int* idx, float* val) {
  const int lane = threadIdx.x & (WARP - 1);
  for (int k = 0; k < s; ++k) {
    float best = 0.0f;
    int bi = INT_MAX;
#pragma unroll 4
    for (int o = lane; o < g; o += WARP) {
      float v = __ldg(p + o);
      for (int j = 0; j < k; ++j)
        if (bin_dist(o, idx[j], g) <= sup) v = -FLT_MAX;
      if (bi == INT_MAX || max_first(v, o, best, bi)) {
        best = v;
        bi = o;
      }
    }
    warp_arg<true>(best, bi);
    idx[k] = bi;
    val[k] = best;
  }
}

// argmin over the grid of |wrap(a - az)|, on one warp
__device__ int nearest_grid(float a, const float* __restrict__ az, int g,
                            float pi, float two_pi) {
  const int lane = threadIdx.x & (WARP - 1);
  float best = 0.0f;
  int bi = INT_MAX;
#pragma unroll 4
  for (int o = lane; o < g; o += WARP) {
    const float d = fabsf(wrap(__fsub_rn(a, __ldg(az + o)), pi, two_pi));
    if (bi == INT_MAX || min_first(d, o, best, bi)) {
      best = d;
      bi = o;
    }
  }
  warp_arg<false>(best, bi);
  return bi;
}

// Phase a for one chunk: the peaks of surfaces [b0, b0 + nb), a warp a
// surface, into shared memory ([nb, s] each): their angles az[idx] and
// their values.
__device__ void chunk_peaks(const float* __restrict__ power,
                            const float* __restrict__ az, int b0, int nb,
                            int s, int g, int sup, float* s_pa,
                            float* s_val) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
  const int nwarps = blockDim.x / WARP;
  for (int i = warp; i < nb; i += nwarps) {
    int idx[MAX_SOURCES];
    float val[MAX_SOURCES];
    surface_peaks(power + (size_t)(b0 + i) * g, g, s, sup, idx, val);
    if (lane == 0) {
      for (int k = 0; k < s; ++k) {
        s_pa[i * s + k] = __ldg(az + idx[k]);
        s_val[i * s + k] = val[k];
      }
    }
  }
}

// Phase c for one chunk: grid[q] = nearest grid point of ang[q], q < n
__device__ void chunk_grid(const float* ang, long long* grid, int n,
                           const float* __restrict__ az, int g, float pi,
                           float two_pi) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
  const int nwarps = blockDim.x / WARP;
  for (int q = warp; q < n; q += nwarps) {
    const int gi = nearest_grid(ang[q], az, g, pi, two_pi);
    if (lane == 0) grid[q] = gi;
  }
}

// ---------------------------------------------------------------------------
// track_scan: state [R, S] (angles, confidence, initialised), surfaces
// [R, B, G] -> new state, grid [R, B, S] int64, angles and confidence
// after each block [R, B, S].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TRACK_THREADS)
track_scan_kernel(const float* __restrict__ ang0,
                  const float* __restrict__ conf0,
                  const unsigned char* __restrict__ init0,
                  const float* __restrict__ power,
                  const float* __restrict__ az, float* ang1, float* conf1,
                  unsigned char* init1, long long* grid, float* ang_b,
                  float* conf_b, int B, int S, int G, int sup,
                  TrackConsts c) {
  __shared__ float s_pa[CHUNK * MAX_SOURCES];
  __shared__ float s_val[CHUNK * MAX_SOURCES];
  const int r = blockIdx.x;
  const float* pr = power + (size_t)r * B * G;
  float ang[MAX_SOURCES], conf[MAX_SOURCES];
  bool inited[MAX_SOURCES];
  if (threadIdx.x == 0) {
    for (int j = 0; j < S; ++j) {
      ang[j] = ang0[(size_t)r * S + j];
      conf[j] = conf0[(size_t)r * S + j];
      inited[j] = init0[(size_t)r * S + j] != 0;
    }
  }
  for (int b0 = 0; b0 < B; b0 += CHUNK) {
    const int nb = min(CHUNK, B - b0);
    chunk_peaks(pr, az, b0, nb, S, G, sup, s_pa, s_val);
    __syncthreads();
    float* ab = ang_b + ((size_t)r * B + b0) * S;
    float* cb = conf_b + ((size_t)r * B + b0) * S;
    if (threadIdx.x == 0) {
      for (int i = 0; i < nb; ++i) {
        bool claimed[MAX_SOURCES];
        for (int t = 0; t < S; ++t) claimed[t] = false;
        for (int k = 0; k < S; ++k) {
          const float pa = s_pa[i * S + k];
          const float pv = s_val[i * S + k];
          int j = -1;
          float dj = 0.0f;
          for (int t = 0; t < S; ++t) {
            float d = inited[t]
                          ? fabsf(wrap(__fsub_rn(ang[t], pa), c.pi, c.two_pi))
                          : c.two_pi;
            if (claimed[t]) d = INFINITY;
            if (j < 0 || min_first(d, t, dj, j)) {
              j = t;
              dj = d;
            }
          }
          float na = pa;
          if (inited[j]) {
            const float err = wrap(__fsub_rn(pa, ang[j]), c.pi, c.two_pi);
            na = wrap(__fadd_rn(ang[j], __fmul_rn(c.keep, err)), c.pi,
                      c.two_pi);
          }
          ang[j] = na;
          conf[j] = __fadd_rn(__fmul_rn(c.cs, conf[j]), __fmul_rn(c.cs1, pv));
          inited[j] = true;
          claimed[j] = true;
        }
        for (int t = 0; t < S; ++t) {
          ab[i * S + t] = ang[t];
          cb[i * S + t] = conf[t];
        }
      }
    }
    __syncthreads();   // thread 0's angles (global) and s_pa reads done
    chunk_grid(ab, grid + ((size_t)r * B + b0) * S, nb * S, az, G, c.pi,
               c.two_pi);
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < S; ++j) {
      ang1[(size_t)r * S + j] = ang[j];
      conf1[(size_t)r * S + j] = conf[j];
      init1[(size_t)r * S + j] = inited[j] ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// particle_scan: clouds [R, S, N] (angles, weights), surfaces [R, B, G],
// noise [R, B, S, N], u [R, B, S] -> new clouds, grid [R, B, S] int64, doa
// and confidence [R, B, S].  Warp s < S owns cloud s; lane l its particles
// l * PPL + i, i < PPL (those >= N are padding: weight 0, never read).
// Warps S .. S + PRODUCERS - 1 fill the ring of D slots ahead of them.
// ---------------------------------------------------------------------------

// A ring slot, in 32-bit words: the block's S peaks (grid index, angle),
// den of each own-peak variant of the masked surface, the surface's floor,
// the surface [G], then a byte a bin whose bit t is set where the bin lies
// within sup bins of peak t (bin_dist)
__host__ __device__ constexpr size_t slot_words(int S, int G) {
  return 3 * (size_t)S + 1 + G + (G + 3) / 4;
}

// The rival mask: a bin near some peak but not near its cloud's own (bit
// own) lies at the floor
__device__ __forceinline__ float rival_floored(float v, unsigned near,
                                               int own, float floor_v) {
  return near && !((near >> own) & 1u) ? floor_v : v;
}

// A producer warp's block: the surface p[G] into the slot, its floor, its S
// peaks (surface_peaks' argmax, each earlier peak's neighbourhood at
// -FLT_MAX read from the near bytes) with their neighbourhoods, and for
// each peak k the den of the surface as the cloud that owns peak k sees it
// (every other peak's neighbourhood at the floor; its population std in
// double, each lane's bins in order, then warp_sum's tree: the order the
// cloud warps used when each masked its own, so the same bits).
__device__ void fill_slot(const float* __restrict__ p,
                          const float* __restrict__ az, float* slot, int S,
                          int G, int sup, float eps) {
  const int lane = threadIdx.x & (WARP - 1);
  float* surf = slot + 3 * S + 1;
  unsigned char* near = (unsigned char*)(surf + G);
  float lo = INFINITY;
#pragma unroll 4
  for (int o = lane; o < G; o += WARP) {
    const float v = __ldg(p + o);
    surf[o] = v;
    near[o] = 0;
    if (isnan(v) || v < lo) lo = v;
  }
  const float floor_v = warp_min(lo);
  __syncwarp();
  int pk[MAX_SOURCES];
#pragma unroll
  for (int k = 0; k < MAX_SOURCES; ++k) {
    if (k < S) {
      float best = 0.0f;
      int bi = INT_MAX;
#pragma unroll 4
      for (int o = lane; o < G; o += WARP) {
        const float v = near[o] ? -FLT_MAX : surf[o];
        if (bi == INT_MAX || max_first(v, o, best, bi)) {
          best = v;
          bi = o;
        }
      }
      warp_arg<true>(best, bi);
      pk[k] = bi;
      // the bins within sup of it: bi + d, |d| <= sup, circularly
      for (int d = lane - sup; d <= sup; d += WARP)
        near[((bi + d) % G + G) % G] |= 1u << k;
      __syncwarp();
    }
  }
  double sum[MAX_SOURCES], m2[MAX_SOURCES];
#pragma unroll
  for (int k = 0; k < MAX_SOURCES; ++k) sum[k] = m2[k] = 0.0;
  for (int o = lane; o < G; o += WARP) {
    const float v = surf[o];
    const unsigned nb = near[o];
#pragma unroll
    for (int k = 0; k < MAX_SOURCES; ++k)
      if (k < S) sum[k] += (double)rival_floored(v, nb, k, floor_v);
  }
  double mean[MAX_SOURCES];
#pragma unroll
  for (int k = 0; k < MAX_SOURCES; ++k)
    if (k < S) mean[k] = warp_sum(sum[k]) / (double)G;
  for (int o = lane; o < G; o += WARP) {
    const float v = surf[o];
    const unsigned nb = near[o];
#pragma unroll
    for (int k = 0; k < MAX_SOURCES; ++k) {
      if (k < S) {
        const double d = (double)rival_floored(v, nb, k, floor_v) - mean[k];
        m2[k] += d * d;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_SOURCES; ++k) {
    if (k < S) {
      const float scale = (float)sqrt(warp_sum(m2[k]) / (double)G);
      float den = __fadd_rn(scale, eps);
      if (den < eps) den = eps;          // clamp_min: NaN stays NaN
      if (lane == 0) {
        ((int*)slot)[k] = pk[k];
        slot[S + k] = __ldg(az + pk[k]);
        slot[2 * S + k] = den;
      }
    }
  }
  if (lane == 0) slot[3 * S] = floor_v;
}

// The cloud warps' barrier (named barrier 1, S warps), which also tells
// each whether any of them had `pred`
__device__ __forceinline__ bool clouds_sync_any(bool pred, int threads) {
  int any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 q, %1, 0;\n"
      "bar.red.or.pred p, 1, %2, q;\nselp.s32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"((int)pred), "r"(threads)
      : "memory");
  return any != 0;
}

// The count of blocks whose doas the cloud warps have published, and its
// read by the producer warps (release / acquire within the CTA)
__device__ __forceinline__ void publish(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;\n" ::"r"(
                   mcax::smem_addr(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ int published(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];\n"
               : "=r"(v)
               : "r"(mcax::smem_addr(p))
               : "memory");
  return __reduce_min_sync(FULL, v);   // what every lane has acquired
}

// The weighted circular mean and resultant length of a cloud (estimate)
template <int PPL>
__device__ __forceinline__ void cloud_estimate(const float* ra,
                                               const float* rw, int lane,
                                               int n, float& doa,
                                               float& conf) {
  double cs = 0.0, sn = 0.0;
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    if (lane * PPL + i < n) {
      cs += (double)__fmul_rn(rw[i], cosf(ra[i]));
      sn += (double)__fmul_rn(rw[i], sinf(ra[i]));
    }
  }
  const float c = (float)warp_sum(cs), s = (float)warp_sum(sn);
  doa = atan2f(s, c);
  conf = sqrtf(__fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s)));
}

template <int PPL>
__global__ void __launch_bounds__(PARTICLE_THREADS)
particle_scan_kernel(const float* __restrict__ ang0,
                     const float* __restrict__ w0,
                     const float* __restrict__ power,
                     const float* __restrict__ az,
                     const float* __restrict__ noise,
                     const float* __restrict__ u, float* ang1, float* w1,
                     long long* grid, float* doa_b, float* conf_b,
                     int* ring_waits, int B, int S, int N, int G, int sup,
                     int D, ParticleConsts c) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = (uint64_t*)smem;               // [D] a slot filled
  uint64_t* empty = full + D;                     // [D] a slot read
  int* s_pub = (int*)(empty + D);                 // blocks published
  float* s_ang = (float*)(s_pub + 1);             // [S, N]
  float* s_cum = s_ang + (size_t)S * N;           // [S, N]
  float* s_nz = s_cum + (size_t)S * N;            // [S, N] a block's noise
  float* s_u = s_nz + (size_t)S * N;              // [S] and u
  float* ring = s_u + S;                          // [D, slot_words]
  __shared__ float s_est[2][MAX_SOURCES];         // by block parity
  const int r = blockIdx.x;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
  const int s = warp;
  const size_t words = slot_words(S, G);
  const float* pr = power + (size_t)r * B * G;
  if (threadIdx.x == 0) {
    for (int k = 0; k < D; ++k) {
      wg::mbar_init(full + k, 1);
      wg::mbar_init(empty + k, S);
    }
    wg::mbar_init_fence();
    *s_pub = 0;
  }
  __syncthreads();
  if (warp >= S) {
    // producer p fills blocks p, p + np, ...; np <= D, so its wait on a
    // slot's release is never two phases behind.  Between fills, and after
    // the last, it writes the nearest grid point of the doas the clouds
    // have published: [block, source] q = p, p + PRODUCERS, ...
    const int np = min(PRODUCERS, D), p = warp - S;
    const float* dr = doa_b + (size_t)r * B * S;
    long long* gr = grid + (size_t)r * B * S;
    int q = p;
    auto grid_to = [&](int done) {
      for (; q < done; q += PRODUCERS) {
        const int gi = nearest_grid(dr[q], az, G, c.pi, c.two_pi);
        if (lane == 0) gr[q] = gi;
      }
    };
    for (int b = p; p < np && b < B; b += np) {
      const int k = b % D;
      if (b >= D)
        while (!wg::mbar_try_wait(empty + k, (uint32_t)(b / D - 1) & 1u)) {
        }
      fill_slot(pr + (size_t)b * G, az, ring + k * words, S, G, sup, c.eps);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(full + k);
      grid_to(published(s_pub) * S);
    }
    while (q < B * S) {
      const int done = published(s_pub) * S;
      if (done <= q) {
        __nanosleep(100);
        continue;
      }
      grid_to(done);
    }
  } else {
    float ra[PPL], rw[PPL];
    const size_t base = ((size_t)r * S + s) * N;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int n = lane * PPL + i;
      ra[i] = n < N ? ang0[base + n] : 0.0f;
      rw[i] = n < N ? w0[base + n] : 0.0f;
    }
    // a block's draws into shared memory, a lane its own particles', one
    // block ahead: they do not depend on the recursion
    const float* nzr = noise + (size_t)r * B * S * N + (size_t)s * N;
    const float* ur = u + (size_t)r * B * S + s;
    float* nzs = s_nz + (size_t)s * N;
    auto draws = [&](int b) {
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        const int n = lane * PPL + i;
        if (n < N) mcax::cp_async4(nzs + n, nzr + (size_t)b * S * N + n, 4);
      }
      if (lane == 0) mcax::cp_async4(s_u + s, ur + (size_t)b * S, 4);
      mcax::cp_async_commit();
    };
    draws(0);
    {
      float doa, conf;
      cloud_estimate<PPL>(ra, rw, lane, N, doa, conf);
      if (lane == 0) s_est[0][s] = doa;
    }
    const float a0 = __ldg(az), da = __fsub_rn(__ldg(az + 1), __ldg(az));
    int waits = 0, k = 0;
    uint32_t phase = 0;
    for (int b = 0; b < B; ++b) {
      const float* slot = ring + k * words;
      const bool waited = !wg::mbar_try_wait(full + k, phase);
      if (waited)
        while (!wg::mbar_try_wait(full + k, phase)) {
        }
      // the previous block's estimates (its doas published); whether any
      // cloud found the slot not yet full
      waits += clouds_sync_any(waited, S * WARP);
      if (threadIdx.x == 0) publish(s_pub, b);
      // greedy peak -> cloud association on the clouds' estimates: own
      // is this cloud's peak
      const float* est = s_est[b & 1];
      bool claimed[MAX_SOURCES];
      for (int t = 0; t < S; ++t) claimed[t] = false;
      int own = 0;
      for (int q = 0; q < S; ++q) {
        const float pa = slot[S + q];
        int j = -1;
        float dj = 0.0f;
        for (int t = 0; t < S; ++t) {
          float d = fabsf(wrap(__fsub_rn(est[t], pa), c.pi, c.two_pi));
          if (claimed[t]) d = INFINITY;
          if (j < 0 || min_first(d, t, dj, j)) {
            j = t;
            dj = d;
          }
        }
        if (j == s) own = q;
        claimed[j] = true;
      }
      const float den = slot[2 * S + own], floor_v = slot[3 * S];
      const float* surf = slot + 3 * S + 1;
      const unsigned char* near = (const unsigned char*)(surf + G);
      mcax::cp_async_wait<0>();
      __syncwarp();
      const float ub = s_u[s];
      // predict, then the surface at each particle's grid bin, every
      // rival peak's neighbourhood at the floor
      float pv[PPL];
      float pmax = -INFINITY;
#pragma unroll
      for (int i2 = 0; i2 < PPL; ++i2) {
        const int n = lane * PPL + i2;
        if (n < N) {
          const float a = wrap(__fadd_rn(ra[i2], __fmul_rn(c.step, nzs[n])),
                               c.pi, c.two_pi);
          ra[i2] = a;
          const float q = __fdiv_rn(
              __fsub_rn(wrap(a, c.pi, c.two_pi), a0), da);
          long long gl = (long long)rintf(q);
          const int gi = (int)(gl < 0 ? 0 : (gl > G - 1 ? G - 1 : gl));
          pv[i2] = rival_floored(surf[gi], near[gi], own, floor_v);
          if (isnan(pv[i2]) || pv[i2] > pmax) pmax = pv[i2];
        }
      }
      pmax = warp_max(pmax);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty + k);   // the slot is read
      if (++k == D) {
        k = 0;
        phase ^= 1u;
      }
      if (b + 1 < B) draws(b + 1);
      // reweight and normalise
      double sw = 0.0;
#pragma unroll
      for (int i2 = 0; i2 < PPL; ++i2) {
        if (lane * PPL + i2 < N) {
          const float like = expf(__fdiv_rn(__fsub_rn(pv[i2], pmax), den));
          pv[i2] = __fmul_rn(rw[i2], like);      // pv now the weights
          sw += (double)pv[i2];
        } else {
          pv[i2] = 0.0f;
        }
      }
      const float total = (float)warp_sum(sw);
      double sq = 0.0;
#pragma unroll
      for (int i2 = 0; i2 < PPL; ++i2) {
        if (lane * PPL + i2 < N) {
          pv[i2] = __fdiv_rn(pv[i2], total);
          sq += (double)__fmul_rn(pv[i2], pv[i2]);
        }
      }
      const float ess = __fdiv_rn(1.0f, (float)warp_sum(sq));
      if (__fmul_rn(ess, c.inv_n) < c.thr) {
        // systematic resample: cumsum (double, rounded), searchsorted left
        float* ca = s_ang + (size_t)s * N;
        float* cc = s_cum + (size_t)s * N;
        double run = 0.0;
        double pre[PPL];
#pragma unroll
        for (int i2 = 0; i2 < PPL; ++i2) {
          run += (double)pv[i2];
          pre[i2] = run;
        }
        double incl = run;
#pragma unroll
        for (int off = 1; off < WARP; off <<= 1) {
          const double o = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += o;
        }
        double excl = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) excl = 0.0;
#pragma unroll
        for (int i2 = 0; i2 < PPL; ++i2) {
          const int n = lane * PPL + i2;
          if (n < N) {
            ca[n] = ra[i2];
            cc[n] = (float)(excl + pre[i2]);
          }
        }
        __syncwarp();
        const float u0 = __fmul_rn(ub, c.inv_n);
        int top = 1;
        while (2 * top <= N) top *= 2;
        float picked[PPL];
#pragma unroll
        for (int i2 = 0; i2 < PPL; ++i2) {
          const int n = lane * PPL + i2;
          picked[i2] = 0.0f;
          if (n < N) {
            const float pos = __fadd_rn(u0, __fmul_rn((float)n, c.inv_n));
            // searchsorted left: the count of cumsum entries below pos,
            // in a fixed number of steps (the PPL searches interleave)
            int lo2 = 0;
            for (int step = top; step; step >>= 1)
              if (lo2 + step <= N && cc[lo2 + step - 1] < pos) lo2 += step;
            picked[i2] = ca[lo2 < N ? lo2 : N - 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int i2 = 0; i2 < PPL; ++i2) {
          ra[i2] = picked[i2];
          rw[i2] = lane * PPL + i2 < N ? c.w_reset : 0.0f;
        }
      } else {
#pragma unroll
        for (int i2 = 0; i2 < PPL; ++i2) rw[i2] = pv[i2];
      }
      float doa, conf;
      cloud_estimate<PPL>(ra, rw, lane, N, doa, conf);
      if (lane == 0) {
        doa_b[((size_t)r * B + b) * S + s] = doa;
        conf_b[((size_t)r * B + b) * S + s] = conf;
        s_est[(b + 1) & 1][s] = doa;
      }
    }
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int n = lane * PPL + i;
      if (n < N) {
        ang1[base + n] = ra[i];
        w1[base + n] = rw[i];
      }
    }
    clouds_sync_any(false, S * WARP);   // the last block's doas
    if (threadIdx.x == 0) {
      publish(s_pub, B);
      ring_waits[r] = waits;
    }
  }
}

// particle_scan's dynamic shared memory: a full and an empty barrier a
// slot, the count of blocks published, angles, cumsum and a block's noise
// [S, N] and u [S], the ring of D slots
size_t particle_smem(int S, int N, int G, int D) {
  return 2 * sizeof(uint64_t) * D + sizeof(int) +
         sizeof(float) * (3 * (size_t)S * N + S + D * slot_words(S, G));
}

// The ring's depth: as many slots as the card's shared memory a block
// leaves beside the clouds, at most B; 0 where not one fits
int particle_depth(int B, int S, int N, int G) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const long long avail = (long long)optin -
                          (long long)sizeof(float) * 2 * MAX_SOURCES -
                          (long long)particle_smem(S, N, G, 0);
  const long long per = (long long)particle_smem(S, N, G, 1) -
                        (long long)particle_smem(S, N, G, 0);
  return avail < per ? 0 : (int)(avail / per < B ? avail / per : B);
}

template <int PPL>
int launch_particle(const float* ang0, const float* w0, const float* power,
                    const float* az, const float* noise, const float* u,
                    float* ang1, float* w1, long long* grid, float* doa_b,
                    float* conf_b, int* ring_waits, int R, int B, int S,
                    int N, int G, int sup, int D, ParticleConsts c,
                    cudaStream_t stream) {
  const size_t smem = particle_smem(S, N, G, D);
  cudaError_t e = cudaFuncSetAttribute(
      particle_scan_kernel<PPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  particle_scan_kernel<PPL><<<R, (S + PRODUCERS) * WARP, smem, stream>>>(
      ang0, w0, power, az, noise, u, ang1, w1, grid, doa_b, conf_b,
      ring_waits, B, S, N, G, sup, D, c);
  return (int)cudaGetLastError();
}

}  // namespace

// angles, confidence float32 [R, S], initialised bool [R, S], surfaces
// float32 [R, B, G], azimuths float32 [G] -> the new state (same layouts),
// grid int64 [R, B, S], angles and confidence after each block float32
// [R, B, S]
MCAX_API int mcax_track_scan(const void* ang0, const void* conf0,
                             const void* init0, const void* power,
                             const void* az, void* ang1, void* conf1,
                             void* init1, void* grid, void* ang_b,
                             void* conf_b, int R, int B, int S, int G,
                             int sup, float pi, float two_pi, float keep,
                             float cs, float cs1, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || B <= 0 || S <= 0 || S > MAX_SOURCES || G <= 0)
    return (int)cudaErrorInvalidValue;
  const TrackConsts c{pi, two_pi, keep, cs, cs1};
  track_scan_kernel<<<R, TRACK_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(ang0), static_cast<const float*>(conf0),
      static_cast<const unsigned char*>(init0),
      static_cast<const float*>(power), static_cast<const float*>(az),
      static_cast<float*>(ang1), static_cast<float*>(conf1),
      static_cast<unsigned char*>(init1), static_cast<long long*>(grid),
      static_cast<float*>(ang_b), static_cast<float*>(conf_b), B, S, G, sup,
      c);
  return (int)cudaGetLastError();
}

// angles, weights float32 [R, S, N], surfaces float32 [R, B, G], azimuths
// float32 [G] (uniform, G >= 2), noise float32 [R, B, S, N], u float32
// [R, B, S] -> new angles and weights, grid int64 [R, B, S], doa and
// confidence float32 [R, B, S], and int32 [R] the blocks at which the
// cloud warps found their ring slot not yet filled (ring_waits)
MCAX_API int mcax_particle_scan(const void* ang0, const void* w0,
                                const void* power, const void* az,
                                const void* noise, const void* u, void* ang1,
                                void* w1, void* grid, void* doa_b,
                                void* conf_b, void* ring_waits, int R, int B,
                                int S, int N, int G, int sup, float pi,
                                float two_pi, float step, float thr,
                                float eps, float inv_n, float w_reset,
                                void* stream) {
  if (R == 0) return 0;
  if (R < 0 || B <= 0 || S <= 0 || S > MAX_SOURCES || N <= 0 ||
      N > WARP * 32 || G < 2)
    return (int)cudaErrorInvalidValue;
  const int D = particle_depth(B, S, N, G);
  if (D < 1) return (int)cudaErrorInvalidValue;
  const ParticleConsts c{pi, two_pi, step, thr, eps, inv_n, w_reset};
  const auto* a0 = static_cast<const float*>(ang0);
  const auto* wt = static_cast<const float*>(w0);
  const auto* pw = static_cast<const float*>(power);
  const auto* azp = static_cast<const float*>(az);
  const auto* nz = static_cast<const float*>(noise);
  const auto* up = static_cast<const float*>(u);
  auto* a1 = static_cast<float*>(ang1);
  auto* w1p = static_cast<float*>(w1);
  auto* gp = static_cast<long long*>(grid);
  auto* db = static_cast<float*>(doa_b);
  auto* cb = static_cast<float*>(conf_b);
  auto* rw = static_cast<int*>(ring_waits);
  const cudaStream_t st = (cudaStream_t)stream;
#define MCAX_PARTICLE(P)                                                  \
  return launch_particle<P>(a0, wt, pw, azp, nz, up, a1, w1p, gp, db, cb, \
                            rw, R, B, S, N, G, sup, D, c, st)
  if (N <= WARP) MCAX_PARTICLE(1);
  if (N <= 2 * WARP) MCAX_PARTICLE(2);
  if (N <= 4 * WARP) MCAX_PARTICLE(4);
  if (N <= 8 * WARP) MCAX_PARTICLE(8);
  if (N <= 16 * WARP) MCAX_PARTICLE(16);
  MCAX_PARTICLE(32);
#undef MCAX_PARTICLE
}
