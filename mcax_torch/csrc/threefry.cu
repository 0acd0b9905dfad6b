// JAX's default random numbers (threefry2x32) for the particle tracker.
//
// Replaces: jax.random (threefry2x32) in mcax/algos/particle.py — the
// split/uniform of init, the split/normal of predict and the split/uniform
// of resample.  The reference leaves these to XLA; they are no Pallas
// kernel.  On the card, the same formulas as torch elementwise operations
// would cost ~150 launches an evaluation, and the particle tracker needs two
// serial key splits a block; this file makes every draw of a dispatch in one
// launch pair.
//
// What it computes (kernels/threefry.py, bit for bit):
//   threefry2x32(k, (x0, x1)): 20 rounds, key schedule (k0, k1, k0 ^ k1 ^
//     0x1BD11BDA), rotations 13 15 26 6 / 17 29 16 24, a key injection
//     after every four rounds;
//   split(k) = (threefry2x32(k, (0, 0)), threefry2x32(k, (0, 1)));
//   draw i of key k: the XOR of the two words of threefry2x32(k, (i >> 32,
//     i & 0xFFFFFFFF));
//   uniform: f = bitcast((bits >> 9) | 0x3F800000) - 1, max(lo, fma(f,
//     hi - lo, lo));
//   normal: sqrt(2) * erf_inv(u), u uniform on [nextafter(-1, 0), 1), XLA's
//     single-precision erf_inv (each polynomial step an FMA, as XLA fuses).
// Every float operation is an explicitly rounded intrinsic and log1pf is
// the CUDA math library's, as torch's log1p on the card: bit-equal to the
// plain version (torch elementwise kernels, kernels/threefry.py).
//
// Two passes, one C entry point (mcax_particle_draws), on the caller's
// stream, no host synchronisation:
//   pass 1 (chain_kernel): one thread a key row walks its serial chain of
//     2B splits (predict's, then resample's, for each block) and writes the
//     2B sub-keys and the last key.  It is latency bound: 2B dependent
//     threefry evaluations (the two of a split are independent), ~90 integer
//     operations each.
//   pass 2 (particle_draws_kernel): one thread an output word: block b's
//     S*N normals from sub-key 2b, its S uniforms from sub-key 2b+1.  It is
//     bound by the bytes it writes (config5, B = 512: 1.05 MB, 0.31 us at
//     3.35 TB/s), and by the integer work of ~90 operations a word below
//     that.
// mcax_threefry_chain (pass 1 alone: split) and mcax_threefry_draw (one
// key row's uniforms or normals: init's, and predict and resample called
// without draws) serve the rest of kernels/threefry.py.  Keys are int64
// words holding uint32 values, as the port keeps them.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr uint32_t ONE_BITS = 0x3F800000u;
constexpr float SQRT2 = 1.41421354f;      // float32(sqrt(2))
constexpr float NORMAL_LO = -0.99999994f;  // nextafter(-1.0f, 0.0f)

template <int R>
__device__ __forceinline__ uint32_t rotl(uint32_t x) {
  return (x << R) | (x >> (32 - R));
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl<R0>(x1) ^ x0;
  x0 += x1; x1 = rotl<R1>(x1) ^ x0;
  x0 += x1; x1 = rotl<R2>(x1) ^ x0;
  x0 += x1; x1 = rotl<R3>(x1) ^ x0;
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t draw_bits(uint2 key, long long i) {
  const uint2 w = threefry2x32(key.x, key.y, (uint32_t)(i >> 32),
                               (uint32_t)i);
  return w.x ^ w.y;
}

__device__ __forceinline__ float uniform(uint32_t bits, float lo,
                                         float scale) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | ONE_BITS), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, scale, lo));
}

// XLA's ErfInv32 (the plain version's erf_inv_plain)
__device__ __forceinline__ float erf_inv(float x) {
  const float w0 = -log1pf(-__fmul_rn(x, x));
  const bool lt = w0 < 5.0f;
  const float w = lt ? __fsub_rn(w0, 2.5f) : __fsub_rn(__fsqrt_rn(w0), 3.0f);
  float p;
  if (lt) {
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.40282347e+38f) : __fmul_rn(p, x);
}

__device__ __forceinline__ float normal(uint32_t bits) {
  // hi - lo = 1 - NORMAL_LO rounds to 2 in float32
  return __fmul_rn(SQRT2, erf_inv(uniform(bits, NORMAL_LO, 2.0f)));
}

__device__ __forceinline__ uint2 load_key(const long long* k) {
  return make_uint2((uint32_t)k[0], (uint32_t)k[1]);
}

__device__ __forceinline__ void store_key(long long* k, uint2 v) {
  k[0] = (long long)v.x;
  k[1] = (long long)v.y;
}

// pass 1: keys [R, 2] -> sub-keys [R, steps, 2], last keys [R, 2]
__global__ void __launch_bounds__(THREADS) chain_kernel(
    const long long* __restrict__ keys, long long* __restrict__ subs,
    long long* __restrict__ out, int R, int steps) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  uint2 k = load_key(keys + 2LL * r);
  long long* sub = subs + 2LL * steps * r;
  for (int s = 0; s < steps; ++s) {
    const uint2 next = threefry2x32(k.x, k.y, 0u, 0u);
    store_key(sub + 2 * s, threefry2x32(k.x, k.y, 0u, 1u));
    k = next;
  }
  store_key(out + 2LL * r, k);
}

// pass 2: block rb's S*N normals (sub-key 2*rb) then S uniforms (2*rb + 1)
__global__ void __launch_bounds__(THREADS) particle_draws_kernel(
    const long long* __restrict__ subs, float* __restrict__ noise,
    float* __restrict__ u, long long total, int SN, int S) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long rb = i / (SN + S);
  const int j = (int)(i - rb * (SN + S));
  if (j < SN) {
    noise[rb * SN + j] = normal(draw_bits(load_key(subs + 4 * rb), j));
  } else {
    u[rb * S + (j - SN)] =
        uniform(draw_bits(load_key(subs + 4 * rb + 2), j - SN), 0.0f, 1.0f);
  }
}

// out[r, i] for i < n: key row r's uniforms on [lo, lo + scale) or normals
__global__ void __launch_bounds__(THREADS) draw_kernel(
    const long long* __restrict__ keys, float* __restrict__ out,
    long long total, long long n, int is_normal, float lo, float scale) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long r = i / n;
  const uint32_t bits = draw_bits(load_key(keys + 2 * r), i - r * n);
  out[i] = is_normal ? normal(bits) : uniform(bits, lo, scale);
}

}  // namespace

// keys int64 [R, 2] -> subs int64 [R, steps, 2], out int64 [R, 2]
MCAX_API int mcax_threefry_chain(const void* keys, void* subs, void* out,
                                 int R, int steps, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  chain_kernel<<<(unsigned)mcax::ceil_div(R, THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(
      static_cast<const long long*>(keys), static_cast<long long*>(subs),
      static_cast<long long*>(out), R, steps);
  return (int)cudaGetLastError();
}

// keys int64 [R, 2] -> out float32 [R, n]: uniforms on [lo, lo + scale)
// (is_normal 0; scale = hi - lo in float32) or normals (is_normal 1; lo and
// scale unused)
MCAX_API int mcax_threefry_draw(const void* keys, void* out, int R,
                                long long n, int is_normal, float lo,
                                float scale, void* stream) {
  const long long total = (long long)R * n;
  if (total == 0) return 0;
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  draw_kernel<<<(unsigned)mcax::ceil_div(total, THREADS), THREADS, 0,
                (cudaStream_t)stream>>>(
      static_cast<const long long*>(keys), static_cast<float*>(out), total, n,
      is_normal, lo, scale);
  return (int)cudaGetLastError();
}

// keys int64 [R, 2]; subs int64 [R, 2B, 2] (scratch); noise float32
// [R, B, S, N]; u float32 [R, B, S]; out int64 [R, 2] (the keys after B
// blocks): pass 1 then pass 2 on one stream
MCAX_API int mcax_particle_draws(const void* keys, void* subs, void* noise,
                                 void* u, void* out, int R, int B, int S,
                                 int N, void* stream) {
  if (R <= 0 || B <= 0 || S <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int code = mcax_threefry_chain(keys, subs, out, R, 2 * B, stream);
  if (code != 0) return code;
  const long long total = (long long)R * B * ((long long)S * N + S);
  particle_draws_kernel<<<(unsigned)mcax::ceil_div(total, THREADS), THREADS,
                          0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(subs), static_cast<float*>(noise),
      static_cast<float*>(u), total, S * N, S);
  return (int)cudaGetLastError();
}
