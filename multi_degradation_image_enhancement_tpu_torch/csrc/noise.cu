// Fused Gaussian-noise degrade for Hopper (sm_90a).
//
// Replaces: multi_degradation_image_enhancement_tpu/ops/pallas/noise.py
//           _noise_kernel (pallas_call at :125, entries noise_degrade_01 :99
//           and degrade_noise_batch_fast :139).
//
// Computes, per image b with per-image sigma std[b]:
//     out = floor(clip(x + std[b] * n, 0, 255)) * scale      (f32 or bf16 out)
// with n ~ N(0, 1) from Box-Muller on counter-based random bits.  Both
// Box-Muller outputs are used: pair p of an image of N elements writes
// r*cos(theta) to element p and r*sin(theta) to element p + N/2, the flat
// form of the TPU kernel's top-half / bottom-half row split.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11), key = (seed, image
// index), counter = (q, 0, 0, 0).  Counter q feeds pairs 2q (words x, y) and
// 2q+1 (words z, w).  The stream is a pure function of (seed, image, pair), so
// it is deterministic and does not depend on the launch shape.  The TPU's
// hardware bits cannot be reproduced; mdie_philox_bits writes the raw words
// from the same device function so the plain PyTorch version
// (ops/cuda/noise.py: bits_to_noise01) can be fed the kernel's own bits.
//
// Bound: device-memory bandwidth.  Per element it reads 4 bytes and writes
// 2 (bf16) or 4 bytes; Philox costs ~10 integer multiply rounds per 4 words
// and Box-Muller one logf + sincosf per 2 elements, far below the H100's
// integer and FP32 rates at 3.35 TB/s.  The design keeps it one pass: bits
// never touch memory, each thread handles 4 elements from one Philox call.
//
// Accuracy: logf / sincosf / sqrtf are the accurate (non fast-math) versions
// and the final x + std*n uses __fmul_rn / __fadd_rn so the compiler cannot
// contract it into an FMA: a 1-ulp change moves a floor to the next u8 level.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, ctr.x);
    const uint32_t lo0 = kPhiloxM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, ctr.z);
    const uint32_t lo1 = kPhiloxM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// Top 23 bits as the mantissa of a float in [1, 2), minus 1: uniform [0, 1).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ void degrade_pair(const float* x, T* out, long long p, long long half,
                                             uint32_t bits1, uint32_t bits2, float std,
                                             float scale) {
  const float u1 = 1.0f - bits_to_uniform(bits1);  // (0, 1]: safe for log
  const float u2 = bits_to_uniform(bits2);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(kTwoPi * u2, &s, &c);
  const float n0 = __fmul_rn(r, c);
  const float n1 = __fmul_rn(r, s);
  const float v0 = __fadd_rn(x[p], __fmul_rn(std, n0));
  const float v1 = __fadd_rn(x[p + half], __fmul_rn(std, n1));
  store(out + p, floorf(fminf(fmaxf(v0, 0.0f), 255.0f)) * scale);
  store(out + p + half, floorf(fminf(fmaxf(v1, 0.0f), 255.0f)) * scale);
}

// grid = (ceil(n_ctr / kThreads), batch); n_ctr = ceil(half / 2).
template <typename T>
__global__ void noise_degrade_kernel(const float* __restrict__ x, const float* __restrict__ std,
                                     T* __restrict__ out, long long n, uint32_t seed,
                                     float scale) {
  const int b = blockIdx.y;
  const long long half = n / 2;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long p0 = 2 * q;
  if (p0 >= half) return;
  const uint4 r = philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), 0u, 0u), seed,
                                (uint32_t)b);
  const float sd = std[b];
  const float* xb = x + (long long)b * n;
  T* ob = out + (long long)b * n;
  degrade_pair(xb, ob, p0, half, r.x, r.y, sd, scale);
  if (p0 + 1 < half) degrade_pair(xb, ob, p0 + 1, half, r.z, r.w, sd, scale);
}

// The raw words the degrade kernel consumes: bits1/bits2 [batch, n_pairs].
__global__ void philox_bits_kernel(uint32_t* __restrict__ bits1, uint32_t* __restrict__ bits2,
                                   long long n_pairs, uint32_t seed) {
  const int b = blockIdx.y;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long p0 = 2 * q;
  if (p0 >= n_pairs) return;
  const uint4 r = philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), 0u, 0u), seed,
                                (uint32_t)b);
  const long long base = (long long)b * n_pairs;
  bits1[base + p0] = r.x;
  bits2[base + p0] = r.y;
  if (p0 + 1 < n_pairs) {
    bits1[base + p0 + 1] = r.z;
    bits2[base + p0 + 1] = r.w;
  }
}

dim3 pair_grid(long long n_pairs, int batch) {
  const long long n_ctr = (n_pairs + 1) / 2;
  return dim3((unsigned)((n_ctr + kThreads - 1) / kThreads), (unsigned)batch);
}

}  // namespace

extern "C" {

// x: f32 [batch, n] (n even, 0..255); std: f32 [batch]; out: [batch, n] f32 or bf16.
int mdie_noise_degrade(const void* x, const void* std, void* out, int out_bf16, int batch,
                       long long n, uint32_t seed, float scale, void* stream) {
  const dim3 grid = pair_grid(n / 2, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    noise_degrade_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(std),
        static_cast<__nv_bfloat16*>(out), n, seed, scale);
  } else {
    noise_degrade_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(std),
        static_cast<float*>(out), n, seed, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits1, bits2: 32-bit [batch, n_pairs].
int mdie_philox_bits(void* bits1, void* bits2, int batch, long long n_pairs, uint32_t seed,
                     void* stream) {
  philox_bits_kernel<<<pair_grid(n_pairs, batch), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(bits1), static_cast<uint32_t*>(bits2), n_pairs, seed);
  return static_cast<int>(cudaGetLastError());
}

const char* mdie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
