// The in-kernel transpose probes for Hopper (sm_90a), bf16:
//   transpose:  o[b] = x[b]^T,      x [B, P, C] -> o [B, C, P];
//   rhsT:       o[b] = M . x[b]^T,  x [B, P, 64], M [64, 64] -> o [B, 64, P];
//   lhsT:       o[b] = x[b]^T . M,  x [B, 64, P], M [64, 64] -> o [B, P, 64];
// the products accumulate in f32 and round once to bf16.  With M = I (what
// the probe feeds) rhsT and lhsT are transposes, exactly.
//
// Replaces:
//   benchmarks/exp_io_transpose.py
//     kernel_rhsT (pallas_call at :73)   -> rhsT
//     kernel_lhsT (pallas_call at :95)   -> lhsT
//     kernel_jnpT (pallas_call at :116)  -> transpose
//
// Bound: all three move bytes, not operations.  At the probe's B=128,
// P=128*128, C=64 each reads and writes 268 MB (0.160 ms at 3.35 TB/s);
// rhsT and lhsT add 2*64 operations an output element (17 GFLOP), which the
// tensor cores do in a tenth of that time, but the FP32 pipes would not.
// Design: the TPU kernels took a whole [P, C] image into VMEM per grid step
// and turned it with the matrix unit; here a thread block stages one tile
// in shared memory with 16-byte (products) or 4-byte (transpose) coalesced
// loads and writes it back turned:
//   transpose: a 64x64 tile, rows padded by one element so that the column
//     reads of the write phase hit 32 distinct banks; each lane moves a
//     bf16 pair on both sides, so a warp reads and writes 128-byte rows;
//   rhsT, lhsT: 128 pixels by all 64 channels, M beside it; WMMA fragments
//     read the staged tile in the layout it has (x^T is x read column-major,
//     so no turn is made before the product) and the tensor cores accumulate
//     in f32; each warp rounds its 16x16 results through a 1 KB scratch and
//     writes 32-byte rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- transpose
constexpr int kT = 64;
constexpr int kTPad = 1;

// grid = (ceil(P / 64), ceil(C / 64), B); block = (32, 8).  P and C even.
__global__ void __launch_bounds__(256)
transpose_kernel(const bf16* __restrict__ x, int P, int C, bf16* __restrict__ o) {
  __shared__ bf16 tile[kT][kT + kTPad];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p0 = blockIdx.x * kT, c0 = blockIdx.y * kT;
  const long long base = (long long)blockIdx.z * P * C;
  for (int r = ty; r < kT; r += 8) {
    const int p = p0 + r, c = c0 + 2 * tx;
    if (p < P && c < C) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + base + (long long)p * C + c);
      tile[r][2 * tx] = v.x;
      tile[r][2 * tx + 1] = v.y;
    }
  }
  __syncthreads();
  for (int r = ty; r < kT; r += 8) {
    const int c = c0 + r, p = p0 + 2 * tx;
    if (c < C && p < P) {
      __nv_bfloat162 v;
      v.x = tile[2 * tx][r];
      v.y = tile[2 * tx + 1][r];
      *reinterpret_cast<__nv_bfloat162*>(o + base + (long long)c * P + p) = v;
    }
  }
}

// --------------------------------------------------------- rhsT and lhsT
constexpr int kK = 64;    // contraction (the channels C)
constexpr int kCo = 64;   // M's other side
constexpr int kPT = 128;  // pixels per block
constexpr int kLdM = kCo + 8;

// Round a warp's 16x16 f32 fragment to bf16 and store it at ``dst`` (row
// stride ``ld`` elements): each lane writes 8 values, 16 bytes.
__device__ __forceinline__ void store_bf16(float* scratch,
                                           const wmma::fragment<wmma::accumulator, 16, 16, 16, float>& f,
                                           bf16* dst, long long ld, int lane) {
  wmma::store_matrix_sync(scratch, f, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, c8 = (lane % 2) * 8;
  alignas(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(scratch[r * 16 + c8 + e]);
  *reinterpret_cast<uint4*>(dst + r * ld + c8) = *reinterpret_cast<const uint4*>(v);
  __syncwarp();
}

__device__ __forceinline__ void load_m(const bf16* __restrict__ m, bf16* ms, int tid) {
  for (int c = tid; c < kK * (kCo / 8); c += 256) {
    const int r = c / (kCo / 8), q = c % (kCo / 8);
    *reinterpret_cast<uint4*>(ms + r * kLdM + q * 8) =
        *reinterpret_cast<const uint4*>(m + r * kCo + q * 8);
  }
}

// grid = (P / 128, 1, B); block = 256.  o[b][i][p] = sum_k M[i][k] x[b][p][k].
__global__ void __launch_bounds__(256)
rhsT_kernel(const bf16* __restrict__ x, const bf16* __restrict__ m, int P, bf16* __restrict__ o) {
  constexpr int kLdX = kK + 8;  // x tile [kPT pixels][kK channels + pad]
  __shared__ __align__(128) bf16 xs[kPT * kLdX];
  __shared__ __align__(128) bf16 ms[kK * kLdM];
  __shared__ __align__(128) float scratch[8][256];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long img = blockIdx.z;
  const int p0 = blockIdx.x * kPT;
  const bf16* xb = x + (img * P + p0) * kK;
  for (int c = tid; c < kPT * (kK / 8); c += 256) {
    const int r = c / (kK / 8), q = c % (kK / 8);
    *reinterpret_cast<uint4*>(xs + r * kLdX + q * 8) =
        *reinterpret_cast<const uint4*>(xb + (long long)r * kK + q * 8);
  }
  load_m(m, ms, tid);
  __syncthreads();

  // warp: output rows i0 .. i0 + 16 of M's 64, pixels j0 .. j0 + 64 of the tile
  const int i0 = (warp / 2) * 16, j0 = (warp % 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, ms + i0 * kLdM + kk, kLdM);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // x^T [k][p] is the staged [p][k] tile read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, xs + (j0 + j * 16) * kLdX + kk, kLdX);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
  bf16* ob = o + (img * kCo + i0) * P + p0 + j0;
#pragma unroll
  for (int j = 0; j < 4; ++j) store_bf16(scratch[warp], acc[j], ob + j * 16, P, lane);
}

// grid = (P / 128, 1, B); block = 256.  o[b][p][j] = sum_k x[b][k][p] M[k][j].
__global__ void __launch_bounds__(256)
lhsT_kernel(const bf16* __restrict__ x, const bf16* __restrict__ m, int P, bf16* __restrict__ o) {
  constexpr int kLdX = kPT + 8;  // x tile [kK channels][kPT pixels + pad]
  __shared__ __align__(128) bf16 xs[kK * kLdX];
  __shared__ __align__(128) bf16 ms[kK * kLdM];
  __shared__ __align__(128) float scratch[8][256];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long img = blockIdx.z;
  const int p0 = blockIdx.x * kPT;
  const bf16* xb = x + img * kK * P + p0;
  for (int c = tid; c < kK * (kPT / 8); c += 256) {
    const int r = c / (kPT / 8), q = c % (kPT / 8);
    *reinterpret_cast<uint4*>(xs + r * kLdX + q * 8) =
        *reinterpret_cast<const uint4*>(xb + (long long)r * P + q * 8);
  }
  load_m(m, ms, tid);
  __syncthreads();

  // warp: pixels w*16 .. +16 of the tile, all 64 outputs
  const int r0 = warp * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kK; kk += 16) {
    // x^T [p][k] is the staged [k][p] tile read column-major
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
    wmma::load_matrix_sync(fa, xs + kk * kLdX + r0, kLdX);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, ms + kk * kLdM + j * 16, kLdM);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
  bf16* ob = o + (img * P + p0 + r0) * kCo;
#pragma unroll
  for (int j = 0; j < 4; ++j) store_bf16(scratch[warp], acc[j], ob + j * 16, kCo, lane);
}

}  // namespace

extern "C" {

// x [batch, p, c] bf16 -> out [batch, c, p]; p and c even.
int mdie_probe_transpose(const void* x, int batch, int p, int c, void* out, void* stream) {
  if (batch <= 0 || p <= 0 || c <= 0 || p % 2 || c % 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p + kT - 1) / kT, (c + kT - 1) / kT, batch);
  transpose_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), p, c, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [batch, p, 64], m [64, 64] bf16 -> out [batch, 64, p]; p a multiple of 128.
int mdie_probe_rhsT(const void* x, const void* m, int batch, int p, void* out, void* stream) {
  if (batch <= 0 || p <= 0 || p % kPT) return static_cast<int>(cudaErrorInvalidValue);
  rhsT_kernel<<<dim3(p / kPT, 1, batch), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(m), p, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [batch, 64, p], m [64, 64] bf16 -> out [batch, p, 64]; p a multiple of 128.
int mdie_probe_lhsT(const void* x, const void* m, int batch, int p, void* out, void* stream) {
  if (batch <= 0 || p <= 0 || p % kPT) return static_cast<int>(cudaErrorInvalidValue);
  lhsT_kernel<<<dim3(p / kPT, 1, batch), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(m), p, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
