// The growth-layer forward of the trainable growth layer (growth_train.cu,
// its only user; the inference DenseBlock has its own tensor-core kernels in
// dense_block.cu):
//
//   g = conv3x3_{ci -> G}(bf16(relu(a*f + b))) + bias       (SAME padding)
//
// The affine and ReLU run in f32 on the feature value and are rounded to bf16
// (the bf16 matmul operand of the TPU kernels); weights are bf16; products
// accumulate in f32; the output is written as TOut.  SAME padding applies to
// the ACTIVATED value: taps outside the image contribute 0, not relu(b).
//
// Bound: 2*9*ci*G FLOPs per pixel at only G = 16 outputs, so the layer is
// compute-bound on the FP32 pipes in this simple form (a tensor-core implicit
// GEMM is later work).  Design: one thread block per 16x32 pixel tile, image
// and group of 16 outputs; the (tile+2)^2 halo patch of a chunk of 8 input
// channels is loaded once into shared memory with the affine + ReLU + bf16
// rounding applied at load, and the chunk's weights are staged beside it;
// each thread keeps 2 pixels x 16 outputs in f32 registers, reading each
// weight once per 32 FMAs (broadcast float4 shared loads).  Feature bytes are
// read ~once per layer from L2/HBM.
//
// Templated on the feature type and the output type (training instantiates
// f32 for both), and given a source and a destination NCHW buffer with their
// channel counts (training reads x and writes a separate g).  Source and
// destination may alias (disjoint channels).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mdie {
namespace {  // internal linkage: each translation unit gets its own copy

constexpr int kTileW = 32;          // pixels per tile row (one warp)
constexpr int kTileH = 16;          // tile rows; each thread takes rows ty, ty + 8
constexpr int kRowsPerThread = 2;
constexpr int kThreadsY = kTileH / kRowsPerThread;
constexpr int kChunk = 8;           // input channels staged per pass
constexpr int kOutGroup = 16;       // outputs per thread block (growth 16 = 1 group)
constexpr int kPatchH = kTileH + 2;
constexpr int kPatchW = kTileW + 2;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// relu(f*a + b) rounded to bf16, with the product and the sum rounded apart
// (no FMA contraction), as the plain version computes them: the mask v > 0 of
// the backward then agrees with it element for element.
__device__ __forceinline__ float activate(float f, float a, float b) {
  return bf16_round(fmaxf(__fadd_rn(__fmul_rn(f, a), b), 0.0f));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid = (ceil(W / 32), ceil(H / 16), B * n_og); block = (32, 8).
// src: [B, c_src, H, W], of which channels [0, ci) are read.
// dst: [B, c_dst, H, W], of which channels [c_off, c_off + G) are written.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kTileW * kThreadsY)
growth_layer_kernel(const TIn* src, int c_src, TOut* dst, int c_dst, int c_off, int H, int W,
                    int ci, const float* __restrict__ a, const float* __restrict__ b,
                    const __nv_bfloat16* __restrict__ wgt,  // [G, ci, 3, 3]
                    const float* __restrict__ bias, int G, int n_og) {
  __shared__ float patch[kChunk][kPatchH][kPatchW];
  __shared__ __align__(16) float wsm[kChunk][9][kOutGroup];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int og = blockIdx.z % n_og;
  const int img = blockIdx.z / n_og;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)H * W;
  const TIn* in = src + (long long)img * c_src * plane;

  float acc[kRowsPerThread][kOutGroup];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int o = 0; o < kOutGroup; ++o) acc[r][o] = 0.0f;

  for (int c0 = 0; c0 < ci; c0 += kChunk) {
    // Halo patch of activated values; zero outside the image (SAME padding
    // of the activated value) and past the last channel.
    for (int idx = tid; idx < kChunk * kPatchH * kPatchW; idx += kTileW * kThreadsY) {
      const int c = idx / (kPatchH * kPatchW);
      const int rem = idx - c * (kPatchH * kPatchW);
      const int py = rem / kPatchW, px = rem - py * kPatchW;
      const int gy = y0 + py - 1, gx = x0 + px - 1, cc = c0 + c;
      float v = 0.0f;
      if (cc < ci && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float f = to_float(in[cc * plane + (long long)gy * W + gx]);
        v = activate(f, a[cc], b[cc]);
      }
      patch[c][py][px] = v;
    }
    for (int idx = tid; idx < kChunk * 9 * kOutGroup; idx += kTileW * kThreadsY) {
      const int c = idx / (9 * kOutGroup);
      const int rem = idx - c * (9 * kOutGroup);
      const int t = rem / kOutGroup, o = rem - t * kOutGroup;
      const int cc = c0 + c, oo = og * kOutGroup + o;
      wsm[c][t][o] = (cc < ci && oo < G)
                         ? __bfloat162float(wgt[((long long)oo * ci + cc) * 9 + t])
                         : 0.0f;
    }
    __syncthreads();

    const int n_c = min(kChunk, ci - c0);
    for (int c = 0; c < n_c; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) v[r] = patch[c][ty + r * kThreadsY + ky][tx + kx];
          const float4* w4 = reinterpret_cast<const float4*>(&wsm[c][ky * 3 + kx][0]);
#pragma unroll
          for (int j = 0; j < kOutGroup / 4; ++j) {
            const float4 w = w4[j];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
              acc[r][4 * j + 0] += v[r] * w.x;
              acc[r][4 * j + 1] += v[r] * w.y;
              acc[r][4 * j + 2] += v[r] * w.z;
              acc[r][4 * j + 3] += v[r] * w.w;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  TOut* out = dst + ((long long)img * c_dst + c_off) * plane;
  const int x = x0 + tx;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int y = y0 + ty + r * kThreadsY;
    if (x >= W || y >= H) continue;
#pragma unroll
    for (int o = 0; o < kOutGroup; ++o) {
      const int oo = og * kOutGroup + o;
      if (oo < G) store(out + oo * plane + (long long)y * W + x, acc[r][o] + bias[oo]);
    }
  }
}

// Launch the growth layer: n_og = ceil(G / 16) output groups per image.
template <typename TIn, typename TOut>
cudaError_t launch_growth_layer(const TIn* src, int c_src, TOut* dst, int c_dst, int c_off,
                                int batch, int H, int W, int ci, const float* a, const float* b,
                                const __nv_bfloat16* wgt, const float* bias, int G,
                                cudaStream_t s) {
  const int n_og = (G + kOutGroup - 1) / kOutGroup;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, batch * n_og);
  growth_layer_kernel<TIn, TOut><<<grid, dim3(kTileW, kThreadsY), 0, s>>>(
      src, c_src, dst, c_dst, c_off, H, W, ci, a, b, wgt, bias, G, n_og);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdie
