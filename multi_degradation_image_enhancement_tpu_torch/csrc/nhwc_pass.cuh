// The NCHW -> NHWC bf16 pass shared by the tensor-core kernels that read
// channels innermost (conv_cm.cu's conv3x3, dense_block.cu's entry pass):
// x [B, C, H*W] (bf16 or f32) is rounded to bf16 (the bf16 operand of the
// TPU kernels) into y [B, H*W, ld], channels [0, C) from x and [C, Ct) zero;
// channels [Ct, ld) of y are not written.  A block transposes a tile of 32
// channels x 32 pixels through shared memory, so both sides are coalesced.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_operand(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float bf16_operand(__nv_bfloat16 v) { return __bfloat162float(v); }

namespace nhwc {
constexpr int kTile = 32, kTileRows = 8;
}  // namespace nhwc

// grid = (ceil(HW/32), ceil(Ct/32), B); block = (32, 8).
template <typename T>
__global__ void __launch_bounds__(nhwc::kTile * nhwc::kTileRows)
nchw_to_nhwc_kernel(const T* __restrict__ x, int C, int HW, int Ct, int ld,
                    __nv_bfloat16* __restrict__ y) {
  using namespace nhwc;
  __shared__ __nv_bfloat16 tile[kTile][kTile + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const long long img = blockIdx.z;
#pragma unroll
  for (int j = 0; j < kTile; j += kTileRows) {
    const int c = c0 + ty + j, p = p0 + tx;
    float v = 0.0f;
    if (c < C && p < HW) v = bf16_operand(x[(img * C + c) * HW + p]);
    tile[ty + j][tx] = __float2bfloat16(v);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTile; j += kTileRows) {
    const int p = p0 + ty + j, c = c0 + tx;
    if (p < HW && c < Ct) y[(img * HW + p) * ld + c] = tile[tx][ty + j];
  }
}

// Launch the pass: x_f32 selects the input type.
inline cudaError_t launch_nchw_to_nhwc(const void* x, int x_f32, int batch, int C, int HW, int Ct,
                                       int ld, __nv_bfloat16* y, cudaStream_t s) {
  using namespace nhwc;
  const dim3 grid((HW + kTile - 1) / kTile, (Ct + kTile - 1) / kTile, batch);
  const dim3 block(kTile, kTileRows);
  if (x_f32)
    nchw_to_nhwc_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), C, HW, Ct, ld, y);
  else
    nchw_to_nhwc_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), C, HW, Ct, ld, y);
  return cudaGetLastError();
}

}  // namespace
