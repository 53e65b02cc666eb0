// CDAN's single 3x3 convolutions for Hopper (sm_90a): the conv + folded-BN
// bias (+ ReLU), and conv1's conv + bias + ReLU + 2x2 max-pool in one pass.
//
// Replaces:
//   multi_degradation_image_enhancement_tpu/ops/pallas/conv_cm.py
//     _kernel (pallas_call at :187, entry conv3x3_cm :141)          -> conv3x3
//   multi_degradation_image_enhancement_tpu/ops/pallas/conv_pool_cm.py
//     _kernel (pallas_call at :248, entry conv3x3_pool_cm :208)     -> conv3x3_pool
//
// The math of the TPU kernels, not their layout.  The channel-major [C, H*W]
// lanes, the column-polyphase operand (deinterleave_cols), the 3->8 input
// channel pad, the c_out padding to 16 and the c_out split all answer the
// TPU's lane width and VMEM bound; here both kernels read and write plain
// NCHW, c_out unpadded.
//
// Rounding points (conv_cm.py:44,91-95,108-111; conv_pool_cm.py:91,161,
// 171,181-182): the input and the BN-folded weights are bf16 operands, the
// products accumulate in f32, the f32 bias is added in f32, then the ReLU
// (optional for conv3x3), then (conv3x3_pool) the 2x2 max in f32, and one
// rounding to the output type (the input's) at the end.  SAME padding: taps
// outside the image read 0.
//
// Bound: 2*9*c_in*c_out FLOPs per output pixel against ~2*(c_in + c_out)
// bytes, so both are compute-bound; in this simple form they run on the FP32
// pipes (tensor cores, TMA and wgmma are later work).  Design: one thread
// block per pixel tile, image and group of OG output channels; the tile's
// input halo patch of a chunk of input channels is staged in shared memory,
// rounded to bf16 at load, beside the chunk's weights; every thread keeps
// its pixels x OG outputs in f32 registers and reads each weight as a
// broadcast float4, so each shared-memory load feeds 8 (conv3x3) or 16
// (conv3x3_pool) FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_operand(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float bf16_operand(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------------------ conv3x3
constexpr int kTileW = 32;   // pixels per tile row (one warp)
constexpr int kTileH = 16;   // tile rows; thread row ty takes rows ty and ty + 8
constexpr int kRows = 2;
constexpr int kThreadsY = kTileH / kRows;
constexpr int kChunk = 8;    // input channels staged per pass
constexpr int kPatchH = kTileH + 2;
constexpr int kPatchW = kTileW + 2;

// grid = (ceil(W / 32), ceil(H / 16), B * n_og); block = (32, 8).
// x: [B, c_in, H, W]; w: bf16 [c_out, c_in, 3, 3]; bias: f32 [c_out];
// out: [B, c_out, H, W], the type of x.
template <int OG, typename T>
__global__ void __launch_bounds__(kTileW * kThreadsY)
conv3x3_kernel(const T* __restrict__ x, int c_in, int H, int W,
               const __nv_bfloat16* __restrict__ wgt, const float* __restrict__ bias,
               int c_out, int n_og, int relu, T* __restrict__ out) {
  __shared__ float patch[kChunk][kPatchH][kPatchW];
  __shared__ __align__(16) float wsm[kChunk][9][OG];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int og = blockIdx.z % n_og;
  const int img = blockIdx.z / n_og;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)H * W;
  const T* in = x + (long long)img * c_in * plane;

  float acc[kRows][OG];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int o = 0; o < OG; ++o) acc[r][o] = 0.0f;

  for (int c0 = 0; c0 < c_in; c0 += kChunk) {
    for (int idx = tid; idx < kChunk * kPatchH * kPatchW; idx += kTileW * kThreadsY) {
      const int c = idx / (kPatchH * kPatchW);
      const int rem = idx - c * (kPatchH * kPatchW);
      const int py = rem / kPatchW, px = rem - py * kPatchW;
      const int gy = y0 + py - 1, gx = x0 + px - 1, cc = c0 + c;
      float v = 0.0f;
      if (cc < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = bf16_operand(in[cc * plane + (long long)gy * W + gx]);
      }
      patch[c][py][px] = v;
    }
    for (int idx = tid; idx < kChunk * 9 * OG; idx += kTileW * kThreadsY) {
      const int c = idx / (9 * OG);
      const int rem = idx - c * (9 * OG);
      const int t = rem / OG, o = rem - t * OG;
      const int cc = c0 + c, oo = og * OG + o;
      wsm[c][t][o] = (cc < c_in && oo < c_out)
                         ? __bfloat162float(wgt[((long long)oo * c_in + cc) * 9 + t])
                         : 0.0f;
    }
    __syncthreads();

    const int n_c = min(kChunk, c_in - c0);
    for (int c = 0; c < n_c; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] = patch[c][ty + r * kThreadsY + ky][tx + kx];
          const float4* w4 = reinterpret_cast<const float4*>(&wsm[c][ky * 3 + kx][0]);
#pragma unroll
          for (int j = 0; j < OG / 4; ++j) {
            const float4 w = w4[j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
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

  T* dst = out + (long long)img * c_out * plane;
  const int xx = x0 + tx;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int yy = y0 + ty + r * kThreadsY;
    if (xx >= W || yy >= H) continue;
#pragma unroll
    for (int o = 0; o < OG; ++o) {
      const int oo = og * OG + o;
      if (oo >= c_out) continue;
      float v = acc[r][o] + bias[oo];
      if (relu) v = fmaxf(v, 0.0f);
      store(dst + oo * plane + (long long)yy * W + xx, v);
    }
  }
}

template <int OG, typename T>
cudaError_t launch_conv3x3(const T* x, int batch, int c_in, int h, int w,
                           const __nv_bfloat16* wgt, const float* bias, int c_out, int relu,
                           T* out, cudaStream_t s) {
  const int n_og = (c_out + OG - 1) / OG;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch * n_og);
  conv3x3_kernel<OG, T><<<grid, dim3(kTileW, kThreadsY), 0, s>>>(
      x, c_in, h, w, wgt, bias, c_out, n_og, relu, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_conv3x3(const T* x, int batch, int c_in, int h, int w,
                             const __nv_bfloat16* wgt, const float* bias, int c_out, int relu,
                             T* out, cudaStream_t s) {
  // de4 (c_out 3) would leave 29/32 of a 32-wide group idle.
  if (c_out <= 4) return launch_conv3x3<4, T>(x, batch, c_in, h, w, wgt, bias, c_out, relu, out, s);
  return launch_conv3x3<32, T>(x, batch, c_in, h, w, wgt, bias, c_out, relu, out, s);
}

// ------------------------------------------------------------- conv3x3_pool
constexpr int kPoolW = 32;   // pooled columns per tile (one warp)
constexpr int kPoolH = 8;    // pooled rows per tile (one per thread row)
constexpr int kPoolChunk = 4;
constexpr int kPoolOG = 16;
constexpr int kPoolPatchH = 2 * kPoolH + 2;
constexpr int kPoolPatchW = 2 * kPoolW + 2;

// grid = (ceil(W/2 / 32), ceil(H/2 / 8), B * n_og); block = (32, 8).  A
// thread owns one pooled pixel, i.e. its 2x2 window of conv outputs, for 16
// output channels.  H and W are even, so every window lies in the image.
template <typename T>
__global__ void __launch_bounds__(kPoolW * kPoolH)
conv3x3_pool_kernel(const T* __restrict__ x, int c_in, int H, int W,
                    const __nv_bfloat16* __restrict__ wgt, const float* __restrict__ bias,
                    int c_out, int n_og, T* __restrict__ out) {
  __shared__ float patch[kPoolChunk][kPoolPatchH][kPoolPatchW];
  __shared__ __align__(16) float wsm[kPoolChunk][9][kPoolOG];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kPoolW + tx;
  const int og = blockIdx.z % n_og;
  const int img = blockIdx.z / n_og;
  const int Hp = H / 2, Wp = W / 2;
  const int cx0 = 2 * blockIdx.x * kPoolW, cy0 = 2 * blockIdx.y * kPoolH;  // conv-tile origin
  const long long plane = (long long)H * W;
  const T* in = x + (long long)img * c_in * plane;

  float acc[4][kPoolOG];  // window position (dy, dx) -> 2 * dy + dx
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int o = 0; o < kPoolOG; ++o) acc[p][o] = 0.0f;

  for (int c0 = 0; c0 < c_in; c0 += kPoolChunk) {
    for (int idx = tid; idx < kPoolChunk * kPoolPatchH * kPoolPatchW; idx += kPoolW * kPoolH) {
      const int c = idx / (kPoolPatchH * kPoolPatchW);
      const int rem = idx - c * (kPoolPatchH * kPoolPatchW);
      const int py = rem / kPoolPatchW, px = rem - py * kPoolPatchW;
      const int gy = cy0 + py - 1, gx = cx0 + px - 1, cc = c0 + c;
      float v = 0.0f;
      if (cc < c_in && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = bf16_operand(in[cc * plane + (long long)gy * W + gx]);
      }
      patch[c][py][px] = v;
    }
    for (int idx = tid; idx < kPoolChunk * 9 * kPoolOG; idx += kPoolW * kPoolH) {
      const int c = idx / (9 * kPoolOG);
      const int rem = idx - c * (9 * kPoolOG);
      const int t = rem / kPoolOG, o = rem - t * kPoolOG;
      const int cc = c0 + c, oo = og * kPoolOG + o;
      wsm[c][t][o] = (cc < c_in && oo < c_out)
                         ? __bfloat162float(wgt[((long long)oo * c_in + cc) * 9 + t])
                         : 0.0f;
    }
    __syncthreads();

    const int n_c = min(kPoolChunk, c_in - c0);
    for (int c = 0; c < n_c; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[p] = patch[c][2 * ty + (p >> 1) + ky][2 * tx + (p & 1) + kx];
          }
          const float4* w4 = reinterpret_cast<const float4*>(&wsm[c][ky * 3 + kx][0]);
#pragma unroll
          for (int j = 0; j < kPoolOG / 4; ++j) {
            const float4 w = w4[j];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              acc[p][4 * j + 0] += v[p] * w.x;
              acc[p][4 * j + 1] += v[p] * w.y;
              acc[p][4 * j + 2] += v[p] * w.z;
              acc[p][4 * j + 3] += v[p] * w.w;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int pxo = blockIdx.x * kPoolW + tx, pyo = blockIdx.y * kPoolH + ty;
  if (pxo >= Wp || pyo >= Hp) return;
  const long long pplane = (long long)Hp * Wp;
  T* dst = out + (long long)img * c_out * pplane + (long long)pyo * Wp + pxo;
#pragma unroll
  for (int o = 0; o < kPoolOG; ++o) {
    const int oo = og * kPoolOG + o;
    if (oo >= c_out) continue;
    const float b = bias[oo];
    float m = fmaxf(acc[0][o] + b, 0.0f);
#pragma unroll
    for (int p = 1; p < 4; ++p) m = fmaxf(m, fmaxf(acc[p][o] + b, 0.0f));
    store(dst + oo * pplane, m);
  }
}

template <typename T>
cudaError_t launch_conv3x3_pool(const T* x, int batch, int c_in, int h, int w,
                                const __nv_bfloat16* wgt, const float* bias, int c_out, T* out,
                                cudaStream_t s) {
  const int n_og = (c_out + kPoolOG - 1) / kPoolOG;
  const dim3 grid((w / 2 + kPoolW - 1) / kPoolW, (h / 2 + kPoolH - 1) / kPoolH, batch * n_og);
  conv3x3_pool_kernel<T><<<grid, dim3(kPoolW, kPoolH), 0, s>>>(
      x, c_in, h, w, wgt, bias, c_out, n_og, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: NCHW, bf16 if x_bf16 else f32; x [batch, c_in, h, w], out
// [batch, c_out, h, w].  wgt: bf16 [c_out, c_in, 3, 3]; bias: f32 [c_out].
int mdie_conv3x3(const void* x, int x_bf16, int batch, int c_in, int h, int w, const void* wgt,
                 const void* bias, int c_out, int relu, void* out, void* stream) {
  const auto* wb = static_cast<const __nv_bfloat16*>(wgt);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return static_cast<int>(dispatch_conv3x3<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), batch, c_in, h, w, wb, bi, c_out, relu,
        static_cast<__nv_bfloat16*>(out), s));
  }
  return static_cast<int>(dispatch_conv3x3<float>(static_cast<const float*>(x), batch, c_in, h,
                                                  w, wb, bi, c_out, relu,
                                                  static_cast<float*>(out), s));
}

// x: NCHW [batch, c_in, h, w] (h, w even), bf16 if x_bf16 else f32;
// out: [batch, c_out, h/2, w/2] of x's type.  wgt, bias as for mdie_conv3x3.
int mdie_conv3x3_pool(const void* x, int x_bf16, int batch, int c_in, int h, int w,
                      const void* wgt, const void* bias, int c_out, void* out, void* stream) {
  const auto* wb = static_cast<const __nv_bfloat16*>(wgt);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return static_cast<int>(launch_conv3x3_pool<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), batch, c_in, h, w, wb, bi, c_out,
        static_cast<__nv_bfloat16*>(out), s));
  }
  return static_cast<int>(launch_conv3x3_pool<float>(static_cast<const float*>(x), batch, c_in,
                                                     h, w, wb, bi, c_out,
                                                     static_cast<float*>(out), s));
}

}  // extern "C"
