// Trainable DenseBlock growth layer for Hopper (sm_90a): forward and backward.
//
// Replaces: multi_degradation_image_enhancement_tpu/ops/pallas/growth_train.py
//   forward   _fwd_kernel (:86, pallas_call :588) and _fwd_kernel_tiled
//             (:288, pallas_call :638);
//   backward  _bwd_kernel (:178, pallas_call :798) and _bwd_kernel_tiled
//             (:345, pallas_call :697).
// The TPU row tiling, channel padding, lane rolls and VMEM planners were
// answers to the TPU's memory; here one forward and one backward cover both
// variants of each pass.
//
// Forward (growth_layer.cuh, f32 features in and out):
//   v = bf16(relu(x*a + b)), zero outside the image;  g = conv3x3(v, bf16(w)) + bias.
//
// Backward, given dg [B, 16, H, W] (rounded to bf16, as the TPU kernel's dgs):
//   dv[c,p]  = sum_{o,tap} w[o,c,tap] * dg[o, p - tap]    (transposed 3x3 conv)
//   m        = (v > 0)  (zero outside the image and where z <= 0)
//   dx       = dv * m * a                                  (written in f32)
//   da[c]    = sum_p dv*m*x,   db[c] = sum_p dv*m
//   dw[o,c,tap] = sum_p dg[o,p] * v[c, p + tap]            (over all B*H*W pixels)
// All products are of bf16-rounded operands, accumulated in f32.  dbias =
// sum dg stays a plain f32 reduction outside (as the JAX package computes it,
// growth_train.py:873).
//
// Bounds and design.  dv is the forward's shape transposed (2*9*16*c FLOPs
// per pixel, FP32 pipes): one block per 16x32 pixel tile keeps the bf16 halo
// patch of all 16 dg channels in shared memory and walks the input channels
// in chunks of 16, each thread holding 2 pixels x 16 channels; the epilogue
// recomputes v from x (one coalesced read) for the mask, writes dx and
// reduces da/db over the block.  dw is a reduction over up to 1.57 M pixels
// into 144*c outputs: each block owns a 16-channel chunk and a fixed set of
// 8x32 pixel tiles, each thread one (o, c) pair and its 9 taps, fed from a
// dg tile and an activated v halo patch in shared memory (a 3-wide sliding
// window: 4 shared loads per 9 FMAs).  The pixel reductions are
// deterministic: per-block partials, then a fixed-order column-sum launch;
// no float atomics, so two runs give the same weights.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "growth_layer.cuh"

namespace {

using mdie::activate;
using mdie::bf16_round;

constexpr int G = 16;  // growth rate the backward is written for

// ------------------------------------------------------------------ dv kernel
constexpr int kTW = 32, kTH = 16, kTY = 8;  // pixel tile; block = (32, 8), 2 rows a thread
constexpr int kPH = kTH + 2, kPW = kTW + 2;
constexpr int kCC = 16;                      // input channels per pass

// grid = (ceil(W / 32), ceil(H / 16), B); block = (32, 8).
// da_part, db_part: [gridDim.x * gridDim.y * B, c] block partials.
__global__ void __launch_bounds__(kTW * kTY)
growth_dv_kernel(const float* __restrict__ x, const float* __restrict__ dg, int c, int H, int W,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const __nv_bfloat16* __restrict__ wgt,  // [16, c, 3, 3]
                 float* __restrict__ dx, float* __restrict__ da_part,
                 float* __restrict__ db_part) {
  __shared__ __nv_bfloat16 dgp[G][kPH][kPW];
  __shared__ __align__(16) float wsm[G][9][kCC];
  __shared__ float red[2][kTY][kCC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int img = blockIdx.z;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const long long plane = (long long)H * W;
  const long long blk = ((long long)img * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const float* xi = x + (long long)img * c * plane;
  float* dxi = dx + (long long)img * c * plane;

  // bf16 halo patch of dg: patch (py, px) holds image pixel (y0 + py - 1, x0 + px - 1).
  const float* dgi = dg + (long long)img * G * plane;
  for (int idx = tid; idx < G * kPH * kPW; idx += kTW * kTY) {
    const int o = idx / (kPH * kPW);
    const int rem = idx - o * (kPH * kPW);
    const int py = rem / kPW, px = rem - py * kPW;
    const int gy = y0 + py - 1, gx = x0 + px - 1;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = dgi[o * plane + (long long)gy * W + gx];
    dgp[o][py][px] = __float2bfloat16(v);
  }

  const int px0 = x0 + tx;
  for (int c0 = 0; c0 < c; c0 += kCC) {
    __syncthreads();  // dgp ready (first pass); wsm and red free (later passes)
    for (int idx = tid; idx < G * 9 * kCC; idx += kTW * kTY) {
      const int o = idx / (9 * kCC);
      const int rem = idx - o * (9 * kCC);
      const int t = rem / kCC, cl = rem - t * kCC;
      const int cc = c0 + cl;
      wsm[o][t][cl] = cc < c ? __bfloat162float(wgt[((long long)o * c + cc) * 9 + t]) : 0.0f;
    }
    __syncthreads();

    float acc[2][kCC];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < kCC; ++j) acc[r][j] = 0.0f;

    // Pixel (ly, lx) reads dg at patch (ly + 2 - ky, lx + 2 - kx).
    for (int o = 0; o < G; ++o) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float d[2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            d[r] = __bfloat162float(dgp[o][ty + r * kTY + 2 - ky][tx + 2 - kx]);
          const float4* w4 = reinterpret_cast<const float4*>(&wsm[o][ky * 3 + kx][0]);
#pragma unroll
          for (int j = 0; j < kCC / 4; ++j) {
            const float4 w = w4[j];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              acc[r][4 * j + 0] += d[r] * w.x;
              acc[r][4 * j + 1] += d[r] * w.y;
              acc[r][4 * j + 2] += d[r] * w.z;
              acc[r][4 * j + 3] += d[r] * w.w;
            }
          }
        }
      }
    }

    // Epilogue: mask by v > 0, write dx, and this thread's da/db terms.
    float pa[kCC], pb[kCC];
#pragma unroll
    for (int j = 0; j < kCC; ++j) pa[j] = pb[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = y0 + ty + r * kTY;
      if (px0 >= W || y >= H) continue;
      const long long off = (long long)y * W + px0;
#pragma unroll
      for (int j = 0; j < kCC; ++j) {
        const int cc = c0 + j;
        if (cc >= c) continue;
        const float xv = xi[cc * plane + off];
        const float v = activate(xv, a[cc], b[cc]);
        const float dvm = v > 0.0f ? acc[r][j] : 0.0f;
        dxi[cc * plane + off] = dvm * a[cc];
        pa[j] += dvm * xv;
        pb[j] += dvm;
      }
    }
    // Block reduction in a fixed order: warp butterfly, then the 8 warps.
#pragma unroll
    for (int j = 0; j < kCC; ++j) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        pa[j] += __shfl_xor_sync(0xffffffffu, pa[j], s);
        pb[j] += __shfl_xor_sync(0xffffffffu, pb[j], s);
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int j = 0; j < kCC; ++j) {
        red[0][ty][j] = pa[j];
        red[1][ty][j] = pb[j];
      }
    }
    __syncthreads();
    if (tid < 2 * kCC) {
      const int which = tid / kCC, j = tid - which * kCC;
      const int cc = c0 + j;
      if (cc < c) {
        float s = 0.0f;
        for (int w = 0; w < kTY; ++w) s += red[which][w][j];
        (which == 0 ? da_part : db_part)[blk * c + cc] = s;
      }
    }
  }
}

// ------------------------------------------------------------------ dw kernel
constexpr int kWH = 8, kWW = 32;            // pixel tile of the dw kernel
constexpr int kWC = 16;                      // channels per block
constexpr int kDgStride = kWH * kWW + 1;     // odd: the 16 o's of a half-warp hit 16 banks

struct TileGrid {
  int tiles_x, tiles_y, n_tiles;
};

__host__ __device__ inline TileGrid dw_tiles(int batch, int H, int W) {
  TileGrid t;
  t.tiles_x = (W + kWW - 1) / kWW;
  t.tiles_y = (H + kWH - 1) / kWH;
  t.n_tiles = batch * t.tiles_x * t.tiles_y;
  return t;
}

// grid = (n_groups, ceil(c / 16)); block = 256: thread t owns o = t % 16,
// channel c0 + t / 16, and the 9 taps.  Group g sums tiles g, g + n_groups, ...
// dw_part: [n_groups, 16, c, 9].
__global__ void __launch_bounds__(256)
growth_dw_kernel(const float* __restrict__ x, const float* __restrict__ dg, int batch, int c,
                 int H, int W, const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ dw_part) {
  __shared__ float dgs[G * kDgStride];
  __shared__ float vs[kWC][kWH + 2][kWW + 2];

  const int tid = threadIdx.x;
  const int o = tid % G, cl = tid / G;
  const int c0 = blockIdx.y * kWC;
  const TileGrid tg = dw_tiles(batch, H, W);
  const long long plane = (long long)H * W;

  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.0f;

  for (int tile = blockIdx.x; tile < tg.n_tiles; tile += gridDim.x) {
    const int img = tile / (tg.tiles_x * tg.tiles_y);
    const int rem = tile - img * (tg.tiles_x * tg.tiles_y);
    const int y0 = (rem / tg.tiles_x) * kWH, x0 = (rem % tg.tiles_x) * kWW;
    const float* dgi = dg + (long long)img * G * plane;
    const float* xi = x + (long long)img * c * plane;

    __syncthreads();  // previous tile's reads done
    for (int idx = tid; idx < G * kWH * kWW; idx += 256) {
      const int oo = idx / (kWH * kWW);
      const int r = idx - oo * (kWH * kWW);
      const int ly = r / kWW, lx = r - ly * kWW;
      const int gy = y0 + ly, gx = x0 + lx;
      float v = 0.0f;
      if (gy < H && gx < W) v = bf16_round(dgi[oo * plane + (long long)gy * W + gx]);
      dgs[oo * kDgStride + r] = v;
    }
    for (int idx = tid; idx < kWC * (kWH + 2) * (kWW + 2); idx += 256) {
      const int cc = idx / ((kWH + 2) * (kWW + 2));
      const int r = idx - cc * ((kWH + 2) * (kWW + 2));
      const int py = r / (kWW + 2), px = r - py * (kWW + 2);
      const int gy = y0 + py - 1, gx = x0 + px - 1, ch = c0 + cc;
      float v = 0.0f;
      if (ch < c && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = activate(xi[ch * plane + (long long)gy * W + gx], a[ch], b[ch]);
      }
      vs[cc][py][px] = v;
    }
    __syncthreads();

    // dw[o, c, ky, kx] += dg[o, y, x] * v[c, y + ky - 1, x + kx - 1]; patch
    // row y + ky holds image row y0 + y + ky - 1.
    const float* dgo = dgs + o * kDgStride;
    for (int y = 0; y < kWH; ++y) {
      float w0[3], w1[3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        w0[ky] = vs[cl][y + ky][0];
        w1[ky] = vs[cl][y + ky][1];
      }
#pragma unroll
      for (int xx = 0; xx < kWW; ++xx) {
        const float d = dgo[y * kWW + xx];
        float w2[3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          w2[ky] = vs[cl][y + ky][xx + 2];
          acc[ky * 3 + 0] += d * w0[ky];
          acc[ky * 3 + 1] += d * w1[ky];
          acc[ky * 3 + 2] += d * w2[ky];
          w0[ky] = w1[ky];
          w1[ky] = w2[ky];
        }
      }
    }
  }

  const int ch = c0 + cl;
  if (ch < c) {
    float* dst = dw_part + (((long long)blockIdx.x * G + o) * c + ch) * 9;
#pragma unroll
    for (int t = 0; t < 9; ++t) dst[t] = acc[t];
  }
}

// ------------------------------------------------------------ column sums
// out[j] = sum_{i < rows} part[i * cols + j], in a fixed order: thread (tx, ty)
// sums rows ty, ty + 32, ... of column j, then row 0 of the block adds the 32
// partial sums.  grid = ceil(cols / 32); block = (32, 32).
constexpr int kSumRows = 32;

__global__ void __launch_bounds__(32 * kSumRows)
column_sum_kernel(const float* __restrict__ part, int rows, int cols, float* __restrict__ out) {
  __shared__ float red[kSumRows][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (j < cols) {
    for (int i = threadIdx.y; i < rows; i += kSumRows) s += part[(long long)i * cols + j];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    float t = 0.0f;
    for (int k = 0; k < kSumRows; ++k) t += red[k][threadIdx.x];
    out[j] = t;
  }
}

cudaError_t column_sum(const float* part, int rows, int cols, float* out, cudaStream_t s) {
  column_sum_kernel<<<(cols + 31) / 32, dim3(32, kSumRows), 0, s>>>(part, rows, cols, out);
  return cudaGetLastError();
}

// Blocks of the dv kernel, and the dw kernel's number of tile groups: about
// eight blocks per SM in all, at most one group per tile.
long long dv_blocks(int batch, int h, int w) {
  return (long long)((w + kTW - 1) / kTW) * ((h + kTH - 1) / kTH) * batch;
}

int dw_groups(int batch, int c, int h, int w) {
  const int chunks = (c + kWC - 1) / kWC;
  const int want = (132 * 8 + chunks - 1) / chunks;
  const int n_tiles = dw_tiles(batch, h, w).n_tiles;
  return want < n_tiles ? want : n_tiles;
}

}  // namespace

extern "C" {

// x: f32 [batch, c, h, w]; a, b: f32 [c]; wgt: bf16 [16, c, 3, 3]; bias: f32 [16];
// g: f32 [batch, 16, h, w].
int mdie_growth_fwd(const void* x, int batch, int c, int h, int w, const void* a, const void* b,
                    const void* wgt, const void* bias, void* g, void* stream) {
  return static_cast<int>(mdie::launch_growth_layer<float, float>(
      static_cast<const float*>(x), c, static_cast<float*>(g), G, 0, batch, h, w, c,
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const __nv_bfloat16*>(wgt), static_cast<const float*>(bias), G,
      static_cast<cudaStream_t>(stream)));
}

// Floats of scratch mdie_growth_bwd needs at this shape.
long long mdie_growth_bwd_scratch(int batch, int c, int h, int w) {
  return 2 * dv_blocks(batch, h, w) * c + (long long)dw_groups(batch, c, h, w) * G * c * 9;
}

// x, dg as in the forward (dg: f32 [batch, 16, h, w]); outputs dx f32 [batch,
// c, h, w], dw f32 [16, c, 3, 3], da, db f32 [c]; scratch: f32 of
// mdie_growth_bwd_scratch floats.  Five launches; returns the first error.
int mdie_growth_bwd(const void* x, const void* dg, int batch, int c, int h, int w, const void* a,
                    const void* b, const void* wgt, void* dx, void* dw, void* da, void* db,
                    void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* dgf = static_cast<const float*>(dg);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const long long n_dv = dv_blocks(batch, h, w);
  const int n_groups = dw_groups(batch, c, h, w);
  float* da_part = static_cast<float*>(scratch);
  float* db_part = da_part + n_dv * c;
  float* dw_part = db_part + n_dv * c;

  const dim3 dv_grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  growth_dv_kernel<<<dv_grid, dim3(kTW, kTY), 0, s>>>(
      xf, dgf, c, h, w, af, bf, static_cast<const __nv_bfloat16*>(wgt), static_cast<float*>(dx),
      da_part, db_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  growth_dw_kernel<<<dim3(n_groups, (c + kWC - 1) / kWC), 256, 0, s>>>(
      xf, dgf, batch, c, h, w, af, bf, dw_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = column_sum(dw_part, n_groups, G * c * 9, static_cast<float*>(dw), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = column_sum(da_part, static_cast<int>(n_dv), c, static_cast<float*>(da), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(column_sum(db_part, static_cast<int>(n_dv), c, static_cast<float*>(db), s));
}

}  // extern "C"
