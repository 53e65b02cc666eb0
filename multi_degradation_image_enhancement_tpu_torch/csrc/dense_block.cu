// Inference DenseBlock for Hopper (sm_90a): growth-layer and transition kernels.
//
// Replaces: multi_degradation_image_enhancement_tpu/ops/pallas/dense_block_cm.py
//           _kernel2 (pallas_call at :738, entries _run_cm2_jit :676 and
//           _run_cm2 :630).
//
// The math of _kernel2 (not its TPU blocking), with BatchNorm folded to a
// per-channel affine (a, b):
//   for i in 0..L-1:   g_i = conv3x3_{c_i -> G}(relu(a_i*f + b_i)) + bias_i
//                      f   = concat(f, bf16(g_i))
//   out = At @ relu(a_t*f + b_t) + bias_t      (1x1 transition, in x's dtype)
//
// Layout: one NCHW bf16 concat buffer feats [B, c_tot, H, W] per block, with
// channels [0, c_in) holding x and channels [c_i, c_i + G) written by growth
// layer i, so nothing is ever concatenated.  The caller copies x in.
//
// Rounding points follow _kernel2 (dense_block_cm.py:497-588): features are
// held in bf16; the affine and ReLU run in f32 and their result is rounded to
// bf16 (the bf16 matmul operand); weights are bf16; products accumulate in
// f32; g + bias is rounded to bf16; the transition output is cast to x's dtype.
// SAME padding applies to the ACTIVATED value: taps outside the image
// contribute 0, not relu(b) (the `inside` mask at dense_block_cm.py:490).
//
// Bound: the growth layers are ~90% of a DenseBlock's FLOPs (2*9*c_i*G per
// pixel) at only G = 16 outputs, so they are compute-bound on the FP32 pipes
// in this simple form (a tensor-core implicit GEMM is later work).  Design:
// one thread block per 16x32 pixel tile, image and group of 16 outputs; the
// (tile+2)^2 halo patch of a chunk of 8 input channels is loaded once into
// shared memory with the affine + ReLU + bf16 rounding applied at load, and
// the chunk's weights are staged beside it; each thread keeps 2 pixels x 16
// outputs in f32 registers, reading each weight once per 32 FMAs (broadcast
// float4 shared loads).  Feature bytes are read ~once per layer from L2/HBM.
//
// The transition is a per-pixel GEMM (c_tot -> c_out, K <= 320): a block
// takes 64 pixels x (4 * OPT) outputs, stages 32-channel chunks of activated
// features and weights in shared memory, and accumulates OPT outputs per
// thread in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- growth layer
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

// grid = (ceil(W / 32), ceil(H / 16), B * n_out_groups); block = (32, 8).
__global__ void __launch_bounds__(kTileW * kThreadsY)
growth_layer_kernel(__nv_bfloat16* feats, int c_tot, int H, int W, int ci,
                    const float* __restrict__ a, const float* __restrict__ b,
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
  const __nv_bfloat16* src = feats + (long long)img * c_tot * plane;

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
        const float f = __bfloat162float(src[cc * plane + (long long)gy * W + gx]);
        v = bf16_round(fmaxf(f * a[cc] + b[cc], 0.0f));
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

  __nv_bfloat16* dst = feats + ((long long)img * c_tot + ci) * plane;
  const int x = x0 + tx;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int y = y0 + ty + r * kThreadsY;
    if (x >= W || y >= H) continue;
#pragma unroll
    for (int o = 0; o < kOutGroup; ++o) {
      const int oo = og * kOutGroup + o;
      if (oo < G) dst[oo * plane + (long long)y * W + x] = __float2bfloat16(acc[r][o] + bias[oo]);
    }
  }
}

// ------------------------------------------------------------------ transition
constexpr int kTPix = 64;      // pixels per block
constexpr int kTGroups = 4;    // output groups per block (threads = 64 * 4)
constexpr int kTChunk = 32;    // channels staged per pass

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid = (ceil(HW / 64), ceil(c_out / (4 * OPT)), B); block = 256.
template <int OPT, typename TOut>
__global__ void __launch_bounds__(kTPix * kTGroups)
transition_kernel(const __nv_bfloat16* __restrict__ feats, int c_tot, int hw,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const __nv_bfloat16* __restrict__ wt,  // [c_out, c_tot]
                  const float* __restrict__ bias, int c_out, TOut* __restrict__ out) {
  constexpr int kOuts = kTGroups * OPT;
  __shared__ float vs[kTChunk][kTPix];
  __shared__ float ws[kOuts][kTChunk + 1];

  const int tid = threadIdx.x;
  const int px = tid % kTPix, grp = tid / kTPix;
  const int p0 = blockIdx.x * kTPix;
  const int o0 = blockIdx.y * kOuts;
  const int img = blockIdx.z;
  const __nv_bfloat16* src = feats + (long long)img * c_tot * hw;

  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < c_tot; c0 += kTChunk) {
    for (int idx = tid; idx < kTChunk * kTPix; idx += kTPix * kTGroups) {
      const int c = idx / kTPix, p = idx - c * kTPix;
      const int cc = c0 + c, pix = p0 + p;
      float v = 0.0f;
      if (cc < c_tot && pix < hw) {
        const float f = __bfloat162float(src[(long long)cc * hw + pix]);
        v = bf16_round(fmaxf(f * a[cc] + b[cc], 0.0f));
      }
      vs[c][p] = v;
    }
    for (int idx = tid; idx < kOuts * kTChunk; idx += kTPix * kTGroups) {
      const int o = idx / kTChunk, c = idx - o * kTChunk;
      const int oo = o0 + o, cc = c0 + c;
      ws[o][c] = (oo < c_out && cc < c_tot) ? __bfloat162float(wt[(long long)oo * c_tot + cc])
                                            : 0.0f;
    }
    __syncthreads();
    const int n_c = min(kTChunk, c_tot - c0);
    for (int c = 0; c < n_c; ++c) {
      const float v = vs[c][px];
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[j] += ws[grp * OPT + j][c] * v;
    }
    __syncthreads();
  }

  const int pix = p0 + px;
  if (pix >= hw) return;
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int oo = o0 + grp * OPT + j;
    if (oo < c_out) store(out + ((long long)img * c_out + oo) * hw + pix, acc[j] + bias[oo]);
  }
}

template <int OPT>
void launch_transition(const __nv_bfloat16* feats, int batch, int c_tot, int hw, const float* a,
                       const float* b, const __nv_bfloat16* wt, const float* bias, int c_out,
                       void* out, int out_bf16, cudaStream_t s) {
  constexpr int kOuts = kTGroups * OPT;
  const dim3 grid((hw + kTPix - 1) / kTPix, (c_out + kOuts - 1) / kOuts, batch);
  if (out_bf16) {
    transition_kernel<OPT, __nv_bfloat16><<<grid, kTPix * kTGroups, 0, s>>>(
        feats, c_tot, hw, a, b, wt, bias, c_out, static_cast<__nv_bfloat16*>(out));
  } else {
    transition_kernel<OPT, float><<<grid, kTPix * kTGroups, 0, s>>>(
        feats, c_tot, hw, a, b, wt, bias, c_out, static_cast<float*>(out));
  }
}

}  // namespace

extern "C" {

// feats: bf16 [batch, c_tot, h, w]; reads channels [0, ci), writes [ci, ci + growth).
// a, b: f32 [ci]; wgt: bf16 [growth, ci, 3, 3]; bias: f32 [growth].
int mdie_growth_layer(void* feats, int batch, int c_tot, int h, int w, int ci, const void* a,
                      const void* b, const void* wgt, const void* bias, int growth,
                      void* stream) {
  const int n_og = (growth + kOutGroup - 1) / kOutGroup;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch * n_og);
  growth_layer_kernel<<<grid, dim3(kTileW, kThreadsY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(feats), c_tot, h, w, ci, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(wgt),
      static_cast<const float*>(bias), growth, n_og);
  return static_cast<int>(cudaGetLastError());
}

// feats: bf16 [batch, c_tot, hw]; a, b: f32 [c_tot]; wt: bf16 [c_out, c_tot];
// bias: f32 [c_out]; out: [batch, c_out, hw], f32 or bf16.
int mdie_transition(const void* feats, int batch, int c_tot, int hw, const void* a,
                    const void* b, const void* wt, const void* bias, int c_out, void* out,
                    int out_bf16, void* stream) {
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* w = static_cast<const __nv_bfloat16*>(wt);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_out <= kTGroups) {
    launch_transition<1>(f, batch, c_tot, hw, af, bf, w, bi, c_out, out, out_bf16, s);
  } else {
    launch_transition<8>(f, batch, c_tot, hw, af, bf, w, bi, c_out, out, out_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
