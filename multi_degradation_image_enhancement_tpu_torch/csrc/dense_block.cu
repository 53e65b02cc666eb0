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
// The growth layer is the shared kernel of growth_layer.cuh (bf16 features in
// and out, written in place into the concat buffer); see there for its bound
// and design.
//
// The transition is a per-pixel GEMM (c_tot -> c_out, K <= 320): a block
// takes 64 pixels x (4 * OPT) outputs, stages 32-channel chunks of activated
// features and weights in shared memory, and accumulates OPT outputs per
// thread in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "growth_layer.cuh"

namespace {

using mdie::bf16_round;
using mdie::store;

// ------------------------------------------------------------------ transition
constexpr int kTPix = 64;      // pixels per block
constexpr int kTGroups = 4;    // output groups per block (threads = 64 * 4)
constexpr int kTChunk = 32;    // channels staged per pass

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
  auto* f = static_cast<__nv_bfloat16*>(feats);
  return static_cast<int>(mdie::launch_growth_layer<__nv_bfloat16, __nv_bfloat16>(
      f, c_tot, f, c_tot, ci, batch, h, w, ci,
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const __nv_bfloat16*>(wgt), static_cast<const float*>(bias), growth,
      static_cast<cudaStream_t>(stream)));
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
