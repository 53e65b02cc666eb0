// Inference DenseBlock for Hopper (sm_90a): entry pass, growth layers and
// transition, every product on the tensor cores (wgmma).
//
// Replaces (one kernel family, three TPU kernels):
//   multi_degradation_image_enhancement_tpu/ops/pallas/dense_block_cm.py
//     _kernel2 :452 (pallas_call at :738, entries _run_cm2 :630, _run_cm2_jit :676)
//     _kernel  :111 (pallas_call at :421; the row-tiled #3, NHWC entry
//                    fused_dense_block_cm in ops/cuda/dense_block.py)
//   multi_degradation_image_enhancement_tpu/ops/pallas/dense_block.py
//     _kernel  :56  (pallas_call at :236; the row-major #10, NHWC entry
//                    fused_dense_block in ops/cuda/dense_block.py)
//
// The math of _kernel2 (not its TPU blocking), with BatchNorm folded to a
// per-channel affine (a, b):
//   for i in 0..L-1:   g_i = conv3x3_{c_i -> G}(relu(a_i*f + b_i)) + bias_i
//                      f   = concat(f, bf16(g_i))
//   out = At @ relu(a_t*f + b_t) + bias_t      (1x1 transition, in x's dtype)
// Rounding points (dense_block_cm.py:497-588): features are held in bf16;
// the affine and ReLU run in f32 and their result is rounded to bf16 (the
// bf16 matmul operand); weights are bf16; products accumulate in f32;
// g + bias is rounded to bf16; the transition output is rounded once to x's
// dtype.  SAME padding applies to the ACTIVATED value: taps outside the
// image contribute 0, not relu(b) (the `inside` mask at dense_block_cm.py:490).
// With bf16_act (serving_tuning.json's db_bf16_act, dense_block_cm.py:515-523)
// the affine and ReLU run in bf16 instead, a and b rounded to bf16: the
// product rounded, the sum rounded, then the ReLU (Affine8Bf16; two
// roundings where one fma would make one).  The pack picks it per launch:
// every transition, and each growth layer whose JAX channel count
// ceil16(c_in) + 16*i exceeds db_k_stack_max_ci (the K-stacked layers of
// dense_block_cm.py:532-535 activate in f32 whatever the flag).
//
// Bound: 2*9*c_i*G FLOPs a pixel per growth layer and 2*c_tot*c_out for the
// transition, against x in and out: operations bind (0.700 ms for the four
// blocks of a B=128 256x256 serving step at 989 TFLOP/s bf16).  A design
// that keeps the concat buffer in HBM between layers moves ~9.7 GB at that
// shape instead, ~2.9 ms at 3.35 TB/s: that is this design's floor.  The
// N = 16 products are not what sets the pace: the instructions a K chunk
// costs the SM's issue slots are (the loads' and stores' address
// arithmetic, the prologue, the descriptors).  More blocks an SM, deeper
// load pipelines and other load mechanisms left the time as it was;
// hoisting the per-thread addresses and descriptors out of the K loop did
// not (PERF.md §6).
//
// Layout: one NHWC bf16 concat buffer feats [B, H, W, c_buf] a block, with
// padded slots (the pack in ops/cuda/dense_block.py): x in channels
// [0, c_in_pad), c_in_pad = c_in rounded up to 8 (zeros past c_in); growth
// layer i writes [c_in_pad + g_pad*i, + g_pad), g_pad = G rounded up to 16
// (zero weights and bias on the pad, so the pad holds zeros).  Channels are
// innermost, so K of every product is contiguous, and every slot starts on
// 16 bytes.  Three kinds of launch:
//
// 1. Entry pass: NCHW x (f32 or bf16) is rounded and transposed into slot 0
//    (nhwc_pass.cuh, shared with conv_cm.cu's #8), or NHWC x is copied
//    straight in (the #3 and #10 entries).
// 2. Growth layer: an implicit GEMM, M = pixels, N = 16 outputs, K = 9 taps
//    x c_i channels.  A block of two warpgroups takes an 8 x 32 pixel tile
//    (four 64-pixel M tiles of 8 rows x 8 columns) and one group of 16
//    outputs.  Per chunk of 32 input channels every thread loads its share
//    of the tile's halo'd (10 x 34 pixels) box and of the chunk's weights
//    with 16-byte loads into registers, then applies the prologue once per
//    element (affine, ReLU, bf16 rounding, zero for pixels outside the image
//    and channels at or past c_i, which may be NaN in a buffer from
//    torch.empty) and writes the activated box to shared memory as K-major
//    core matrices without swizzle: [channel group of 8][halo pixel][8].  A
//    core matrix (8 pixels of a row x 8 channels) is then 128 contiguous
//    bytes wherever it starts, so each tap (ky, kx) is the same box read at
//    a start moved by ky rows and kx pixels (16 bytes a pixel): 9 SS wgmma
//    m64n16k16 a 16-channel step and M tile, nothing copied per tap.  The
//    next chunk's loads are issued before the products, so they overlap
//    them; two blocks share an SM.  The epilogue adds the f32 bias, rounds
//    to bf16 and stores the 16-channel slot.
// 3. Transition: a per-pixel GEMM over the buffer seen as [B*H*W, c_buf],
//    M = 128 pixels a block (two warpgroups), N = c_out padded to 8, 64 or a
//    multiple of 64 (tiles of 64 or 128), K = c_buf, with the same prologue
//    (a_t, b_t) applied once per element as it is staged.  Each feature is
//    read once per N tile (once for every block as shipped).  The epilogue
//    adds the f32 bias, stages 32 channels x 128 pixels in shared memory and
//    writes them coalesced, NCHW (the model's forward) or NHWC (#3, #10),
//    rounded once to x's dtype.
//
// Measured and not kept (PERF.md §6, PR 8): a ring of chunks in shared
// memory filled by cp.async or by TMA (the prologue in place, overlapping
// the previous chunk's products), 16-row tiles, one to three blocks an SM,
// and a buffer blocked by 32 channels: none faster than this design, the
// simplest of them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "nhwc_pass.cuh"

namespace {

namespace db {
constexpr int kKC = 32;                    // channels of a K chunk
constexpr int kKG = kKC / 8;               // 16-byte channel groups of a chunk
constexpr int kThreads = 2 * kWarpgroup;   // two warpgroups
static_assert(kThreads % kKG == 0, "a thread keeps one channel group");
// growth layer
constexpr int kBW = 8, kBH = 32;           // output tile: 4 M tiles of 8 rows x 8 columns
constexpr int kMT = kBH / 16;              // M tiles of a warpgroup
constexpr int kHW = kBW + 2, kHH = kBH + 2, kHalo = kHW * kHH;
constexpr int kGN = 16;                    // outputs of a block (wgmma N)
constexpr int kGAVec = kHalo * kKG;        // 16-byte vectors of a chunk's box
constexpr int kGBVec = 9 * kGN * kKG;      // ... of a chunk's weights
constexpr int kGAPer = (kGAVec + kThreads - 1) / kThreads;
constexpr int kGBPer = (kGBVec + kThreads - 1) / kThreads;
static_assert(kGAPer <= 32, "validity mask");
// transition
constexpr int kTM = 2 * 64;                // pixels of a tile
constexpr int kTAPer = kTM * kKG / kThreads;
constexpr int kTStage = 32;                // output channels staged at a time
constexpr int kTPitch = kTM + 4;
}  // namespace db

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The affine of 8 channels [c, c + 8), read once per chunk.
struct Affine8 {
  float a[8], b[8];
  __device__ __forceinline__ void load(const float* pa, const float* pb) {
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(pa));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(pa) + 1);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(pb));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(pb) + 1);
    a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w, a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
    b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w, b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
  }
  // relu(f*a + b) in f32 (one fused multiply-add: an instruction fewer than
  // the plain version's product and sum, within one f32 rounding of it),
  // rounded to bf16.
  __device__ __forceinline__ uint4 operator()(uint4 raw) const {
    const auto* f = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 out;
    auto* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(f[i]);
      o[i] = __floats2bfloat162_rn(fmaxf(fmaf(v.x, a[2 * i], b[2 * i]), 0.0f),
                                   fmaxf(fmaf(v.y, a[2 * i + 1], b[2 * i + 1]), 0.0f));
    }
    return out;
  }
};

// The same in bf16 (bf16_act): relu(bf16(bf16(f*a) + b)), a and b rounded to
// bf16 once per chunk.  The _rn intrinsics keep the product and the sum two
// instructions with a rounding each: no contraction into one fma.
struct Affine8Bf16 {
  __nv_bfloat162 a[4], b[4];
  __device__ __forceinline__ void load(const float* pa, const float* pb) {
    Affine8 f;
    f.load(pa, pb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = __floats2bfloat162_rn(f.a[2 * i], f.a[2 * i + 1]);
      b[i] = __floats2bfloat162_rn(f.b[2 * i], f.b[2 * i + 1]);
    }
  }
  __device__ __forceinline__ uint4 operator()(uint4 raw) const {
    const auto* f = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
    uint4 out;
    auto* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __hmax2(__hadd2_rn(__hmul2_rn(f[i], a[i]), b[i]), zero);
    return out;
  }
};

// ------------------------------------------------------------------ entry pass
// NHWC x [P, c_in] -> channels [0, c_in_pad) of y [P, c_buf], zeros past c_in.
template <typename T>
__global__ void nhwc_to_slot_kernel(const T* __restrict__ x, long long P, int c_in, int c_in_pad,
                                    int c_buf, __nv_bfloat16* __restrict__ y) {
  const long long n = P * c_in_pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / c_in_pad;
    const int c = static_cast<int>(i - p * c_in_pad);
    const float v = c < c_in ? bf16_operand(x[p * c_in + c]) : 0.0f;
    y[p * c_buf + c] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------- growth layer
// grid = (tiles_w * tiles_h * n_groups, B); block = 256.  feats: [B, H, W,
// c_buf]; reads channels [0, ci), writes [ci + 16*og, + 16) of output group
// og.  a, b: f32 [k_pad]; wk: bf16 [9, 16 * n_groups, k_pad] (tap, output,
// channel); bias: f32 [16 * n_groups]; k_pad = ci rounded up to 32, zeros
// past ci.  Act: the prologue's affine + ReLU (Affine8, or Affine8Bf16).
template <typename Act>
__global__ void __launch_bounds__(db::kThreads, 2)
growth_wgmma_kernel(__nv_bfloat16* feats, int c_buf, int H, int W, int ci, int k_pad,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const __nv_bfloat16* __restrict__ wk, const float* __restrict__ bias,
                    int n_groups, int tiles_w) {
  using namespace db;
  __shared__ __align__(128) uint4 sa[kKG * kHalo];    // [group][halo pixel]
  __shared__ __align__(128) uint4 sb[9 * kKG * kGN];  // [tap][group][n]
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const int warp = tid % kWarpgroup / 32, lane = tid % 32;
  const int og = blockIdx.x % n_groups, tile = blockIdx.x / n_groups;
  const int x0 = tile % tiles_w * kBW, y0 = tile / tiles_w * kBH;
  const long long img_off = (long long)blockIdx.y * H * W * c_buf;
  const __nv_bfloat16* fin = feats + img_off;
  const int k_chunks = k_pad / kKC;
  const int g = tid % kKG;  // the channel group of every vector this thread moves

  // What this thread moves, fixed for the whole K walk (the loop's
  // instructions, not the bytes, bound this kernel; PERF.md §6): vector i of
  // the box is halo pixel tid / 4 + 64 i, its global offset and whether it
  // lies in the image; weight vector i is row (tap, n) = (q / 16 + 4 i, q % 16).
  constexpr int kVStep = kThreads / kKG;  // halo pixels between a thread's vectors
  long long off[kGAPer];
  uint32_t in_image = 0;
#pragma unroll
  for (int i = 0; i < kGAPer; ++i) {
    const int hp = tid / kKG + i * kVStep;
    const int gy = y0 - 1 + hp / kHW, gx = x0 - 1 + hp % kHW;
    off[i] = ((long long)gy * W + gx) * c_buf + 8 * g;
    if (hp < kHalo && gy >= 0 && gy < H && gx >= 0 && gx < W) in_image |= 1u << i;
  }
  const int q = tid / kKG;
  const __nv_bfloat16* wrow =
      wk + ((long long)(q / kGN) * n_groups * kGN + og * kGN + q % kGN) * k_pad + 8 * g;
  const long long w_step = 4ll * n_groups * kGN * k_pad;  // 4 taps further
  uint4* sa_mine = sa + g * kHalo + q;
  uint4* sb_mine = sb + ((q / kGN) * kKG + g) * kGN + q % kGN;

  uint4 ra[kGAPer], rb[kGBPer];
  uint32_t valid = 0;
  auto load = [&](int c0) {  // chunk c0's box (zeros where not valid) and weights
    valid = c0 + 8 * g < ci ? in_image : 0u;
#pragma unroll
    for (int i = 0; i < kGAPer; ++i)
      if (valid >> i & 1u) ra[i] = *reinterpret_cast<const uint4*>(fin + off[i] + c0);
#pragma unroll
    for (int i = 0; i < kGBPer; ++i)
      if (tid + i * kThreads < kGBVec)
        rb[i] = __ldg(reinterpret_cast<const uint4*>(wrow + i * w_step + c0));
  };
  auto stage = [&](int c0) {  // the prologue, once per element, into shared memory
    Act f;
    if (c0 + 8 * g < ci) f.load(a + c0 + 8 * g, b + c0 + 8 * g);
#pragma unroll
    for (int i = 0; i < kGAPer; ++i)
      if (tid + i * kThreads < kGAVec)
        sa_mine[i * kVStep] = (valid >> i & 1u) ? f(ra[i]) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kGBPer; ++i)
      if (tid + i * kThreads < kGBVec) sb_mine[i * 4 * kKG * kGN] = rb[i];
  };

  // Descriptors of this warpgroup's first window and of the weights; a tap,
  // M tile or K step moves the start field (16-byte units) by a constant.
  const uint64_t desc_a0 = smem_desc_interleave(&sa[wg * (kBH / 2) * kHW], kHalo * 16, kHW * 16);
  const uint64_t desc_b0 = smem_desc_interleave(sb, kGN * 16, 128);
  float acc[kMT][8];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mt][i] = 0.0f;

  load(0);
  for (int kc = 0; kc < k_chunks; ++kc) {
    const int c0 = kc * kKC;
    __syncthreads();  // the previous chunk's products have read sa and sb
    stage(c0);
    fence_proxy_async();  // the generic-proxy writes are seen by wgmma
    __syncthreads();
    if (kc + 1 < k_chunks) load(c0 + kKC);  // in flight during the products
    const int ksteps = min(2, (ci - c0 + 15) / 16);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks < ksteps) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
          const uint64_t desc_b = desc_b0 + (tap * kKG + 2 * ks) * kGN;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            // M tile rows are 8 tile rows x 8 columns; tap (ky, kx) moves the
            // window by ky halo rows and kx pixels.
            const uint64_t desc_a = desc_a0 + 2 * ks * kHalo + (mt * 8 + ky) * kHW + kx;
            wgmma_bf16<kGN, 0, 0>(acc[mt], desc_a, desc_b);
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_regs<8>(acc[mt]);
  }

  // Epilogue: row m = 16*warp + lane/4 + 8h of M tile mt is pixel
  // (y0 + kBH/2*wg + 8*mt + 2*warp + h, x0 + lane/4); columns 8j + 2(lane%4) + e.
  __nv_bfloat16* out = feats + img_off + ci + og * kGN;
  const int x = x0 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + kBH / 2 * wg + 8 * mt + 2 * warp + h;
      if (y >= H || x >= W) continue;
      __nv_bfloat16* o = out + ((long long)y * W + x) * c_buf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ch = 8 * j + col;
        const float b0 = __ldg(bias + og * kGN + ch), b1 = __ldg(bias + og * kGN + ch + 1);
        *reinterpret_cast<__nv_bfloat162*>(o + ch) =
            __floats2bfloat162_rn(acc[mt][4 * j + 2 * h] + b0, acc[mt][4 * j + 2 * h + 1] + b1);
      }
    }
  }
}

// ------------------------------------------------------------------ transition
// grid = (ceil(P / 128), n_pad / BN); block = 256.  feats: [P, c_buf];
// at, bt: f32 [k_pad]; wt: bf16 [n_pad, k_pad] K-major; bias: f32 [n_pad];
// k_pad = c_buf rounded up to 32, zeros past c_buf; out: NCHW [B, c_out,
// HW] or NHWC [P, c_out] of TOut, P = B * HW.  Act as for the growth layer.
template <int BN, typename TOut, typename Act>
__global__ void __launch_bounds__(db::kThreads)
transition_wgmma_kernel(const __nv_bfloat16* __restrict__ feats, long long P, int HW, int c_buf,
                        int k_pad, const float* __restrict__ at, const float* __restrict__ bt,
                        const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias,
                        int c_out, TOut* __restrict__ out, int nhwc) {
  using namespace db;
  constexpr int kBVec = BN * kKG;
  constexpr int kBPer = (kBVec + kThreads - 1) / kThreads;
  constexpr int kAcc = BN / 2;
  constexpr int kStage = BN < kTStage ? BN : kTStage;
  __shared__ __align__(128) uint4 sa[kKG * kTM];  // [group][pixel]
  __shared__ __align__(128) uint4 sb[kKG * BN];   // [group][n]
  __shared__ float staged[kStage][kTPitch];       // [channel][pixel]
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const int warp = tid % kWarpgroup / 32, lane = tid % 32;
  const long long p0 = (long long)blockIdx.x * kTM;
  const int n0 = blockIdx.y * BN;
  const int k_chunks = k_pad / kKC;
  const int g = tid % kKG;

  uint4 ra[kTAPer], rb[kBPer];
  uint32_t valid = 0;
  auto load = [&](int c0) {
    valid = 0;
#pragma unroll
    for (int i = 0; i < kTAPer; ++i) {
      const long long p = p0 + (tid + i * kThreads) / kKG;
      if (p < P && c0 + 8 * g < c_buf) {
        ra[i] = *reinterpret_cast<const uint4*>(feats + p * c_buf + c0 + 8 * g);
        valid |= 1u << i;
      }
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kThreads;
      if (v < kBVec)
        rb[i] = __ldg(reinterpret_cast<const uint4*>(wt + (long long)(n0 + v / kKG) * k_pad + c0 + 8 * g));
    }
  };
  auto stage = [&](int c0) {
    Act f;
    if (c0 + 8 * g < c_buf) f.load(at + c0 + 8 * g, bt + c0 + 8 * g);
#pragma unroll
    for (int i = 0; i < kTAPer; ++i)
      sa[g * kTM + (tid + i * kThreads) / kKG] = (valid >> i & 1u) ? f(ra[i]) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kThreads;
      if (v < kBVec) sb[g * BN + v / kKG] = rb[i];
    }
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  load(0);
  for (int kc = 0; kc < k_chunks; ++kc) {
    const int c0 = kc * kKC;
    __syncthreads();
    stage(c0);
    fence_proxy_async();
    __syncthreads();
    if (kc + 1 < k_chunks) load(c0 + kKC);
    const int ksteps = min(2, (c_buf - c0 + 15) / 16);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks < ksteps) {
        const uint64_t desc_a = smem_desc_interleave(&sa[2 * ks * kTM + wg * 64], kTM * 16, 128);
        const uint64_t desc_b = smem_desc_interleave(&sb[2 * ks * BN], BN * 16, 128);
        wgmma_bf16<BN, 0, 0>(acc, desc_a, desc_b);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
  }

  // Epilogue: + bias, staged kStage channels at a time, written coalesced.
  const int q = lane % 4;
  const long long p_mine = p0 + tid % kTM, img_mine = p_mine / HW;  // NCHW: one pixel a thread
  TOut* out_mine = out + img_mine * c_out * HW + (p_mine - img_mine * HW);
#pragma unroll
  for (int sc = 0; sc < BN / kStage; ++sc) {
    __syncthreads();  // the last chunk's stores have read `staged`
#pragma unroll
    for (int jj = 0; jj < kStage / 8; ++jj) {
      const int j = sc * (kStage / 8) + jj;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = n0 + 8 * j + 2 * q + e;
        const float bch = ch < c_out ? __ldg(bias + ch) : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          staged[8 * jj + 2 * q + e][wg * 64 + 16 * warp + lane / 4 + 8 * h] = acc[4 * j + 2 * h + e] + bch;
      }
    }
    __syncthreads();
    const int cb = n0 + sc * kStage;
    const int cw = min(kStage, c_out - cb);
    if (cw <= 0) continue;
    if (nhwc) {
      for (int idx = tid; idx < kTM * cw; idx += kThreads) {
        const int pl = idx / cw, chl = idx - pl * cw;
        const long long p = p0 + pl;
        if (p < P) store_out(out + p * c_out + cb + chl, staged[chl][pl]);
      }
    } else if (p_mine < P) {  // this thread's pixel, channels tid / kTM + 2k
      for (int chl = tid / kTM; chl < cw; chl += kThreads / kTM)
        store_out(out_mine + (long long)(cb + chl) * HW, staged[chl][tid % kTM]);
    }
  }
}

template <int BN, typename Act>
cudaError_t launch_transition(const __nv_bfloat16* feats, long long P, int hw, int c_buf, int k_pad,
                              const float* at, const float* bt, const __nv_bfloat16* wt,
                              const float* bias, int n_pad, int c_out, void* out, int out_bf16,
                              int nhwc, cudaStream_t s) {
  const long long tiles = (P + db::kTM - 1) / db::kTM;
  if (tiles > (1ll << 31) - 1 || n_pad / BN > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), n_pad / BN);
  if (out_bf16)
    transition_wgmma_kernel<BN, __nv_bfloat16, Act><<<grid, db::kThreads, 0, s>>>(
        feats, P, hw, c_buf, k_pad, at, bt, wt, bias, c_out, static_cast<__nv_bfloat16*>(out), nhwc);
  else
    transition_wgmma_kernel<BN, float, Act><<<grid, db::kThreads, 0, s>>>(
        feats, P, hw, c_buf, k_pad, at, bt, wt, bias, c_out, static_cast<float*>(out), nhwc);
  return cudaGetLastError();
}

// The transition's N tile from n_pad: 8, 128 when it divides, else 64.
template <typename Act>
cudaError_t launch_transition_n(const __nv_bfloat16* feats, long long P, int hw, int c_buf,
                                int k_pad, const float* at, const float* bt,
                                const __nv_bfloat16* wt, const float* bias, int n_pad, int c_out,
                                void* out, int out_bf16, int nhwc, cudaStream_t s) {
  if (n_pad == 8)
    return launch_transition<8, Act>(feats, P, hw, c_buf, k_pad, at, bt, wt, bias, n_pad, c_out,
                                     out, out_bf16, nhwc, s);
  if (n_pad % 128 == 0)
    return launch_transition<128, Act>(feats, P, hw, c_buf, k_pad, at, bt, wt, bias, n_pad, c_out,
                                       out, out_bf16, nhwc, s);
  return launch_transition<64, Act>(feats, P, hw, c_buf, k_pad, at, bt, wt, bias, n_pad, c_out,
                                    out, out_bf16, nhwc, s);
}

}  // namespace

extern "C" {

// Entry pass: x (f32 if x_f32 else bf16), NCHW [batch, c_in, h, w] or, with
// nhwc, NHWC [batch, h, w, c_in] -> channels [0, c_in_pad) of feats
// [batch, h, w, c_buf] (bf16), zeros past c_in.
int mdie_db_entry(const void* x, int x_f32, int nhwc, int batch, int c_in, int h, int w,
                  int c_in_pad, void* feats, int c_buf, void* stream) {
  if (batch <= 0 || batch > 65535 || c_in <= 0 || h <= 0 || w <= 0 || c_in_pad < c_in ||
      c_in_pad % 8 || c_buf < c_in_pad || c_buf % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* y = static_cast<__nv_bfloat16*>(feats);
  if (!nhwc)
    return static_cast<int>(launch_nchw_to_nhwc(x, x_f32, batch, c_in, h * w, c_in_pad, c_buf, y, s));
  const long long P = (long long)batch * h * w;
  const long long blocks = (P * c_in_pad + 255) / 256;
  const int grid = static_cast<int>(blocks < 32ll * sm_count() ? blocks : 32ll * sm_count());
  if (x_f32)
    nhwc_to_slot_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), P, c_in,
                                                    c_in_pad, c_buf, y);
  else
    nhwc_to_slot_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), P, c_in, c_in_pad, c_buf, y);
  return static_cast<int>(cudaGetLastError());
}

// Growth layer: feats bf16 [batch, h, w, c_buf]; reads channels [0, ci),
// writes [ci, ci + g_pad).  a, b: f32 [k_pad]; wk: bf16 [9, g_pad, k_pad]
// (tap, output, channel); bias: f32 [g_pad]; k_pad = ci rounded up to 32,
// g_pad a multiple of 16.  bf16_act: the affine and ReLU in bf16.
int mdie_db_growth(void* feats, int batch, int h, int w, int c_buf, int ci, int k_pad,
                   const void* a, const void* b, const void* wk, const void* bias, int g_pad,
                   int bf16_act, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || ci <= 0 || ci % 8 || c_buf % 8 ||
      k_pad % db::kKC || k_pad < ci || k_pad - ci >= db::kKC || g_pad <= 0 || g_pad % db::kGN ||
      ci + g_pad > c_buf)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (w + db::kBW - 1) / db::kBW, tiles_h = (h + db::kBH - 1) / db::kBH;
  const int n_groups = g_pad / db::kGN;
  const long long blocks = (long long)tiles_w * tiles_h * n_groups;
  if (blocks > (1ll << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  auto* kernel = bf16_act ? growth_wgmma_kernel<Affine8Bf16> : growth_wgmma_kernel<Affine8>;
  kernel<<<grid, db::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(feats), c_buf, h, w, ci, k_pad, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(wk),
      static_cast<const float*>(bias), n_groups, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// Transition: feats bf16 [batch, h, w, c_buf]; at, bt: f32 [k_pad]; wt: bf16
// [n_pad, k_pad]; bias: f32 [n_pad]; k_pad = c_buf rounded up to 32; n_pad
// 8 or a multiple of 64.  out: [batch, c_out, h, w] (NHWC [batch, h, w,
// c_out] with nhwc), bf16 if out_bf16 else f32.  bf16_act: the affine and
// ReLU in bf16.
int mdie_db_transition(const void* feats, int batch, int h, int w, int c_buf, int k_pad,
                       const void* at, const void* bt, const void* wt, const void* bias, int n_pad,
                       int c_out, void* out, int out_bf16, int nhwc, int bf16_act, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c_buf <= 0 || c_buf % 8 || k_pad % db::kKC ||
      k_pad < c_buf || k_pad - c_buf >= db::kKC || c_out <= 0 || c_out > n_pad ||
      (n_pad != 8 && n_pad % 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = (long long)batch * h * w;
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* af = static_cast<const float*>(at);
  const auto* bf = static_cast<const float*>(bt);
  const auto* wf = static_cast<const __nv_bfloat16*>(wt);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16_act ? launch_transition_n<Affine8Bf16>(f, P, h * w, c_buf, k_pad, af, bf, wf, bi, n_pad,
                                                  c_out, out, out_bf16, nhwc, s)
               : launch_transition_n<Affine8>(f, P, h * w, c_buf, k_pad, af, bf, wf, bi, n_pad,
                                              c_out, out, out_bf16, nhwc, s);
  return static_cast<int>(err);
}

}  // extern "C"
